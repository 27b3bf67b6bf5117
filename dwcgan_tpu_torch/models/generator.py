"""The DWC-GAN generator in PyTorch (counterpart of
`dwcgan_tpu/models/generator.py`).

Inside, activations are NCHW tensors in channels_last memory (NHWC bytes),
so cuDNN's convolutions stay on their NHWC path and the norm kernels read
channel-contiguous rows.  The public methods `encode`, `encode_txt` and
`decode` take and return NHWC, like the JAX `Generator`.  Styles are
[N, num_cls, c_dim]; `decode` and `encode_txt` take the flattened
attribute-major [N, num_cls * c_dim] form.

Parameters are fp32 and named as in the reference torch model
(`enc_content.model.{i}.conv`, `dec.model.0.model.{b}.model.{0,1}.conv`,
`enc_txt.lstm.weight_ih_l0`, `enc_style.fcs.{i}`, ...), so
`dwcgan_tpu/interop/torch_import.py` reads a port `state_dict()` directly.
Everything computes in the compute dtype, the text encoder (embedding
output, bi-LSTM, heads) too, as in the JAX model.

In train mode the style encoder's mapping dropout and the text encoder's
input and inter-layer dropouts draw their masks from the `rng` generator
that `encode` and `encode_txt` are given.  `set_dropout(False)` turns all
three off while the modules stay in train mode.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dwcgan_tpu_torch.config import Config, GenConfig
from dwcgan_tpu_torch.device import resolve_device
from dwcgan_tpu_torch.ops.blocks import (AdaINResBlocks, Conv2dBlock, MLP,
                                         ResBlocks, channels_last, conv2d,
                                         dropout, fixed_init_params, linear,
                                         pad2d, set_norm_modes, sigmoid,
                                         weights_init)
from dwcgan_tpu_torch.ops.lstm import MaskedBiLSTM
from dwcgan_tpu_torch.ops.resize import upsample2x
from dwcgan_tpu_torch.parallel.tensor import module_group, reduce, split
from dwcgan_tpu_torch.utils.profiling import span


def build_embedding_matrix(vocab, embed_dim: int, pretrained=None,
                           seed: int = 0) -> np.ndarray:
    """The word-embedding table [vocab.size, embed_dim] float32, as
    `dwcgan_tpu/models/generator.py::build_embedding_matrix`
    (networks_v2.py:186-194): the pretrained vector where the dict
    `pretrained` has the word, N(0, 0.6) rows for the others; with no dict
    at all, N(0, 1) rows throughout."""
    rng = np.random.default_rng(seed)
    if pretrained is None:
        return rng.normal(0.0, 1.0, (vocab.size, embed_dim)).astype(np.float32)
    table = np.zeros((vocab.size, embed_dim), dtype=np.float32)
    for i, word in enumerate(vocab.itos):
        vec = pretrained.get(word)
        if vec is not None:
            table[i] = np.asarray(vec, dtype=np.float32)
        else:
            table[i] = rng.normal(scale=0.6, size=(embed_dim,))
    return table


def _fused_linear(x, linears):
    """The per-attribute Linear heads on one input, as one `linear` (one
    flax `Dense` of num_cls * c_dim outputs in the JAX model).  Under a
    model axis the weights hold this rank's slice of the input features:
    the product of that slice of `x`, all-reduced, then the bias."""
    w = torch.cat([m.weight for m in linears])
    b = torch.cat([m.bias for m in linears])
    mg = module_group(linears[0])
    if mg is None:
        return linear(x, w, b)
    y = reduce(linear(split(x, -1, mg), w), mg)
    return y + b.to(y.dtype)


class ContentEncoder(nn.Module):
    """7x7 stem + capped stride-2 downsamples + IN resblocks
    (reference `ContentEncoder`, networks.py:428-446; dim cap 256)."""

    def __init__(self, input_dim: int, dim: int, n_downsample: int,
                 n_res: int, activ: str, pad_type: str, stem: bool = False):
        super().__init__()
        layers = [Conv2dBlock(input_dim, dim, 7, 1, 3, "in", activ, pad_type,
                              stem=stem)]
        d = dim
        for _ in range(n_downsample):
            nd = min(d * 2, 256)
            layers.append(Conv2dBlock(d, nd, 4, 2, 1, "in", activ, pad_type))
            d = nd
        layers.append(ResBlocks(n_res, d, "in", activ, pad_type))
        self.model = nn.ModuleList(layers)
        self.output_dim = d

    def forward(self, x):
        for m in self.model:
            x = m(x)
        return x


class StyleEncoder(nn.Module):
    """Conv stack + GAP + mapping MLP + per-attribute Gaussian heads
    (reference StyleEncoder v2, networks_v2.py:98-141).  -> (mu, logvar),
    each [N, num_cls, c_dim]."""

    rate = 0.1   # the mapping MLP's dropout

    def __init__(self, input_dim: int, dim: int, n_downsample: int,
                 c_dim: int, num_cls: int, activ: str, pad_type: str,
                 use_map: bool, stem: bool = False):
        super().__init__()
        kw = dict(norm="none", activ=activ, pad_type=pad_type)
        layers = [Conv2dBlock(input_dim, dim, 7, 1, 3, **kw, stem=stem)]
        d = dim
        for _ in range(2):
            layers.append(Conv2dBlock(d, 2 * d, 4, 2, 1, **kw))
            d *= 2
        for _ in range(n_downsample - 2):
            layers.append(Conv2dBlock(d, d, 4, 2, 1, **kw))
        self.model = nn.ModuleList(layers)
        self.use_map = use_map
        if use_map:
            self.mapping = nn.Sequential(nn.Linear(d, d), nn.ReLU(),
                                         nn.Dropout(self.rate), nn.Linear(d, d),
                                         nn.ReLU())
        self.fcs = nn.ModuleList([nn.Linear(d, c_dim) for _ in range(num_cls)])
        self.fcvars = nn.ModuleList([nn.Linear(d, c_dim)
                                     for _ in range(num_cls)])
        self.shape = (num_cls, c_dim)
        self.p_map = self.rate

    def forward(self, x, rng=None, rows=None):
        for m in self.model:
            x = m(x)
        feats = x.mean(dim=(2, 3))   # global average pool -> [N, d]
        if self.use_map:
            m0, m3 = self.mapping[0], self.mapping[3]
            feats = F.relu(linear(feats, m0.weight, m0.bias))
            feats = dropout(feats, self.p_map, self.training, rng, rows)
            feats = F.relu(linear(feats, m3.weight, m3.bias))
        shape = (x.shape[0],) + self.shape
        return (_fused_linear(feats, self.fcs).reshape(shape),
                _fused_linear(feats, self.fcvars).reshape(shape))


class TxtEncoder(nn.Module):
    """(current style, command tokens) -> target style distribution
    (reference TxtEncoder v2, networks_v2.py:171-254).

    Per timestep the input is the word embedding ++ the current style; a
    bi-LSTM; the heads read every layer's and direction's final (h, c).
    The head input is built per sample in the reference's block order
    [h_l0(f, b), c_l0(f, b), h_l1(f, b), c_l1(f, b), ...]; the reference's
    batch-interleaving reshape (networks_v2.py:249, harmless at its batch of
    1) is not copied.  The JAX model orders the same blocks [h all, c all]
    and permutes the head rows when it imports reference weights.
    """

    def __init__(self, vocab_size: int, embed_dim: int, hidden_size: int,
                 c_dim: int, num_cls: int, num_layers: int,
                 dropout_in: float, dropout_out: float,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.embed_tokens = nn.Embedding(vocab_size, embed_dim)
        self.lstm = MaskedBiLSTM(embed_dim + num_cls * c_dim, hidden_size,
                                 num_layers, dropout_out)
        feat = num_layers * 4 * hidden_size
        self.fcs = nn.ModuleList([nn.Linear(feat, c_dim)
                                  for _ in range(num_cls)])
        self.fcvars = nn.ModuleList([nn.Linear(feat, c_dim)
                                     for _ in range(num_cls)])
        self.dropout_in = dropout_in
        self.rates = (dropout_in, dropout_out)
        self.shape = (num_cls, c_dim)

    def forward(self, style_flat, tokens, lengths, rng=None, rows=None):
        """style_flat: [N, num_cls*c_dim]; tokens: [N, T] int; lengths: [N]
        (best on the host).  Computes in `self.dtype`."""
        x = dropout(self.embed_tokens(tokens.long()).to(self.dtype),
                    self.dropout_in, self.training, rng, rows)
        style_b = style_flat.to(self.dtype)[:, None, :].expand(-1, x.shape[1], -1)
        _, h, c = self.lstm(torch.cat([x, style_b], dim=-1), lengths, rng, rows)
        feats = torch.cat([torch.cat([h[l, 0], h[l, 1], c[l, 0], c[l, 1]], -1)
                           for l in range(h.shape[0])], dim=-1)
        shape = (feats.shape[0],) + self.shape
        return (_fused_linear(feats, self.fcs).reshape(shape),
                _fused_linear(feats, self.fcvars).reshape(shape))


class Upsample2x(nn.Module):
    """Bilinear 2x; a module so the decoder's indices match the reference."""

    def forward(self, x):
        return upsample2x(x)


class Decoder(nn.Module):
    """AdaIN resblocks -> bilinear-upsample conv stages -> image + attention
    heads (reference Decoder, networks_v2.py:144-169).  With attention on,
    the 3-channel image head and the 1-channel attention head run as one
    4-channel conv, split into tanh and sigmoid (generator.py:281-303)."""

    def __init__(self, dim: int, out_dim: int, n_upsample: int, n_res: int,
                 activ: str, pad_type: str, use_attention: bool):
        super().__init__()
        layers = [AdaINResBlocks(n_res, dim, activ, pad_type)]
        d = dim
        for _ in range(n_upsample):
            layers += [Upsample2x(),
                       Conv2dBlock(d, d // 2, 5, 1, 2, "ln", activ, pad_type)]
            d //= 2
        self.model = nn.ModuleList(layers)
        self.image_content = Conv2dBlock(d, out_dim, 7, 1, 3, "none", "tanh",
                                         pad_type)
        self.use_attention = use_attention
        if use_attention:
            self.image_attention = Conv2dBlock(d, 1, 7, 1, 3, "none",
                                               "sigmoid", pad_type)
        self.dim, self.n_res, self.out_dim = dim, n_res, out_dim
        self.pad_type = pad_type

    @property
    def num_adain_params(self) -> int:
        return self.n_res * 2 * 2 * self.dim

    def forward(self, content, adain_params):
        sp = adain_params.reshape(content.shape[0], self.n_res, 2, 2, self.dim)
        x = self.model[0](content, sp)
        for m in self.model[1:]:
            x = m(x)
        if not self.use_attention:
            return self.image_content(x), None
        heads = (self.image_content.conv, self.image_attention.conv)
        out = conv2d(channels_last(pad2d(x, 3, self.pad_type)),
                     torch.cat([h.weight for h in heads]),
                     torch.cat([h.bias for h in heads]))
        return (torch.tanh(out[:, :self.out_dim]),
                sigmoid(out[:, self.out_dim:]))


class Generator(nn.Module):
    """Content/style autoencoder + text style transfer (AdaINGen_v2).

      encode(x)                    -> (content, style_mu, style_logvar)
      encode_txt(style, txt, lens) -> (mu, logvar)
      decode(content, style_flat)  -> (image, attention)
    Images and content codes are NHWC.
    """

    def __init__(self, cfg: GenConfig, input_dim: int = 3,
                 vocab_size: int = 102, dtype: torch.dtype = torch.float32,
                 stats: str = "2pass", stem: bool = False):
        super().__init__()
        c = cfg
        self.cfg, self.dtype = cfg, dtype
        self.enc_style = StyleEncoder(input_dim, c.dim, c.style_downsample,
                                      c.c_dim, c.num_cls, c.activ, c.pad_type,
                                      c.use_map, stem)
        self.enc_content = ContentEncoder(input_dim, c.dim,
                                          c.content_downsample, c.n_res,
                                          c.activ, c.pad_type, stem)
        self.dec = Decoder(self.enc_content.output_dim, input_dim,
                           c.content_downsample, c.n_res, c.activ,
                           c.pad_type, c.use_attention)
        self.enc_txt = TxtEncoder(vocab_size, c.embed_dim, c.hidden_size,
                                  c.c_dim, c.num_cls, c.num_layers,
                                  c.dropout_in, c.dropout_out, dtype)
        self.mlp = MLP(c.style_dim, self.dec.num_adain_params, c.mlp_dim,
                       n_blk=3, norm="none", activ=c.activ)
        self.set_norm_stats(stats)

    def set_dropout(self, on: bool) -> None:
        """Dropout on (the config's rates) or off, whatever the mode."""
        self.enc_style.p_map = self.enc_style.rate if on else 0.0
        p_in, p_out = self.enc_txt.rates
        self.enc_txt.dropout_in = p_in if on else 0.0
        if self.enc_txt.lstm.num_layers > 1:
            self.enc_txt.lstm.dropout = p_out if on else 0.0

    def set_norm_stats(self, stats: str) -> None:
        """How every norm forms its variance ("2pass" or "1pass")."""
        set_norm_modes(self, stats=stats)

    def set_norm_compute(self, arith: str) -> None:
        """In which dtype every instance norm and AdaIN normalises ("fp32"
        or "bf16", `cfg.norm_compute`; `ops/norms.py`)."""
        set_norm_modes(self, arith=arith)

    def _nchw(self, x):
        """NHWC in -> NCHW in channels_last memory, compute dtype."""
        return channels_last(x.permute(0, 3, 1, 2).to(self.dtype))

    def encode(self, images, rng=None, rows=None):
        with span("gen.encode"):
            x = self._nchw(images)
            mu, logvar = self.enc_style(x, rng, rows)
            content = self.enc_content(x)
            return content.permute(0, 2, 3, 1), mu, logvar

    def encode_txt(self, style_flat, tokens, lengths, rng=None, rows=None):
        route = self.enc_txt.lstm.kernel_route(style_flat.device)
        with span("gen.encode_txt", lstm_kernel=int(route)):
            return self.enc_txt(style_flat, tokens, lengths, rng, rows)

    def decode(self, content, style_flat):
        with span("gen.decode"):
            adain_params = self.mlp(style_flat.to(self.dtype))
            image, att = self.dec(self._nchw(content), adain_params)
            return (image.permute(0, 2, 3, 1),
                    None if att is None else att.permute(0, 2, 3, 1))


@torch.no_grad()
def init_weights(gen: nn.Module, init_type: str, seed: int) -> None:
    """Random weights from `seed`: conv/linear kernels by `init_type` with
    zero biases, LSTM uniform(+-1/sqrt(H)) (one bias, the other zero),
    N(0, 1) embedding, LayerNorm gamma U(0, 1) and beta 0, PReLU slopes
    0.25 (`fixed_init_params`)."""
    g = torch.Generator().manual_seed(seed)
    fixed = fixed_init_params(gen)
    for name, p in gen.named_parameters():
        if name in fixed:
            p.fill_(fixed[name])
        elif ".lstm." in name:
            if ".bias_hh" in name:
                p.zero_()
            else:
                bound = 1.0 / math.sqrt(p.shape[0] // 4)   # [4H, ...]
                nn.init.uniform_(p, -bound, bound, generator=g)
        elif name.endswith("embed_tokens.weight"):
            nn.init.normal_(p, 0.0, 1.0, generator=g)
        elif name.endswith(".gamma"):
            nn.init.uniform_(p, 0.0, 1.0, generator=g)
        elif name.endswith(".weight"):
            weights_init(p, init_type, g)
        else:
            p.zero_()


def freeze_lstm_bias_hh(gen: Generator) -> None:
    """The JAX LSTM has one bias per direction; the port's `nn.LSTM` has
    `bias_ih` (= that bias) and `bias_hh`.  `bias_hh` stays zero and out of
    every optimizer, or the effective bias would take each step twice."""
    for name, p in gen.enc_txt.lstm.named_parameters():
        if name.startswith("bias_hh"):
            with torch.no_grad():
                p.zero_()
            p.requires_grad_(False)


def build_generator(cfg: Config, vocab_size: int, device="cuda",
                    seed: int = 0, train: bool = False,
                    embed_table: Optional[np.ndarray] = None) -> Generator:
    """The generator of `cfg` with random weights from `seed` on `device`
    (the card unless the caller asks for the CPU), in eval mode for serving
    or, with `train`, in train mode (dropout on).

    Compute dtype from `cfg.compute_dtype`, variance form from
    `cfg.norm_stats`, normalise arithmetic `cfg.norm_compute` (the fused
    stem ignores it, as JAX's does).  `cfg.stem_pallas` runs both encoders' 7x7 stems as
    the fused stem (`ops/stem.py`; its own kernels on the card).
    `embed_table` ([vocab, embed_dim]) replaces the random word embeddings
    (the trainer then keeps it frozen).  The LSTM's `bias_hh` is frozen at
    zero.  `use_pallas` and `parity_convs` pick TPU code paths and change
    nothing here: on the card the norm kernels always run, and
    `parity_convs` is an XLA rewrite of the same convolution."""
    dev = resolve_device(device)
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    with span("setup.build_generator"):
        gen = Generator(cfg.gen, cfg.input_dim, vocab_size, dtype=dtype,
                        stats=cfg.norm_stats, stem=bool(cfg.stem_pallas))
        gen.set_norm_compute(cfg.norm_compute)
        init_weights(gen, cfg.init, seed)
        if embed_table is not None:
            with torch.no_grad():
                gen.enc_txt.embed_tokens.weight.copy_(torch.from_numpy(
                    np.array(embed_table, np.float32)))
        freeze_lstm_bias_hh(gen)
        return gen.to(dev).train(train)
