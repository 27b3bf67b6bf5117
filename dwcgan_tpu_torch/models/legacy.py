"""The legacy (v1) model family (the counterpart of
`dwcgan_tpu/models/legacy.py`; reference networks.py:177-425).

A single-style-head AdaIN generator (`AdaINGenV1`) with its style and text
encoders (`StyleEncoderV1`, `TxtEncoderV1`), the uncapped content encoder
(`ContentEncoderOld`) and the reduced VAE generator (`VAEGen`), built from
the port's blocks, `Decoder` and `TxtEncoder`, so on the card they run the
same norm kernels as the v2 generator (the content encoders' instance
norms, the decoders' AdaIN and LayerNorm).  No legacy module runs the fused
stem: the JAX modules never set `stem_pallas`.

As in `models/generator.py`, activations inside are NCHW in channels_last
memory, and the public methods take and return NHWC.  Each module keeps
the sizes that `interop/jax_params.py::load_jax_legacy_params` needs as
`dims`.  Dropout (the style mapping's, the text encoder's) draws its masks
from the `rng` generator it is given, in train mode.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from dwcgan_tpu_torch.device import resolve_device
from dwcgan_tpu_torch.models.generator import (ContentEncoder, Decoder,
                                               Generator, TxtEncoder,
                                               init_weights)
from dwcgan_tpu_torch.ops.blocks import (MLP, Conv2dBlock, ResBlocks,
                                         channels_last, dropout, linear)
from dwcgan_tpu_torch.ops.lstm import MaskedBiLSTM


def _nchw(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return channels_last(x.permute(0, 3, 1, 2).to(dtype))


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class _Legacy(nn.Module):

    set_norm_stats = Generator.set_norm_stats
    set_norm_compute = Generator.set_norm_compute


class StyleEncoderV1(_Legacy):
    """Conv stack + spatial mean + mapping + one Gaussian head
    (reference StyleEncoder v1, networks.py:371-406) -> (mu, logvar), each
    [N, style_dim].  The mapping is ReLU whatever `activ` says, with
    dropout 0.1 between its layers; the mean accumulates in fp32 and
    rounds once, as `jnp.mean` does."""

    rate = 0.1

    def __init__(self, input_dim: int = 3, dim: int = 64, n_downsample: int = 5,
                 style_dim: int = 8, activ: str = "relu",
                 pad_type: str = "reflect", use_map: bool = True):
        super().__init__()
        self.dims = dict(n_downsample=n_downsample, use_map=use_map)
        kw = dict(norm="none", activ=activ, pad_type=pad_type)
        layers = [Conv2dBlock(input_dim, dim, 7, 1, 3, **kw)]
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
        self.fc = nn.Linear(d, style_dim)
        self.fcVar = nn.Linear(d, style_dim)

    def forward(self, x, rng=None):
        """x: NCHW in the compute dtype, which the module computes in."""
        for m in self.model:
            x = m(x)
        feats = x.float().mean(dim=(2, 3)).to(x.dtype)
        if self.use_map:
            m0, m3 = self.mapping[0], self.mapping[3]
            feats = F.relu(linear(feats, m0.weight, m0.bias))
            feats = dropout(feats, self.rate, self.training, rng)
            feats = F.relu(linear(feats, m3.weight, m3.bias))
        return (linear(feats, self.fc.weight, self.fc.bias),
                linear(feats, self.fcVar.weight, self.fcVar.bias))


class TxtEncoderV1(_Legacy):
    """The single-head text encoder (networks.py:291-368): the v2
    `TxtEncoder` with num_cls 1 and c_dim style_dim, as `inner`
    -> (mu, logvar), each [N, style_dim]."""

    def __init__(self, vocab_size: int, style_dim: int = 8, embed_dim: int = 300,
                 hidden_size: int = 300, num_layers: int = 2,
                 dropout_in: float = 0.1, dropout_out: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dims = dict(style_dim=style_dim, num_layers=num_layers,
                         hidden_size=hidden_size)
        self.inner = TxtEncoder(vocab_size, embed_dim, hidden_size, style_dim, 1,
                                num_layers, dropout_in, dropout_out, dtype)

    def forward(self, style, tokens, lengths, rng=None):
        mu, logvar = self.inner(style, tokens, lengths, rng)
        return mu[:, 0], logvar[:, 0]


class ContentEncoderOld(_Legacy):
    """The uncapped content encoder (networks.py:409-425): the width
    doubles at every downsample.  NCHW in and out."""

    def __init__(self, input_dim: int = 3, dim: int = 64, n_downsample: int = 2,
                 n_res: int = 4, activ: str = "relu", pad_type: str = "reflect"):
        super().__init__()
        self.dims = dict(n_downsample=n_downsample, n_res=n_res)
        layers = [Conv2dBlock(input_dim, dim, 7, 1, 3, "in", activ, pad_type)]
        d = dim
        for _ in range(n_downsample):
            layers.append(Conv2dBlock(d, 2 * d, 4, 2, 1, "in", activ, pad_type))
            d *= 2
        layers.append(ResBlocks(n_res, d, "in", activ, pad_type))
        self.model = nn.ModuleList(layers)
        self.output_dim = d

    def forward(self, x):
        for m in self.model:
            x = m(x)
        return x


class AdaINGenV1(_Legacy):
    """The v1 AdaIN generator (networks.py:177-253): one global style
    vector [N, style_dim], the uncapped content encoder.

      encode(x)                  -> (content, mu, logvar)
      encode_txt(style, txt, ln) -> (mu, logvar)
      decode(content, style)     -> (image, attention)
    Images and content codes are NHWC."""

    def __init__(self, input_dim: int = 3, vocab_size: int = 102, dim: int = 64,
                 style_dim: int = 8, n_downsample: int = 2, n_res: int = 4,
                 activ: str = "relu", pad_type: str = "reflect",
                 mlp_dim: int = 256, use_attention: bool = True,
                 use_map: bool = True, embed_dim: int = 300,
                 hidden_size: int = 300, num_layers: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.dims = dict(n_downsample=n_downsample, n_res=n_res, use_map=use_map,
                         use_attention=use_attention, style_dim=style_dim,
                         num_layers=num_layers, hidden_size=hidden_size)
        self.enc_style = StyleEncoderV1(input_dim, dim, 5, style_dim, activ,
                                        pad_type, use_map)
        self.enc_content = ContentEncoderOld(input_dim, dim, n_downsample, n_res,
                                             activ, pad_type)
        self.dec = Decoder(self.enc_content.output_dim, input_dim, n_downsample,
                           n_res, activ, pad_type, use_attention)
        self.enc_txt = TxtEncoderV1(vocab_size, style_dim, embed_dim, hidden_size,
                                    num_layers, dtype=dtype)
        self.mlp = MLP(style_dim, self.dec.num_adain_params, mlp_dim, 3, "none",
                       activ)

    def encode(self, images, rng=None):
        x = _nchw(images, self.dtype)
        mu, logvar = self.enc_style(x, rng)
        return _nhwc(self.enc_content(x)), mu, logvar

    def encode_txt(self, style, tokens, lengths, rng=None):
        return self.enc_txt(style, tokens, lengths, rng)

    def decode(self, content, style):
        image, att = self.dec(_nchw(content, self.dtype),
                              self.mlp(style.to(self.dtype)))
        return _nhwc(image), None if att is None else _nhwc(att)


class VAEGen(_Legacy):
    """The reduced VAE generator (networks.py:255-286): the v2 content
    encoder, and the AdaIN decoder without attention driven by a constant
    style (bias 0, scale 1).  The hiddens are the Gaussian means; the
    stochastic forward adds unit noise."""

    def __init__(self, input_dim: int = 3, dim: int = 64, n_downsample: int = 2,
                 n_res: int = 4, activ: str = "relu", pad_type: str = "reflect",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.dims = dict(n_downsample=n_downsample, n_res=n_res)
        self.enc = ContentEncoder(input_dim, dim, n_downsample, n_res, activ,
                                  pad_type)
        self.dec = Decoder(self.enc.output_dim, input_dim, n_downsample, n_res,
                           activ, pad_type, use_attention=False)

    def encode(self, images):
        return _nhwc(self.enc(_nchw(images, self.dtype)))

    def decode(self, hiddens):
        """hiddens NHWC -> image NHWC.  The style is [N, n_res, 2, 2(bias,
        scale), dim] with every scale slot 1 (legacy.py:191-196)."""
        n = hiddens.shape[0]
        p = torch.zeros((n, self.dec.n_res, 2, 2, self.dec.dim), dtype=self.dtype,
                        device=hiddens.device)
        p[:, :, :, 1, :] = 1.0
        image, _ = self.dec(_nchw(hiddens, self.dtype), p.reshape(n, -1))
        return _nhwc(image)

    def forward(self, images, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None):
        """-> (reconstruction, hiddens), NHWC.  Unless `deterministic`, unit
        noise of the hiddens' dtype is added to them: `noise` when given
        (tests inject JAX's draw), else drawn from `generator`."""
        hiddens = self.encode(images)
        if not deterministic:
            if noise is None:
                noise = torch.randn(hiddens.shape, generator=generator,
                                    device=hiddens.device).to(hiddens.dtype)
            hiddens = hiddens + noise.to(hiddens.dtype)
        return self.decode(hiddens), hiddens


LEGACY_GENERATORS = {"AdaINGenV1": AdaINGenV1, "VAEGen": VAEGen}


def build_legacy_generator(kind: str, device="cuda", seed: int = 0,
                           dtype: torch.dtype = torch.float32,
                           stats: str = "2pass", init_type: str = "kaiming",
                           arith: str = "fp32", **kwargs) -> _Legacy:
    """A legacy generator (`kind` "AdaINGenV1" or "VAEGen", sizes as
    keyword arguments) in eval mode with random weights from `seed`
    (`models/generator.py::init_weights`), computing in `dtype` with the
    norms' variance form `stats` and normalise arithmetic `arith`
    (`norm_compute`), on `device`: the card unless the caller asks for the
    CPU.  The LSTM's `bias_hh` is frozen at zero, as the v2 generator's is."""
    dev = resolve_device(device)
    if kind not in LEGACY_GENERATORS:
        raise ValueError(f"unknown legacy generator {kind!r} "
                         f"({sorted(LEGACY_GENERATORS)})")
    model = LEGACY_GENERATORS[kind](dtype=dtype, **kwargs)
    model.set_norm_stats(stats)
    model.set_norm_compute(arith)
    init_weights(model, init_type, seed)
    for m in model.modules():
        if isinstance(m, MaskedBiLSTM):
            for name, p in m.named_parameters():
                if name.startswith("bias_hh"):
                    p.requires_grad_(False)
    return model.to(dev).eval()
