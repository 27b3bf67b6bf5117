"""The parameter lists of the DWC-GAN generator, discriminator and VGG16
trunk, by the reference model's `state_dict` names, and the seeded weights
the benchmark hands to both the program and the reference.

Each spec is (name, shape, init): init ("normal", std), ("uniform", lo,
hi) or ("zeros",).  The inits are the reference recipe's starting point:
kaiming-normal generator kernels, N(0, 0.02) discriminator kernels
(solver.py:74), uniform(+-1/sqrt(H)) LSTM weights and input bias with the
second LSTM bias at zero (the port trains one bias), N(0, 1) word
embeddings, LayerNorm gamma U(0, 1), zero biases, and LeCun-normal VGG16
kernels (the random-init fallback of the recipe).

`make_weights` draws every "normal" leaf of a list from one `torch.randn`
call and every "uniform" leaf from one `torch.rand` call, on the device,
from a `torch.Generator` seeded with the run's seed.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Spec = Tuple[str, tuple, tuple]

# VGG16's conv trunk to relu5_3: (name, out_channels, followed_by_pool)
VGG_LAYERS = (
    ("conv1_1", 64, False), ("conv1_2", 64, True),
    ("conv2_1", 128, False), ("conv2_2", 128, True),
    ("conv3_1", 256, False), ("conv3_2", 256, False), ("conv3_3", 256, True),
    ("conv4_1", 512, False), ("conv4_2", 512, False), ("conv4_3", 512, False),
    ("conv5_1", 512, False), ("conv5_2", 512, False), ("conv5_3", 512, False),
)


def _kaiming(fan_in: int) -> tuple:
    return ("normal", math.sqrt(2.0 / fan_in))


def _conv(prefix: str, cin: int, cout: int, k: int, init=None) -> List[Spec]:
    init = init or _kaiming(cin * k * k)
    return [(f"{prefix}.conv.weight", (cout, cin, k, k), init),
            (f"{prefix}.conv.bias", (cout,), ("zeros",))]


def _linear(prefix: str, cin: int, cout: int) -> List[Spec]:
    return [(f"{prefix}.weight", (cout, cin), _kaiming(cin)),
            (f"{prefix}.bias", (cout,), ("zeros",))]


def gen_specs(cfg: dict, vocab_size: int) -> List[Spec]:
    """The generator's parameters in the port's `named_parameters` order."""
    g = cfg["gen"]
    dim, c_dim, num_cls = g["dim"], g["c_dim"], g["num_cls"]
    style_dim = c_dim * num_cls
    specs: List[Spec] = []
    # style encoder: 7x7 stem, two doubling downsamples, the rest at width
    specs += _conv("enc_style.model.0", cfg["input_dim"], dim, 7)
    d, i = dim, 1
    for _ in range(2):
        specs += _conv(f"enc_style.model.{i}", d, 2 * d, 4)
        d, i = 2 * d, i + 1
    for _ in range(g["style_downsample"] - 2):
        specs += _conv(f"enc_style.model.{i}", d, d, 4)
        i += 1
    if g["use_map"]:
        specs += _linear("enc_style.mapping.0", d, d)
        specs += _linear("enc_style.mapping.3", d, d)
    for head in ("fcs", "fcvars"):
        for k in range(num_cls):
            specs += _linear(f"enc_style.{head}.{k}", d, c_dim)
    # content encoder: stem, capped downsamples, IN resblocks
    specs += _conv("enc_content.model.0", cfg["input_dim"], dim, 7)
    d = dim
    for j in range(g["content_downsample"]):
        nd = min(2 * d, 256)
        specs += _conv(f"enc_content.model.{1 + j}", d, nd, 4)
        d = nd
    res = 1 + g["content_downsample"]
    for b in range(g["n_res"]):
        for c in range(2):
            specs += _conv(f"enc_content.model.{res}.model.{b}.model.{c}", d, d, 3)
    content_dim = d
    # decoder: AdaIN resblocks, upsample + 5x5 LN convs, the two heads
    for b in range(g["n_res"]):
        for c in range(2):
            specs += _conv(f"dec.model.0.model.{b}.model.{c}", d, d, 3)
    for j in range(g["content_downsample"]):
        prefix = f"dec.model.{2 + 2 * j}"
        specs += _conv(prefix, d, d // 2, 5)
        specs += [(f"{prefix}.norm.gamma", (d // 2,), ("uniform", 0.0, 1.0)),
                  (f"{prefix}.norm.beta", (d // 2,), ("zeros",))]
        d //= 2
    specs += _conv("dec.image_content", d, cfg["input_dim"], 7)
    if g["use_attention"]:
        specs += _conv("dec.image_attention", d, 1, 7)
    # text encoder: embeddings, bi-LSTM, per-attribute heads
    emb, hid, layers = g["embed_dim"], g["hidden_size"], g["num_layers"]
    specs.append(("enc_txt.embed_tokens.weight", (vocab_size, emb), ("normal", 1.0)))
    bound = 1.0 / math.sqrt(hid)
    lstm_u = ("uniform", -bound, bound)
    for layer in range(layers):
        cin = emb + style_dim if layer == 0 else 2 * hid
        for sfx in ("", "_reverse"):
            specs += [(f"enc_txt.lstm.weight_ih_l{layer}{sfx}", (4 * hid, cin), lstm_u),
                      (f"enc_txt.lstm.weight_hh_l{layer}{sfx}", (4 * hid, hid), lstm_u),
                      (f"enc_txt.lstm.bias_ih_l{layer}{sfx}", (4 * hid,), lstm_u),
                      (f"enc_txt.lstm.bias_hh_l{layer}{sfx}", (4 * hid,), ("zeros",))]
    feat = layers * 4 * hid
    for head in ("fcs", "fcvars"):
        for k in range(num_cls):
            specs += _linear(f"enc_txt.{head}.{k}", feat, c_dim)
    # style -> AdaIN parameters
    n_adain = g["n_res"] * 2 * 2 * content_dim
    mlp = g["mlp_dim"]
    specs += _linear("mlp.model.0.fc", style_dim, mlp)
    specs += _linear("mlp.model.1.fc", mlp, mlp)
    specs += _linear("mlp.model.2.fc", mlp, n_adain)
    return specs


def dis_specs(cfg: dict) -> List[Spec]:
    """The multi-scale discriminator's parameters in `named_parameters`
    order (norms none, in and sn hold no parameter of their own)."""
    d_cfg = cfg["dis"]
    if d_cfg["norm"] not in ("none", "in", "sn"):
        raise ValueError(f"dis.norm {d_cfg['norm']!r} is not in the reference")
    gauss = ("normal", 0.02)
    feats, srcs, clss = [], [], []
    for s in range(d_cfg["num_scales"]):
        d = d_cfg["dim"]
        feats += _conv(f"cnns_feat.{s}.0", 3, d, 4, gauss)
        for j in range(1, d_cfg["n_layer"]):
            nd = min(2 * d, 512)
            feats += _conv(f"cnns_feat.{s}.{j}", d, nd, 4, gauss)
            d = nd
        srcs += [(f"cnns_src.{s}.weight", (1, d, 1, 1), gauss),
                 (f"cnns_src.{s}.bias", (1,), ("zeros",))]
        k = (d_cfg["image_size"] // 2 ** s) // 2 ** d_cfg["n_layer"]
        clss.append((f"cnns_cls.{s}.weight", (d_cfg["num_cls"], d, k, k), gauss))
    return feats + srcs + clss


def vgg_specs() -> List[Spec]:
    specs, c = [], 3
    for name, ch, _ in VGG_LAYERS:
        specs += [(f"{name}.weight", (ch, c, 3, 3), ("normal", math.sqrt(1.0 / (c * 9)))),
                  (f"{name}.bias", (ch,), ("zeros",))]
        c = ch
    return specs


def make_weights(specs: List[Spec], generator: torch.Generator,
                 device) -> Dict[str, torch.Tensor]:
    """{name: fp32 tensor} on `device`: one randn call for every normal
    leaf, one rand call for every uniform leaf, in the order of `specs`."""
    numel = lambda shape: math.prod(shape)
    n_norm = sum(numel(s) for _, s, init in specs if init[0] == "normal")
    n_unif = sum(numel(s) for _, s, init in specs if init[0] == "uniform")
    normal = torch.randn(n_norm, generator=generator, device=device)
    unif = torch.rand(n_unif, generator=generator, device=device)
    out, on, ou = {}, 0, 0
    for name, shape, init in specs:
        n = numel(shape)
        if init[0] == "normal":
            out[name] = normal[on:on + n].view(shape) * init[1]
            on += n
        elif init[0] == "uniform":
            lo, hi = init[1], init[2]
            out[name] = unif[ou:ou + n].view(shape) * (hi - lo) + lo
            ou += n
        elif init[0] == "zeros":
            out[name] = torch.zeros(shape, device=device)
        else:
            raise ValueError(f"unknown init {init!r} of {name}")
    return out


def frozen_names(specs: List[Spec]) -> Tuple[str, ...]:
    """Leaves no optimizer updates: the LSTM's second bias."""
    return tuple(name for name, _, _ in specs if ".bias_hh_" in name)


def vgg_npz(cache, seed: int, device) -> str:
    """The VGG16 weights as the `.npz` the port's training reads
    (`{name}_kernel` HWIO, `{name}_bias`), made once from `seed` into
    `cache` (written beside and renamed into place); returns its path."""
    import os
    import numpy as np

    path = os.path.join(str(cache), f"vgg16_{seed}.npz")
    if os.path.exists(path):
        return path
    os.makedirs(str(cache), exist_ok=True)
    w = make_weights(vgg_specs(), torch.Generator(device=device).manual_seed(seed), device)
    arrays = {}
    for name, _, _ in VGG_LAYERS:
        arrays[f"{name}_kernel"] = w[f"{name}.weight"].permute(2, 3, 1, 0).cpu().numpy()
        arrays[f"{name}_bias"] = w[f"{name}.bias"].cpu().numpy()
    tmp = f"{path}.partial{os.getpid()}.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    return path


def load_vgg_npz(path: str, device) -> Dict[str, torch.Tensor]:
    """{name: OIHW / bias tensor} of the `.npz` of `vgg_npz`."""
    import numpy as np

    out = {}
    with np.load(path) as z:
        for name, _, _ in VGG_LAYERS:
            out[f"{name}.weight"] = torch.from_numpy(
                np.ascontiguousarray(z[f"{name}_kernel"].transpose(3, 2, 0, 1))).to(device)
            out[f"{name}.bias"] = torch.from_numpy(z[f"{name}_bias"]).to(device)
    return out
