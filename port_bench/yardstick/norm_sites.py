"""The norm call sites of a served batch and of a training step, from the
configuration's sizes, and the least time of each (a frozen copy of
`chip_smoke.py`'s `SITES`, `BWD_SITES`, `site_bound` and `bwd_bound`).

A forward site reads its activations once (the input; AdaIN's residual
form its two inputs) and its per-sample or per-channel parameters in fp32,
and writes its output once; a backward site reads x and the incoming
gradient and writes dx.  The least time is the larger of those bytes over
the HBM rate and the site's fp32 operations over the fp32 rate.  The four
kernels of the port that run them, and which sites each runs:
`norm_fwd_cluster_kernel` (instance norm, AdaIN, AdaIN + residual),
`ln_fwd_cluster_kernel` (the reference LayerNorm), `norm_bwd_cluster_kernel`
and `ln_bwd_cluster_kernel` their backwards, one launch per call.
"""

from __future__ import annotations

from collections import Counter
from typing import List, NamedTuple

from port_bench.yardstick.peaks import FP32_FLOPS, HBM_BYTES_PER_S

OPS_PER_ELEM = {"instance_norm": 6, "adain": 8, "adain_residual": 9,
                "layer_norm_ref": 8}
BWD_OPS_PER_ELEM = 11
KERNEL_OF = {"instance_norm": "norm_fwd_cluster_kernel",
             "adain": "norm_fwd_cluster_kernel",
             "adain_residual": "norm_fwd_cluster_kernel",
             "layer_norm_ref": "ln_fwd_cluster_kernel",
             "instance_norm_bwd": "norm_bwd_cluster_kernel",
             "adain_bwd": "norm_bwd_cluster_kernel",
             "adain_residual_bwd": "norm_bwd_cluster_kernel",
             "layer_norm_ref_bwd": "ln_bwd_cluster_kernel"}
KERNELS = tuple(sorted(set(KERNEL_OF.values())))


class Site(NamedTuple):
    op: str          # a key of KERNEL_OF
    shape: tuple     # NCHW
    calls: int


def _encoder(cfg: dict, n: int) -> List[tuple]:
    """(op, shape) of the content encoder's instance norms at batch n."""
    g, hw = cfg["gen"], cfg["image_size"]
    d = g["dim"]
    out = [("instance_norm", (n, d, hw, hw))]
    for _ in range(g["content_downsample"]):
        d, hw = min(2 * d, 256), hw // 2
        out.append(("instance_norm", (n, d, hw, hw)))
    out += [("instance_norm", (n, d, hw, hw))] * (2 * g["n_res"])
    return out


def _decoder(cfg: dict, n: int) -> List[tuple]:
    """(op, shape) of the decoder's AdaIN and LayerNorm sites at batch n."""
    g = cfg["gen"]
    d, hw = g["dim"], cfg["image_size"]
    for _ in range(g["content_downsample"]):
        d, hw = min(2 * d, 256), hw // 2
    out = [("adain", (n, d, hw, hw)), ("adain_residual", (n, d, hw, hw))] * g["n_res"]
    for _ in range(g["content_downsample"]):
        d, hw = d // 2, hw * 2
        out.append(("layer_norm_ref", (n, d, hw, hw)))
    return out


def _vgg_shape(cfg: dict, n: int) -> tuple:
    return (n, 512, cfg["image_size"] // 8, cfg["image_size"] // 8)


def _collect(pairs) -> List[Site]:
    return [Site(op, shape, calls) for (op, shape), calls in Counter(pairs).items()]


def serve_sites(cfg: dict, batch: int) -> List[Site]:
    """One served batch: encode, decode (the discriminator has none)."""
    return _collect(_encoder(cfg, batch) + _decoder(cfg, batch))


def train_sites(cfg: dict, batch: int) -> List[Site]:
    """One training step with the shared generator forward: the content
    encoder at n and at 3n, the decoder at 4n and at n (the cycle), the
    VGG term's instance norm twice forward and once backward (the real
    image's features need no gradient); every generator site backward.
    Discriminator norms other than none have no kernel site here."""
    fwd = (_encoder(cfg, batch) + _encoder(cfg, 3 * batch)
           + _decoder(cfg, 4 * batch) + _decoder(cfg, batch))
    vgg = ("instance_norm", _vgg_shape(cfg, batch)) if cfg["vgg_w"] > 0 else None
    bwd = [(op + "_bwd", shape) for op, shape in fwd]
    if vgg:
        fwd += [vgg, vgg]
        bwd.append(("instance_norm_bwd", vgg[1]))
    return _collect(fwd + bwd)


def bound_s(site: Site, elem_bytes: int, stats: str) -> float:
    """The least seconds of one call of `site` with activations of
    `elem_bytes` bytes; `stats` "2pass" adds the centred sum's three
    operations per element to a forward."""
    n, c, h, w = site.shape
    elems = n * c * h * w
    if site.op.endswith("_bwd"):
        t_bytes = 3 * elems * elem_bytes / HBM_BYTES_PER_S
        t_ops = elems * BWD_OPS_PER_ELEM / FP32_FLOPS
        return max(t_bytes, t_ops)
    acts = {"instance_norm": 2, "adain": 2, "adain_residual": 3,
            "layer_norm_ref": 2}[site.op]
    params = {"instance_norm": 0, "adain": 2 * n * c, "adain_residual": 2 * n * c,
              "layer_norm_ref": 2 * c}[site.op]
    t_bytes = (acts * elems * elem_bytes + 4 * params) / HBM_BYTES_PER_S
    ops = elems * (OPS_PER_ELEM[site.op] + (3 if stats == "2pass" else 0))
    return max(t_bytes, ops / FP32_FLOPS)


def expected_launches(sites: List[Site]) -> dict:
    """{kernel name: launches} of one batch or step."""
    out = Counter()
    for s in sites:
        out[KERNEL_OF[s.op]] += s.calls
    return dict(out)
