"""Normalisation ops of the port (NCHW tensors, channels_last memory).

Two versions of each op:

- `*_plain`: straightforward PyTorch, the counterpart of
  `dwcgan_tpu/ops/norms.py:84-172`.  The CPU path, and the oracle the CUDA
  kernels are held against.
- the public op (`instance_norm`, `adain`, `adain_residual`,
  `layer_norm_ref`): a CPU tensor goes to the plain version, a CUDA tensor to
  the hand-written kernel (`ops/cuda/kernels.py`), which raises on what it
  cannot take.  There is no fallback from the kernel to the plain version.

Statistics are fp32 whatever the activation dtype, eps is 1e-5, and
`stats` picks how the variance is formed (norms.py:84-93): "2pass" centres
the squares on the finished mean, "1pass" takes E[x^2] - mean^2 clamped at 0.
The normalise arithmetic is fp32 too (`norm_compute: fp32`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dwcgan_tpu_torch.ops.cuda import kernels

EPS = 1e-5
STATS_MODES = ("2pass", "1pass")


def check_stats(stats: str) -> None:
    if stats not in STATS_MODES:
        raise ValueError(f"stats must be one of {STATS_MODES}, got {stats!r}")


def _moments_hw(x32: torch.Tensor, stats: str):
    """Per-(N, C) mean and biased variance over H, W (fp32)."""
    mean = x32.mean(dim=(2, 3), keepdim=True)
    if stats == "1pass":
        m2 = x32.square().mean(dim=(2, 3), keepdim=True)
        var = torch.clamp(m2 - mean.square(), min=0.0)
    else:
        var = (x32 - mean).square().mean(dim=(2, 3), keepdim=True)
    return mean, var


def _bc(p: torch.Tensor) -> torch.Tensor:
    """[N, C] or [C] parameter -> broadcastable against NCHW, fp32."""
    p = p.float()
    return p[:, :, None, None] if p.dim() == 2 else p[None, :, None, None]


def instance_norm_plain(x, relu: bool = False, stats: str = "2pass"):
    """Instance norm, no affine (torch InstanceNorm2d default), optional ReLU."""
    check_stats(stats)
    x32 = x.float()
    mean, var = _moments_hw(x32, stats)
    y = (x32 - mean) * torch.rsqrt(var + EPS)
    return (F.relu(y) if relu else y).to(x.dtype)


def _adain32(x, scale, bias, stats):
    x32 = x.float()
    mean, var = _moments_hw(x32, stats)
    y = (x32 - mean) / torch.sqrt(var + EPS)
    return y * _bc(scale) + _bc(bias)


def adain_plain(x, scale, bias, relu: bool = False, stats: str = "2pass"):
    """AdaIN: IN(x) * scale + bias, scale/bias [N, C]; optional ReLU."""
    check_stats(stats)
    y = _adain32(x, scale, bias, stats)
    return (F.relu(y) if relu else y).to(x.dtype)


def adain_residual_plain(x, y, scale, bias, stats: str = "2pass"):
    """x + AdaIN(y), added in fp32 and rounded once (as the kernel does)."""
    check_stats(stats)
    return (x.float() + _adain32(y, scale, bias, stats)).to(x.dtype)


def layer_norm_ref_plain(x, gamma, beta, stats: str = "2pass"):
    """The reference's custom LayerNorm (networks.py:725-752): per-sample
    mean and *unbiased* std over C, H, W, divided as (std + eps), then a
    per-channel affine.  gamma/beta: [C]."""
    check_stats(stats)
    x32 = x.float()
    n = x32.shape[1] * x32.shape[2] * x32.shape[3]
    dims = (1, 2, 3)
    mean = x32.mean(dim=dims, keepdim=True)
    if stats == "1pass":
        s2 = x32.square().sum(dim=dims, keepdim=True)
        var = torch.clamp(s2 - n * mean.square(), min=0.0) / max(n - 1, 1)
    else:
        var = (x32 - mean).square().sum(dim=dims, keepdim=True) / max(n - 1, 1)
    y = (x32 - mean) / (torch.sqrt(var) + EPS)
    return (y * _bc(gamma) + _bc(beta)).to(x.dtype)


def _on_card(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type == "cuda":
        return True
    raise ValueError(f"no norm path for device {x.device}")


def _f32(p: torch.Tensor) -> torch.Tensor:
    return p.float().contiguous()


def instance_norm(x, relu: bool = False, stats: str = "2pass"):
    check_stats(stats)
    if not _on_card(x):
        return instance_norm_plain(x, relu, stats)
    return kernels.instance_norm(x, relu=relu, two_pass=stats == "2pass")


def adain(x, scale, bias, relu: bool = False, stats: str = "2pass"):
    check_stats(stats)
    if not _on_card(x):
        return adain_plain(x, scale, bias, relu, stats)
    return kernels.adain(x, _f32(scale), _f32(bias), relu=relu,
                         two_pass=stats == "2pass")


def adain_residual(x, y, scale, bias, stats: str = "2pass"):
    check_stats(stats)
    if not _on_card(y):
        return adain_residual_plain(x, y, scale, bias, stats)
    return kernels.adain_residual(x, y, _f32(scale), _f32(bias),
                                  two_pass=stats == "2pass")


def layer_norm_ref(x, gamma, beta, stats: str = "2pass"):
    check_stats(stats)
    if not _on_card(x):
        return layer_norm_ref_plain(x, gamma, beta, stats)
    return kernels.layer_norm_ref(x, _f32(gamma), _f32(beta),
                                  two_pass=stats == "2pass")
