"""Normalisation ops of the port (NCHW tensors, channels_last memory),
differentiable once.

Three versions of each op:

- `*_plain`: straightforward PyTorch, the counterpart of
  `dwcgan_tpu/ops/norms.py:84-172`.  The CPU forward, and the oracle the
  CUDA forward kernels are held against.
- `*_bwd_plain`: the straightforward backward formula of the same op (the
  custom VJPs of `dwcgan_tpu/ops/pallas/norm_kernels.py`).  The CPU
  backward, and the oracle of the CUDA backward kernels.
- the public op (`instance_norm`, `adain`, `adain_residual`,
  `layer_norm_ref`): a `torch.autograd.Function`.  A CPU tensor goes to the
  plain forward and the plain backward, a CUDA tensor to the hand-written
  kernels (`ops/cuda/kernels.py`), which raise on what they cannot take.
  There is no fallback from a kernel to the plain version.  On the card the
  backward reuses the forward's saved statistics.  The backward is itself
  not differentiable (`once_differentiable`): a penalty that needs the
  gradient of a gradient through one of these norms raises.

Statistics are fp32 whatever the activation dtype, eps is 1e-5, and
`stats` picks how the variance is formed (norms.py:84-93): "2pass" centres
the squares on the finished mean, "1pass" takes E[x^2] - mean^2 clamped at 0.
Both share one backward formula (the two variances are the same function of
x away from the clamp).  The normalise arithmetic is fp32 too
(`norm_compute: fp32`); the plain versions keep float64 input in float64.
A fused ReLU's mask: on the CPU the saved output's y > 0, as the Pallas
AdaIN backward takes it; on the card the backward kernel recomputes the
forward's value before the ReLU from x and the saved statistics and takes
its rounding to x's dtype > 0, which is the same mask (`relu_mask_plain`
is that rule in plain form), so y is not kept.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from dwcgan_tpu_torch.ops.cuda import kernels

EPS = 1e-5
STATS_MODES = ("2pass", "1pass")


def check_stats(stats: str) -> None:
    if stats not in STATS_MODES:
        raise ValueError(f"stats must be one of {STATS_MODES}, got {stats!r}")


def _up(t: torch.Tensor) -> torch.dtype:
    """The arithmetic dtype for t: fp32 for bf16 and fp32 (fp64 stays)."""
    return torch.promote_types(t.dtype, torch.float32)


def _moments_hw(x32: torch.Tensor, stats: str):
    """Per-(N, C) mean and biased variance over H, W."""
    mean = x32.mean(dim=(2, 3), keepdim=True)
    if stats == "1pass":
        m2 = x32.square().mean(dim=(2, 3), keepdim=True)
        var = torch.clamp(m2 - mean.square(), min=0.0)
    else:
        var = (x32 - mean).square().mean(dim=(2, 3), keepdim=True)
    return mean, var


def _moments_sample(x32: torch.Tensor, stats: str):
    """Per-sample mean and unbiased variance over C, H, W."""
    m = x32.shape[1] * x32.shape[2] * x32.shape[3]
    dims = (1, 2, 3)
    mean = x32.mean(dim=dims, keepdim=True)
    if stats == "1pass":
        s2 = x32.square().sum(dim=dims, keepdim=True)
        var = torch.clamp(s2 - m * mean.square(), min=0.0) / max(m - 1, 1)
    else:
        var = (x32 - mean).square().sum(dim=dims, keepdim=True) / max(m - 1, 1)
    return mean, var


def _bc(p: torch.Tensor) -> torch.Tensor:
    """[N, C] or [C] parameter -> broadcastable against NCHW, at least fp32."""
    p = p.to(_up(p))
    return p[:, :, None, None] if p.dim() == 2 else p[None, :, None, None]


def _in32(x, stats):
    x32 = x.to(_up(x))
    mean, var = _moments_hw(x32, stats)
    return (x32 - mean) * torch.rsqrt(var + EPS)


def instance_norm_plain(x, relu: bool = False, stats: str = "2pass"):
    """Instance norm, no affine (torch InstanceNorm2d default), optional ReLU."""
    check_stats(stats)
    y = _in32(x, stats)
    return (F.relu(y) if relu else y).to(x.dtype)


def _adain32(x, scale, bias, stats):
    x32 = x.to(_up(x))
    mean, var = _moments_hw(x32, stats)
    y = (x32 - mean) / torch.sqrt(var + EPS)
    return y * _bc(scale) + _bc(bias)


def adain_plain(x, scale, bias, relu: bool = False, stats: str = "2pass"):
    """AdaIN: IN(x) * scale + bias, scale/bias [N, C]; optional ReLU."""
    check_stats(stats)
    y = _adain32(x, scale, bias, stats)
    return (F.relu(y) if relu else y).to(x.dtype)


def relu_mask_plain(x, scale=None, bias=None, stats: str = "2pass"):
    """The mask of a fused ReLU as the backward kernels take it, from x
    instead of the forward's output: the instance norm's (AdaIN's, with
    scale and bias) value before the ReLU, t, rounded to x's dtype, > 0.
    It is y > 0 of the forward, whose output is that rounding clamped at 0."""
    check_stats(stats)
    t = _in32(x, stats) if scale is None else _adain32(x, scale, bias, stats)
    return t.to(x.dtype) > 0


def adain_residual_plain(x, y, scale, bias, stats: str = "2pass"):
    """x + AdaIN(y), with AdaIN(y) rounded to x's dtype before the add, as
    the reference adds two tensors of the compute dtype (blocks.py:387-398,
    norm_kernels.py:230-234): bf16 rounds twice, fp32 is unchanged."""
    check_stats(stats)
    return x + _adain32(y, scale, bias, stats).to(x.dtype)


def layer_norm_ref_plain(x, gamma, beta, stats: str = "2pass"):
    """The reference's custom LayerNorm (networks.py:725-752): per-sample
    mean and *unbiased* std over C, H, W, divided as (std + eps), then a
    per-channel affine.  gamma/beta: [C]."""
    check_stats(stats)
    x32 = x.to(_up(x))
    mean, var = _moments_sample(x32, stats)
    y = (x32 - mean) / (torch.sqrt(var) + EPS)
    return (y * _bc(gamma) + _bc(beta)).to(x.dtype)


# ------------------------------------------------------------ plain backward

def _masked(g, y):
    """The incoming gradient in at least fp32, times the ReLU mask y > 0 when the
    forward output `y` is given."""
    g32 = g.to(_up(g))
    return g32 if y is None else torch.where(y > 0, g32, torch.zeros_like(g32))


def _in_dx(x32, g32, mean, rstd):
    """rstd * (g - mean(g) - xh * mean(g * xh)) over H, W (norm_kernels.py:125)."""
    xh = (x32 - mean) * rstd
    return rstd * (g32 - g32.mean(dim=(2, 3), keepdim=True)
                   - xh * (g32 * xh).mean(dim=(2, 3), keepdim=True))


def instance_norm_bwd_plain(x, g, y=None, stats: str = "2pass"):
    """dx of `instance_norm_plain` at x for the incoming gradient g; `y`, the
    forward output, when the forward fused a ReLU."""
    check_stats(stats)
    x32 = x.to(_up(x))
    mean, var = _moments_hw(x32, stats)
    return _in_dx(x32, _masked(g, y), mean, torch.rsqrt(var + EPS)).to(x.dtype)


def adain_bwd_plain(x, scale, g, y=None, stats: str = "2pass"):
    """(dx, dscale, dbias) of AdaIN (norm_kernels.py:186-224): dbias = sum
    g', dscale = sum g' * xh over H, W, dx the instance-norm backward of
    g' * scale.  dscale and dbias are fp32 [N, C]."""
    check_stats(stats)
    x32 = x.to(_up(x))
    mean, var = _moments_hw(x32, stats)
    rstd = torch.rsqrt(var + EPS)
    g32 = _masked(g, y)
    xh = (x32 - mean) * rstd
    dbias = g32.sum(dim=(2, 3))
    dscale = (g32 * xh).sum(dim=(2, 3))
    dx = _in_dx(x32, g32 * _bc(scale), mean, rstd)
    return dx.to(x.dtype), dscale, dbias


def layer_norm_ref_bwd_plain(x, gamma, g, stats: str = "2pass"):
    """(dx, dgamma, dbeta) of the reference LayerNorm (norm_kernels.py:
    256-333): with u = x - mean, d = std + eps, m = C*H*W,
    du = g*gamma/d - u * sum(g*gamma*u) / ((m-1) * std * d^2), dx = du -
    mean(du); dgamma = sum g*u/d and dbeta = sum g, over the batch too."""
    check_stats(stats)
    x32 = x.to(_up(x))
    mean, var = _moments_sample(x32, stats)
    std = torch.sqrt(var)
    d = std + EPS
    m = x32.shape[1] * x32.shape[2] * x32.shape[3]
    dims = (1, 2, 3)
    u = x32 - mean
    g32 = g.to(_up(x))
    gh = g32 * _bc(gamma)
    dot = (gh * u).sum(dim=dims, keepdim=True)
    du = gh / d - u * (dot / (max(m - 1, 1) * std * d * d))
    dx = du - du.mean(dim=dims, keepdim=True)
    dgamma = (g32 * u / d).sum(dim=(0, 2, 3))
    dbeta = g32.sum(dim=(0, 2, 3))
    return dx.to(x.dtype), dgamma, dbeta


# ------------------------------------------------------------- public ops

def _on_card(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type == "cuda":
        return True
    raise ValueError(f"no kernel path for device {x.device}")


def _f32(p: torch.Tensor) -> torch.Tensor:
    return p.float().contiguous()


# the backward kernels' calls by op and shape: [calls, calls in which
# `_grad_like` copied the incoming gradient]
GRAD_COPIES: dict = {}


def _grad_like(g: torch.Tensor, x: torch.Tensor, op: str) -> torch.Tensor:
    """The incoming gradient in the layout and dtype the kernels take (a
    copy when it arrives in another; counted in GRAD_COPIES)."""
    out = g.to(x.dtype).contiguous(memory_format=torch.channels_last)
    seen = GRAD_COPIES.setdefault(f"{op} {list(x.shape)}", [0, 0])
    seen[0] += 1
    seen[1] += out is not g
    return out


class _InstanceNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, relu, stats):
        ctx.relu, ctx.stats = relu, stats
        if _on_card(x):
            y, st = kernels.instance_norm(x, relu=relu, two_pass=stats == "2pass")
        else:
            y, st = instance_norm_plain(x, relu, stats), None
        # the plain backward's ReLU mask is y > 0; the kernel's comes from x
        ctx.save_for_backward(x, y if relu and st is None else None, st)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, y, st = ctx.saved_tensors
        if st is not None:
            dx = kernels.instance_norm_bwd(x, _grad_like(g, x, "instance_norm"),
                                           st, relu=ctx.relu)
        else:
            dx = instance_norm_bwd_plain(x, g, y, ctx.stats)
        return dx, None, None


class _AdaIN(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, scale, bias, relu, stats):
        ctx.relu, ctx.stats = relu, stats
        if _on_card(x):
            y, st = kernels.adain(x, scale, bias, relu=relu,
                                  two_pass=stats == "2pass")
        else:
            y, st = adain_plain(x, scale, bias, relu, stats), None
        ctx.save_for_backward(x, scale, bias, y if relu and st is None else None,
                              st)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, scale, bias, y, st = ctx.saved_tensors
        if st is not None:
            dx, dscale, dbias = kernels.adain_bwd(
                x, _grad_like(g, x, "adain"), st, scale, bias, relu=ctx.relu)
        else:
            dx, dscale, dbias = adain_bwd_plain(x, scale, g, y, ctx.stats)
        return dx, dscale, dbias, None, None


class _AdaINResidual(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, y, scale, bias, stats):
        ctx.stats = stats
        if _on_card(y):
            out, st = kernels.adain_residual(x, y, scale, bias,
                                             two_pass=stats == "2pass")
        else:
            out, st = adain_residual_plain(x, y, scale, bias, stats), None
        ctx.save_for_backward(y, scale, st)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        y, scale, st = ctx.saved_tensors
        if st is not None:
            dy, dscale, dbias = kernels.adain_bwd(
                y, _grad_like(g, y, "adain_residual"), st, scale, residual=True)
        else:
            dy, dscale, dbias = adain_bwd_plain(y, scale, g, None, ctx.stats)
        return g, dy, dscale, dbias, None


class _LayerNormRef(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, gamma, beta, stats):
        ctx.stats = stats
        if _on_card(x):
            y, st = kernels.layer_norm_ref(x, gamma, beta,
                                           two_pass=stats == "2pass")
        else:
            y, st = layer_norm_ref_plain(x, gamma, beta, stats), None
        ctx.save_for_backward(x, gamma, st)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, gamma, st = ctx.saved_tensors
        if st is not None:
            dx, dgamma, dbeta = kernels.layer_norm_ref_bwd(
                x, _grad_like(g, x, "layer_norm_ref"), st, gamma)
        else:
            dx, dgamma, dbeta = layer_norm_ref_bwd_plain(x, gamma, g, ctx.stats)
        return dx, dgamma, dbeta, None


def instance_norm(x, relu: bool = False, stats: str = "2pass"):
    check_stats(stats)
    return _InstanceNorm.apply(x, relu, stats)


def adain(x, scale, bias, relu: bool = False, stats: str = "2pass"):
    check_stats(stats)
    if _on_card(x):
        scale, bias = _f32(scale), _f32(bias)
    return _AdaIN.apply(x, scale, bias, relu, stats)


def adain_residual(x, y, scale, bias, stats: str = "2pass"):
    check_stats(stats)
    if _on_card(y):
        scale, bias = _f32(scale), _f32(bias)
    return _AdaINResidual.apply(x, y, scale, bias, stats)


def layer_norm_ref(x, gamma, beta, stats: str = "2pass"):
    check_stats(stats)
    if _on_card(x):
        gamma, beta = _f32(gamma), _f32(beta)
    return _LayerNormRef.apply(x, gamma, beta, stats)
