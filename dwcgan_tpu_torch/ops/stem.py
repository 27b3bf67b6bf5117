"""The fused 7x7 encoder stem: pad 3 -> 7x7 stride-1 conv 3 -> C plus bias
-> optional instance norm -> optional ReLU (the counterpart of
`dwcgan_tpu/ops/pallas/stem_kernels.py`).

Three versions, as in `ops/norms.py`:

- `stem_conv7_plain`: straightforward PyTorch.  The inputs, weights and
  bias are rounded to the compute dtype (x's), the conv runs in fp32, the
  instance norm reads that fp32 result (not a rounded one), then the ReLU
  and one rounding to x's dtype, as the Pallas kernel does
  (stem_kernels.py:101-128).  The CPU forward and the oracle of the CUDA
  forward kernel.
- `stem_conv7_bwd_plain`: the backward of the same (stem_kernels.py:
  154-232, 273-321): the conv recomputed, the ReLU mask on the fp32 values
  (x-hat > 0 after the norm, y > 0 without it), the norm's backward, the
  conv-output gradient gc rounded to the compute dtype, dW and db from it in
  fp32, and dX of the padded input (rounded to the compute dtype) folded onto
  the image by the padding's adjoint (`unpad_grad`).
- `stem_conv7`: a `torch.autograd.Function` (`once_differentiable`).  A CPU
  tensor goes to the plain versions, a CUDA tensor to the hand-written
  kernels (`ops/cuda/kernels.py`, `csrc/stem_kernels.cu`), which raise on
  what they cannot take; there is no fallback.  When the image needs no
  gradient, no dX is computed.

Layouts are the JAX function's at this module's surface: x and the output
NHWC.  The weight is the port's `conv.weight`, OIHW [C, 3, 7, 7], and the
bias [C]; their gradients come back as fp32 in the same shapes.  Statistics
are fp32 with eps 1e-5; `stats` picks "1pass" (E[y^2] - mean^2, the JAX
kernel's only mode) or "2pass".
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from dwcgan_tpu_torch.ops.cuda import kernels
from dwcgan_tpu_torch.ops.norms import EPS, _moments_hw, _on_card, check_stats

K = 7      # kernel size
PAD = 3    # padding (the only stride-1 stem shape in the family)
PAD_TYPES = ("reflect", "replicate", "zero")


def stem_applicable(kernel_size: int, stride: int, padding: int,
                    in_ch: int, norm: str, activ: str) -> bool:
    """Whether a Conv2dBlock is a stem this op computes
    (stem_kernels.py:71-75)."""
    return (kernel_size == K and stride == 1 and padding == PAD
            and in_ch == 3 and norm in ("in", "none")
            and activ in ("relu", "none"))


def stem_fits_vmem(h: int, w: int, features: int) -> bool:
    """Whether the JAX block runs its fused stem on an h x w image with
    `features` output channels (stem_kernels.py:78-87, asked at
    dwcgan_tpu/ops/blocks.py:155-160): the TPU kernel's per-program VMEM
    estimate within 13 MiB, and h, w >= 8.  It holds at 128 px and 64
    channels (12.8 MiB).  Where it does not, the JAX block runs its plain
    conv, norm and activation, and so does the port's: this is the
    reference's choice of function, not a fallback."""
    hw = h * w
    est = (147 * hw * 2              # patch tensor (compute dtype)
           + features * hw * 4       # f32 conv accumulator
           + 2 * features * hw * 2   # double-buffered output block
           + 2 * 3 * (h + 6) * (w + 6) * 2)
    return h >= 8 and w >= 8 and est <= 13 * 1024 * 1024


def _check_args(norm: str, act: str, pad_type: str, stats: str) -> None:
    if norm not in ("in", "none") or act not in ("relu", "none") \
            or pad_type not in PAD_TYPES:
        raise ValueError(f"stem: unsupported norm {norm!r}, act {act!r} or "
                         f"pad_type {pad_type!r}")
    check_stats(stats)


def pack_weights(w: torch.Tensor, b: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """OIHW weight [C, 3, 7, 7] and bias [C] -> fp32 [148, C]: row
    (dr * 7 + dc) * 3 + ci holds w[:, ci, dr, dc], row 147 the bias; every
    value rounded to `dtype` first, as `_pack` does (stem_kernels.py:239-249)."""
    w2 = w.permute(2, 3, 1, 0).reshape(K * K * 3, -1)
    return torch.cat([w2, b.reshape(1, -1)]).to(dtype).float().contiguous()


def _pad(x: torch.Tensor, pad_type: str) -> torch.Tensor:
    mode = {"reflect": "reflect", "replicate": "replicate",
            "zero": "constant"}[pad_type]
    return F.pad(x, (PAD,) * 4, mode=mode)


def _conv32(x, w, b, pad_type):
    """(padded fp32 NCHW image, fp32 weight, fp32 conv result NCHW), every
    operand rounded to x's dtype first."""
    xp = _pad(x.permute(0, 3, 1, 2).float(), pad_type)
    w32, b32 = w.to(x.dtype).float(), b.to(x.dtype).float()
    return xp, w32, F.conv2d(xp, w32, b32)


def stem_conv7_plain(x, w, b, norm: str = "in", act: str = "relu",
                     pad_type: str = "reflect", stats: str = "1pass"):
    """x: [N, H, W, 3]; w: [C, 3, 7, 7]; b: [C] -> [N, H, W, C] in x.dtype."""
    _check_args(norm, act, pad_type, stats)
    _, _, y = _conv32(x, w, b, pad_type)
    if norm == "in":
        mean, var = _moments_hw(y, stats)
        y = (y - mean) * torch.rsqrt(var + EPS)
    if act == "relu":
        y = F.relu(y)
    return y.to(x.dtype).permute(0, 2, 3, 1)


def unpad_grad(dxp: torch.Tensor, pad_type: str) -> torch.Tensor:
    """The padding's adjoint on NCHW (stem_kernels.py:284-321): reflect
    folds each edge strip flipped onto the rows or columns 1..3 in from the
    border (corners through both axes); replicate sums the strips into the
    border row or column and the corner blocks into the corner pixels; zero
    crops."""
    p = PAD
    core = dxp[:, :, p:-p, p:-p].clone()
    if pad_type == "zero":
        return core
    if pad_type == "reflect":
        core[:, :, 1:p + 1] += dxp[:, :, :p, p:-p].flip(2)
        core[:, :, -p - 1:-1] += dxp[:, :, -p:, p:-p].flip(2)
        core[:, :, :, 1:p + 1] += dxp[:, :, p:-p, :p].flip(3)
        core[:, :, :, -p - 1:-1] += dxp[:, :, p:-p, -p:].flip(3)
        core[:, :, 1:p + 1, 1:p + 1] += dxp[:, :, :p, :p].flip(2, 3)
        core[:, :, 1:p + 1, -p - 1:-1] += dxp[:, :, :p, -p:].flip(2, 3)
        core[:, :, -p - 1:-1, 1:p + 1] += dxp[:, :, -p:, :p].flip(2, 3)
        core[:, :, -p - 1:-1, -p - 1:-1] += dxp[:, :, -p:, -p:].flip(2, 3)
        return core
    if pad_type == "replicate":
        core[:, :, 0] += dxp[:, :, :p, p:-p].sum(2)
        core[:, :, -1] += dxp[:, :, -p:, p:-p].sum(2)
        core[:, :, :, 0] += dxp[:, :, p:-p, :p].sum(3)
        core[:, :, :, -1] += dxp[:, :, p:-p, -p:].sum(3)
        core[:, :, 0, 0] += dxp[:, :, :p, :p].sum((2, 3))
        core[:, :, 0, -1] += dxp[:, :, :p, -p:].sum((2, 3))
        core[:, :, -1, 0] += dxp[:, :, -p:, :p].sum((2, 3))
        core[:, :, -1, -1] += dxp[:, :, -p:, -p:].sum((2, 3))
        return core
    raise ValueError(pad_type)


def _dx_plain(xp, w32, gc, pad_type, dtype):
    """dX of the padded input, rounded to `dtype`, folded onto the image."""
    dxp = torch.nn.grad.conv2d_input(xp.shape, w32, gc).to(dtype).float()
    return unpad_grad(dxp, pad_type).to(dtype).permute(0, 2, 3, 1)


def stem_conv7_bwd_plain(x, w, b, g, norm: str = "in", act: str = "relu",
                         pad_type: str = "reflect", stats: str = "1pass",
                         need_dx: bool = True, out=None):
    """(dx [N, H, W, 3] in x.dtype or None, dw [C, 3, 7, 7] fp32, db [C]
    fp32) of `stem_conv7_plain` for the incoming gradient g [N, H, W, C].

    The ReLU mask is the recomputed value's sign; `out`, a forward output
    [N, H, W, C], gives it instead (out > 0), so that a comparison with
    another implementation of the forward sees the same mask where a value
    sits at zero within rounding."""
    _check_args(norm, act, pad_type, stats)
    xp, w32, y = _conv32(x, w, b, pad_type)
    g32 = g.permute(0, 3, 1, 2).float()
    on = None if out is None else out.permute(0, 3, 1, 2) > 0
    if norm == "in":
        mean, var = _moments_hw(y, stats)
        rstd = torch.rsqrt(var + EPS)
        xh = (y - mean) * rstd
        if act == "relu":
            g32 = torch.where(xh > 0 if on is None else on, g32,
                              torch.zeros_like(g32))
        gc = rstd * (g32 - g32.mean(dim=(2, 3), keepdim=True)
                     - xh * (g32 * xh).mean(dim=(2, 3), keepdim=True))
    else:
        if act == "relu":
            g32 = torch.where(y > 0 if on is None else on, g32,
                              torch.zeros_like(g32))
        gc = g32
    gc = gc.to(x.dtype).float()
    dw = torch.nn.grad.conv2d_weight(xp, w32.shape, gc)
    db = gc.sum(dim=(0, 2, 3))
    dx = _dx_plain(xp, w32, gc, pad_type, x.dtype) if need_dx else None
    return dx, dw, db


class _StemConv7(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, b, norm, act, pad_type, stats):
        ctx.args = (norm, act, pad_type, stats)
        if _on_card(x):
            w2p = pack_weights(w, b, x.dtype)
            y, st = kernels.stem_conv7(x.permute(0, 3, 1, 2), w2p, norm, act,
                                       pad_type, stats)
            y = y.permute(0, 2, 3, 1)
        else:
            w2p = st = None
            y = stem_conv7_plain(x, w, b, norm, act, pad_type, stats)
        ctx.save_for_backward(x, w, b, w2p, st)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w, b, w2p, st = ctx.saved_tensors
        norm, act, pad_type, stats = ctx.args
        need_dx = ctx.needs_input_grad[0]
        if w2p is not None:
            g = g.to(x.dtype).contiguous().permute(0, 3, 1, 2)
            dx, dw, db = kernels.stem_conv7_bwd(x.permute(0, 3, 1, 2), w2p, g,
                                                st, norm, act, pad_type,
                                                need_dx)
            if dx is not None:
                dx = dx.permute(0, 2, 3, 1)
        else:
            dx, dw, db = stem_conv7_bwd_plain(x, w, b, g, norm, act, pad_type,
                                              stats, need_dx)
        return dx, dw, db, None, None, None, None


def stem_conv7(x, w, b, norm: str = "in", act: str = "relu",
               pad_type: str = "reflect", stats: str = "1pass"):
    """Fused pad + 7x7/s1 conv + (instance norm) + (ReLU).

    x: [N, H, W, 3]; w: [C, 3, 7, 7] (OIHW, the port's `conv.weight`); b:
    [C].  Returns [N, H, W, C] in x.dtype; differentiable once in x, w, b."""
    _check_args(norm, act, pad_type, stats)
    return _StemConv7.apply(x.contiguous(), w, b, norm, act, pad_type, stats)
