"""ctypes wrappers of the hand-written Hopper kernels, forward and
backward: the norm kernels and the fused 7x7 stem (`stem_conv7`,
`stem_conv7_bwd`, at the end).

Each wrapper takes CUDA tensors only: an NCHW activation in channels_last
memory (NHWC bytes), bf16 or fp32, and fp32 per-channel parameters.  It
checks device, dtype, shape and layout and raises on anything else; it
allocates its outputs and the fp32 workspace with `torch.empty`, launches on
the current stream and raises if the launch failed.  It never falls back to
PyTorch.  `LAUNCHES` counts the calls that launched each kernel, so a run
can show that its main path went through them.

A forward returns `(y, stats)`: `stats` is the fp32 [N, 2, C] tensor of
each sample's mean and the factor that multiplies x - mean (1/sqrt(var+eps)
per channel; the LayerNorm's 1/(std+eps) per sample, at channel 0).  The
backward takes it back, so it never recomputes the moments.  Autograd is
`ops/norms.py`'s business: these wrappers take and return plain tensors.

The sources are `dwcgan_tpu_torch/csrc/norm_kernels.cu` and
`stem_kernels.cu`; the library is built with nvcc at first use
(`build.py`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dwcgan_tpu_torch.ops.cuda import build

LAUNCHES = {"instance_norm": 0, "adain": 0, "adain_residual": 0,
            "layer_norm_ref": 0, "instance_norm_bwd": 0, "adain_bwd": 0,
            "adain_residual_bwd": 0, "layer_norm_ref_bwd": 0,
            "stem_conv7": 0, "stem_conv7_bwd": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VEC = {torch.float32: 4, torch.bfloat16: 8}   # elements per 16-byte load
_THREADS = 256                                 # threads per block (csrc)
_BLOCKS_PER_SM = 4

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # x, y, stats, ws, n, hw, c, splits, dtype, two_pass, relu, stream
    "dwc_instance_norm": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, scale, bias, residual, y, stats, ws, n, hw, c, splits, dtype,
    # two_pass, relu, stream
    "dwc_adain": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, gamma, beta, y, stats, ws, n, hw, c, splits, dtype, two_pass, stream
    "dwc_layer_norm_ref": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # x, y (mask source or NULL), g, stats, dx, ws, n, hw, c, splits, dtype,
    # stream
    "dwc_instance_norm_bwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x, y, g, stats, scale, dx, dscale, dbias, ws, n, hw, c, splits, dtype,
    # stream
    "dwc_adain_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                      _P],
    # x, g, stats, gamma, dx, dgamma, dbeta, ws, n, hw, c, splits, dtype,
    # stream
    "dwc_layer_norm_ref_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _I, _P],
    # x, w2p, y, stats, ws, n, h, w, c, dtype, norm_in, relu, pad, two_pass,
    # stream
    "dwc_stem_conv7": [_P, _P, _P, _P, _P] + [_I] * 9 + [_P],
    # x, w2p, g, stats, gc, dxp, dx, dw, ws, n, h, w, c, dtype, norm_in, relu,
    # pad, dw_blocks, stream
    "dwc_stem_conv7_bwd": [_P] * 9 + [_I] * 9 + [_P],
}


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build.build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_activation(name: str, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {x.dtype} not supported "
                        "(float32 or bfloat16)")
    if x.dim() != 4:
        raise ValueError(f"{name}: expected NCHW, got shape {tuple(x.shape)}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{name}: activation must be channels_last-contiguous")
    c, vec = x.shape[1], _VEC[x.dtype]
    if c % vec or c // vec > _THREADS:
        raise ValueError(f"{name}: {c} channels not supported for {x.dtype} "
                         f"(a multiple of {vec}, at most {vec * _THREADS})")
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: activation not 16-byte aligned")


def _check_like(name: str, x: torch.Tensor, t: torch.Tensor) -> None:
    """`t` (an incoming gradient, a saved output, a residual) must be laid
    out as the activation `x` is."""
    _check_activation(name, t)
    if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device:
        raise ValueError(f"{name}: tensors must match the activation in shape, "
                         f"dtype and device: {tuple(t.shape)} {t.dtype} "
                         f"{t.device} vs {tuple(x.shape)} {x.dtype} {x.device}")


def _check_param(name: str, x: torch.Tensor, p: torch.Tensor, shape) -> None:
    if p.device != x.device or p.dtype != torch.float32 \
            or tuple(p.shape) != tuple(shape) or not p.is_contiguous():
        raise ValueError(f"{name}: parameter must be contiguous float32 "
                         f"{tuple(shape)} on {x.device}, got {p.dtype} "
                         f"{tuple(p.shape)} on {p.device}")


def _geometry(x: torch.Tensor):
    """(n, hw, c, splits): rows of each sample are cut into `splits` chunks
    so that about _BLOCKS_PER_SM blocks per SM are in flight."""
    n, c, h, w = x.shape
    hw = h * w
    lanes = _THREADS // (c // _VEC[x.dtype])
    target = -(-_BLOCKS_PER_SM * _sm_count(x.device.index or 0) // n)
    return n, hw, c, max(1, min(target, -(-hw // lanes)))


def _f32(*shape, like: torch.Tensor) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32, device=like.device)


def _run(name: str, fn, device, *args) -> None:
    """Launch `fn(*args, stream)` on `device`'s current stream; count it."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    LAUNCHES[name] += 1


def _ptr(t):
    return None if t is None else t.data_ptr()


def _forward(name: str, fn, x: torch.Tensor, args_before, args_after):
    n, hw, c, splits = _geometry(x)
    y = torch.empty_like(x, memory_format=torch.channels_last)
    stats = _f32(n, 2, c, like=x)
    ws = _f32(2 * n * splits * c, like=x)
    _run(name, fn, x.device, x.data_ptr(), *args_before, y.data_ptr(),
         stats.data_ptr(), ws.data_ptr(), n, hw, c, splits,
         _DTYPE_CODE[x.dtype], *args_after)
    return y, stats


def instance_norm(x: torch.Tensor, relu: bool = False, two_pass: bool = True):
    """Per-(n, c) instance norm over H*W, no affine, optional fused ReLU.
    Returns (y, stats)."""
    _check_activation("instance_norm", x)
    return _forward("instance_norm", _lib().dwc_instance_norm, x, (),
                    (int(two_pass), int(relu)))


def adain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
          relu: bool = False, two_pass: bool = True):
    """IN(x) * scale[n, c] + bias[n, c], optional fused ReLU.
    Returns (y, stats)."""
    _check_activation("adain", x)
    for p in (scale, bias):
        _check_param("adain", x, p, x.shape[:2])
    return _forward("adain", _lib().dwc_adain, x,
                    (scale.data_ptr(), bias.data_ptr(), None),
                    (int(two_pass), int(relu)))


def adain_residual(x: torch.Tensor, y: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor, two_pass: bool = True):
    """x + AdaIN(y): the add is fused into the kernel's store.  Returns
    (out, stats of y)."""
    _check_activation("adain_residual", y)
    _check_like("adain_residual", y, x)
    for p in (scale, bias):
        _check_param("adain_residual", y, p, y.shape[:2])
    return _forward("adain_residual", _lib().dwc_adain, y,
                    (scale.data_ptr(), bias.data_ptr(), x.data_ptr()),
                    (int(two_pass), 0))


def layer_norm_ref(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   two_pass: bool = True):
    """Reference LayerNorm: per-sample mean and unbiased std over C*H*W,
    (x - mean) / (std + eps) * gamma[c] + beta[c].  Returns (y, stats)."""
    _check_activation("layer_norm_ref", x)
    for p in (gamma, beta):
        _check_param("layer_norm_ref", x, p, x.shape[1:2])
    return _forward("layer_norm_ref", _lib().dwc_layer_norm_ref, x,
                    (gamma.data_ptr(), beta.data_ptr()), (int(two_pass),))


# ------------------------------------------------------------------ backward

def _check_stats(name: str, x: torch.Tensor, stats: torch.Tensor) -> None:
    _check_param(name, x, stats, (x.shape[0], 2, x.shape[1]))


def _bwd_common(name: str, x, g, stats, y=None):
    _check_activation(name, x)
    _check_like(name, x, g)
    if y is not None:
        _check_like(name, x, y)
    _check_stats(name, x, stats)
    n, hw, c, splits = _geometry(x)
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    ws = _f32(2 * n * splits * c + 2 * n * c + 2 * n, like=x)
    return n, hw, c, splits, dx, ws


def instance_norm_bwd(x: torch.Tensor, g: torch.Tensor, stats: torch.Tensor,
                      y: torch.Tensor = None) -> torch.Tensor:
    """dx of `instance_norm` at x, given the incoming gradient g and the
    forward's stats; `y`, the forward output, when it fused a ReLU (the
    mask is y > 0)."""
    name = "instance_norm_bwd"
    n, hw, c, splits, dx, ws = _bwd_common(name, x, g, stats, y)
    _run(name, _lib().dwc_instance_norm_bwd, x.device, x.data_ptr(), _ptr(y),
         g.data_ptr(), stats.data_ptr(), dx.data_ptr(), ws.data_ptr(), n, hw,
         c, splits, _DTYPE_CODE[x.dtype])
    return dx


def adain_bwd(x: torch.Tensor, g: torch.Tensor, stats: torch.Tensor,
              scale: torch.Tensor, y: torch.Tensor = None,
              residual: bool = False):
    """(dx, dscale, dbias) of AdaIN at x (the ReLU mask from `y` when the
    forward fused one).  `residual`: the call is the backward of
    `adain_residual` (counted apart; its x gradient is g itself)."""
    name = "adain_residual_bwd" if residual else "adain_bwd"
    n, hw, c, splits, dx, ws = _bwd_common(name, x, g, stats, y)
    _check_param(name, x, scale, x.shape[:2])
    dscale, dbias = _f32(n, c, like=x), _f32(n, c, like=x)
    _run(name, _lib().dwc_adain_bwd, x.device, x.data_ptr(), _ptr(y),
         g.data_ptr(), stats.data_ptr(), scale.data_ptr(), dx.data_ptr(),
         dscale.data_ptr(), dbias.data_ptr(), ws.data_ptr(), n, hw, c, splits,
         _DTYPE_CODE[x.dtype])
    return dx, dscale, dbias


def layer_norm_ref_bwd(x: torch.Tensor, g: torch.Tensor, stats: torch.Tensor,
                       gamma: torch.Tensor):
    """(dx, dgamma, dbeta) of the reference LayerNorm; dgamma and dbeta are
    summed over the batch."""
    name = "layer_norm_ref_bwd"
    n, hw, c, splits, dx, ws = _bwd_common(name, x, g, stats)
    _check_param(name, x, gamma, x.shape[1:2])
    dgamma, dbeta = _f32(c, like=x), _f32(c, like=x)
    _run(name, _lib().dwc_layer_norm_ref_bwd, x.device, x.data_ptr(),
         g.data_ptr(), stats.data_ptr(), gamma.data_ptr(), dx.data_ptr(),
         dgamma.data_ptr(), dbeta.data_ptr(), ws.data_ptr(), n, hw, c, splits,
         _DTYPE_CODE[x.dtype])
    return dx, dgamma, dbeta


# ---------------------------------------------------------------- the stem

_PAD_CODE = {"reflect": 0, "replicate": 1, "zero": 2}
_STEM_TILE = (8, 32)       # output rows x columns per block (csrc)
_STEM_MAX_C = 64


def _check_stem(name: str, x: torch.Tensor, w2p: torch.Tensor, norm: str,
                act: str, pad_type: str) -> None:
    """x: the NCHW image [N, 3, H, W] in channels_last memory; w2p: the
    packed fp32 weights [148, C] (`ops/stem.py::pack_weights`)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {x.dtype} not supported "
                        "(float32 or bfloat16)")
    if x.dim() != 4 or x.shape[1] != 3 or x.shape[2] < 4 or x.shape[3] < 4:
        raise ValueError(f"{name}: expected an image [N, 3, H, W] with H, W "
                         f">= 4, got {tuple(x.shape)}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{name}: image must be channels_last-contiguous")
    c = w2p.shape[-1]
    if w2p.device != x.device or w2p.dtype != torch.float32 or w2p.dim() != 2 \
            or w2p.shape[0] != 148 or not w2p.is_contiguous() \
            or w2p.data_ptr() % 16:
        raise ValueError(f"{name}: packed weights must be contiguous float32 "
                         f"[148, C] on {x.device}, got {w2p.dtype} "
                         f"{tuple(w2p.shape)} on {w2p.device}")
    if c % 8 or not 8 <= c <= _STEM_MAX_C:
        raise ValueError(f"{name}: {c} output channels not supported (a "
                         f"multiple of 8, at most {_STEM_MAX_C})")
    if norm not in ("in", "none") or act not in ("relu", "none") \
            or pad_type not in _PAD_CODE:
        raise ValueError(f"{name}: unsupported norm {norm!r}, act {act!r} or "
                         f"pad_type {pad_type!r}")


def _stem_tiles(h: int, w: int) -> int:
    return -(-h // _STEM_TILE[0]) * -(-w // _STEM_TILE[1])


def stem_conv7(x: torch.Tensor, w2p: torch.Tensor, norm: str = "in",
               act: str = "relu", pad_type: str = "reflect",
               stats: str = "1pass"):
    """pad 3 -> 7x7 conv (+ bias) -> instance norm (norm "in") -> ReLU (act
    "relu") of the NCHW channels_last image x [N, 3, H, W], with the packed
    weights w2p [148, C].  Returns (y [N, C, H, W] channels_last in x.dtype,
    fp32 [N, 2, C] statistics (mean, rstd) or None without the norm)."""
    name = "stem_conv7"
    _check_stem(name, x, w2p, norm, act, pad_type)
    if stats not in ("1pass", "2pass"):
        raise ValueError(f"{name}: stats must be 1pass or 2pass, got {stats!r}")
    n, _, h, w = x.shape
    c = w2p.shape[1]
    y = torch.empty((n, c, h, w), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    norm_in = norm == "in"
    st = _f32(n, 2, c, like=x) if norm_in else None
    ws = _f32(2 * n * _stem_tiles(h, w) * c, like=x) if norm_in else None
    _run(name, _lib().dwc_stem_conv7, x.device, x.data_ptr(), w2p.data_ptr(),
         y.data_ptr(), _ptr(st), _ptr(ws), n, h, w, c, _DTYPE_CODE[x.dtype],
         int(norm_in), int(act == "relu"), _PAD_CODE[pad_type],
         int(stats == "2pass"))
    return y, st


def stem_conv7_bwd(x: torch.Tensor, w2p: torch.Tensor, g: torch.Tensor,
                   stats, norm: str = "in", act: str = "relu",
                   pad_type: str = "reflect", need_dx: bool = True):
    """The backward of `stem_conv7` for the incoming gradient g [N, C, H, W]
    (channels_last, x's dtype), with the forward's statistics (norm "in").
    Returns (dx [N, 3, H, W] channels_last in x.dtype, or None when
    `need_dx` is off and no dX work is done; dw [C, 3, 7, 7] OIHW fp32;
    db [C] fp32)."""
    name = "stem_conv7_bwd"
    _check_stem(name, x, w2p, norm, act, pad_type)
    n, _, h, w = x.shape
    c = w2p.shape[1]
    _check_activation(name, g)
    if tuple(g.shape) != (n, c, h, w) or g.dtype != x.dtype \
            or g.device != x.device:
        raise ValueError(f"{name}: gradient must be {x.dtype} [{n}, {c}, {h}, "
                         f"{w}] on {x.device}, got {g.dtype} {tuple(g.shape)}")
    norm_in = norm == "in"
    if norm_in:
        _check_param(name, x, stats, (n, 2, c))
    relu = act == "relu"
    gc = torch.empty_like(g) if (norm_in or relu) else None
    dx = dxp = None
    if need_dx:
        dx = torch.empty_like(x, memory_format=torch.channels_last)
        dxp = torch.empty((n, h + 6, w + 6, 3), dtype=x.dtype, device=x.device)
    # dW partial sums: each block over a strided set of 4 x 32 chunks of one
    # sample; about 2 blocks per SM for the fp32 kernel, 4 for the bf16 one
    # (2 fit on an SM at once: two full waves)
    chunks = -(-h // 4) * -(-w // 32)
    per_sm = 4 if x.dtype == torch.bfloat16 else 2
    dw_blocks = max(1, min(chunks, -(-per_sm * _sm_count(x.device.index or 0) // n)))
    dw2 = _f32(148, c, like=x)
    ws = _f32(2 * n * _stem_tiles(h, w) * c + 2 * n * c
              + n * dw_blocks * 148 * c, like=x)
    _run(name, _lib().dwc_stem_conv7_bwd, x.device, x.data_ptr(),
         w2p.data_ptr(), g.data_ptr(), _ptr(stats if norm_in else None),
         _ptr(gc), _ptr(dxp), _ptr(dx), dw2.data_ptr(), ws.data_ptr(), n, h, w,
         c, _DTYPE_CODE[x.dtype], int(norm_in), int(relu), _PAD_CODE[pad_type],
         dw_blocks)
    dw = dw2[:147].view(7, 7, 3, c).permute(3, 2, 0, 1).contiguous()
    return dx, dw, dw2[147].clone()
