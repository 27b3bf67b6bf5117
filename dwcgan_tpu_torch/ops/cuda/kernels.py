"""ctypes wrappers of the hand-written Hopper norm kernels (forward only).

Each wrapper takes CUDA tensors only: an NCHW activation in channels_last
memory (NHWC bytes), bf16 or fp32, and fp32 per-channel parameters.  It
checks device, dtype, shape and layout and raises on anything else; it
allocates the output and the fp32 workspace with `torch.empty`, launches on
the current stream and raises if the launch failed.  It never falls back to
PyTorch.  `LAUNCHES` counts the calls that launched each kernel, so a run
can show that its main path went through them.

The sources are `dwcgan_tpu_torch/csrc/norm_kernels.cu`; the library is
built with nvcc at first use (`build.py`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dwcgan_tpu_torch.ops.cuda import build

LAUNCHES = {"instance_norm": 0, "adain": 0, "adain_residual": 0,
            "layer_norm_ref": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VEC = {torch.float32: 4, torch.bfloat16: 8}   # elements per 16-byte load
_THREADS = 256                                 # threads per block (csrc)
_BLOCKS_PER_SM = 4

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # x, y, ws, n, hw, c, splits, dtype, two_pass, relu, stream
    "dwc_instance_norm": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, scale, bias, residual, y, ws, n, hw, c, splits, dtype, two_pass, relu, stream
    "dwc_adain": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, gamma, beta, y, ws, n, hw, c, splits, dtype, two_pass, stream
    "dwc_layer_norm_ref": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
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
    if x.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            f"{name}: forward-only kernel; its backward comes with the "
            "training slice (run under torch.inference_mode())")


def _check_param(name: str, x: torch.Tensor, p: torch.Tensor, shape) -> None:
    if p.device != x.device or p.dtype != torch.float32 \
            or tuple(p.shape) != tuple(shape) or not p.is_contiguous():
        raise ValueError(f"{name}: parameter must be contiguous float32 "
                         f"{tuple(shape)} on {x.device}, got {p.dtype} "
                         f"{tuple(p.shape)} on {p.device}")
    if p.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(f"{name}: forward-only kernel")


def _geometry(x: torch.Tensor):
    """(n, hw, c, splits): rows of each sample are cut into `splits` chunks
    so that about _BLOCKS_PER_SM blocks per SM are in flight."""
    n, c, h, w = x.shape
    hw = h * w
    lanes = _THREADS // (c // _VEC[x.dtype])
    target = -(-_BLOCKS_PER_SM * _sm_count(x.device.index or 0) // n)
    return n, hw, c, max(1, min(target, -(-hw // lanes)))


def _launch(name: str, fn, x: torch.Tensor, args_before, args_after):
    n, hw, c, splits = _geometry(x)
    y = torch.empty_like(x, memory_format=torch.channels_last)
    ws = torch.empty(2 * n * splits * c + 2 * n * c, dtype=torch.float32,
                     device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), *args_before, y.data_ptr(), ws.data_ptr(),
                 n, hw, c, splits, _DTYPE_CODE[x.dtype], *args_after, stream)
    if err:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    LAUNCHES[name] += 1
    return y


def instance_norm(x: torch.Tensor, relu: bool = False,
                  two_pass: bool = True) -> torch.Tensor:
    """Per-(n, c) instance norm over H*W, no affine, optional fused ReLU."""
    _check_activation("instance_norm", x)
    return _launch("instance_norm", _lib().dwc_instance_norm, x, (),
                   (int(two_pass), int(relu)))


def adain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
          relu: bool = False, two_pass: bool = True) -> torch.Tensor:
    """IN(x) * scale[n, c] + bias[n, c], optional fused ReLU."""
    _check_activation("adain", x)
    for p in (scale, bias):
        _check_param("adain", x, p, x.shape[:2])
    return _launch("adain", _lib().dwc_adain, x,
                   (scale.data_ptr(), bias.data_ptr(), None),
                   (int(two_pass), int(relu)))


def adain_residual(x: torch.Tensor, y: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor, two_pass: bool = True) -> torch.Tensor:
    """x + AdaIN(y): the add is fused into the kernel's store."""
    _check_activation("adain_residual", y)
    _check_activation("adain_residual", x)
    if x.shape != y.shape or x.dtype != y.dtype or x.device != y.device:
        raise ValueError("adain_residual: x and y must match in shape, dtype "
                         "and device")
    for p in (scale, bias):
        _check_param("adain_residual", y, p, y.shape[:2])
    return _launch("adain_residual", _lib().dwc_adain, y,
                   (scale.data_ptr(), bias.data_ptr(), x.data_ptr()),
                   (int(two_pass), 0))


def layer_norm_ref(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   two_pass: bool = True) -> torch.Tensor:
    """Reference LayerNorm: per-sample mean and unbiased std over C*H*W,
    (x - mean) / (std + eps) * gamma[c] + beta[c]."""
    _check_activation("layer_norm_ref", x)
    for p in (gamma, beta):
        _check_param("layer_norm_ref", x, p, x.shape[1:2])
    return _launch("layer_norm_ref", _lib().dwc_layer_norm_ref, x,
                   (gamma.data_ptr(), beta.data_ptr()), (int(two_pass),))
