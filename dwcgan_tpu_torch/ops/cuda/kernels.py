"""ctypes wrappers of the hand-written Hopper kernels, forward and
backward: the norm kernels, the fused 7x7 stem (`stem_conv7`,
`stem_conv7_bwd`) and the text encoder's bi-LSTM recurrence (`lstm`,
`lstm_bwd`, at the end).

Each wrapper takes CUDA tensors only: an NCHW activation in channels_last
memory (NHWC bytes), bf16 or fp32, and fp32 per-channel parameters.  It
checks device, dtype, shape and layout and raises on anything else; it
allocates its outputs and the fp32 workspace with `torch.empty`, launches on
the current stream and raises if the launch failed.  It never falls back to
PyTorch.  `LAUNCHES` counts the calls that launched each kernel, so a run
can show that its main path went through them; `ARITH_LAUNCHES` those of
them made with the bf16 arithmetic (`arith`) on.

A forward returns `(y, stats)`: `stats` is the fp32 [N, 2, C] tensor of
each sample's mean and the factor that multiplies x - mean (1/sqrt(var+eps)
per channel; the LayerNorm's 1/(std+eps) per sample, at channel 0).  The
backward takes it back, so it never recomputes the moments.  Autograd is
`ops/norms.py`'s business: these wrappers take and return plain tensors.

The instance norm and AdaIN, forward and backward, are one cluster kernel
per call, and so is the reference LayerNorm, laid out by `fwd_plan`,
`bwd_plan` and `ln_bwd_plan`: k blocks per sample, each keeping as many
rows of its slab of x (the backward: of x and g) in shared memory as its
plan gives it.  A fused ReLU's mask is recomputed in the backward kernel
from x and the statistics; `relu_mask_mismatches` counts where that mask
differs from a forward output's y > 0 (a check; 0 is right).

`arith` (the instance norm and AdaIN, forward and backward): with it on
and bf16 data the normalise chain runs in bf16, rounded after every op
(`norm_compute: bf16`, the rule in `ops/norms.py` and the source's
header); the statistics stay fp32, the plans do not change, and fp32 data
ignores it.

The sources are `dwcgan_tpu_torch/csrc/norm_kernels.cu`,
`stem_kernels.cu` and `lstm_kernels.cu`; the library is built with nvcc at
first use (`build.py`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from dwcgan_tpu_torch.ops.cuda import build

LAUNCHES = {"instance_norm": 0, "adain": 0, "adain_residual": 0,
            "layer_norm_ref": 0, "instance_norm_bwd": 0, "adain_bwd": 0,
            "adain_residual_bwd": 0, "layer_norm_ref_bwd": 0,
            "stem_conv7": 0, "stem_conv7_bwd": 0, "lstm": 0, "lstm_bwd": 0}
ARITH_LAUNCHES = {"instance_norm": 0, "adain": 0, "adain_residual": 0,
                  "instance_norm_bwd": 0, "adain_bwd": 0, "adain_residual_bwd": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VEC = {torch.float32: 4, torch.bfloat16: 8}   # elements per 16-byte load
_THREADS = 256                                 # threads per block (csrc)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # x, y, stats, n, hw, c, dtype, two_pass, relu, arith, k, resident, smem,
    # stream
    "dwc_instance_norm": [_P] * 3 + [_I] * 10 + [_P],
    # x, scale, bias, residual, y, stats, n, hw, c, dtype, two_pass, relu,
    # arith, k, resident, smem, stream
    "dwc_adain": [_P] * 6 + [_I] * 10 + [_P],
    # x, gamma, beta, y, stats, n, hw, c, dtype, two_pass, k, resident, smem,
    # stream
    "dwc_layer_norm_ref": [_P] * 5 + [_I] * 8 + [_P],
    # op (0 IN, 1 AdaIN, 2 LayerNorm), dtype, relu, residual, arith, c, k,
    # resident, smem, *clusters
    "dwc_norm_fwd_clusters": [_I] * 9 + [ctypes.POINTER(ctypes.c_int)],
    # buf (the forward's phase trace, or NULL)
    "dwc_norm_fwd_trace": [_P],
    # x, g, stats, dx, y (the check's, or NULL), mismatch (or NULL), n, hw,
    # c, dtype, relu, arith, k, resident, smem, stream
    "dwc_instance_norm_bwd": [_P] * 6 + [_I] * 9 + [_P],
    # x, g, stats, scale, bias, dx, dscale, dbias, y, mismatch, n, hw, c,
    # dtype, relu, arith, k, resident, smem, stream
    "dwc_adain_bwd": [_P] * 10 + [_I] * 9 + [_P],
    # x, g, stats, gamma, dx, dgamma, dbeta, ws, counter, n, hw, c, dtype, k,
    # resident, smem, stream
    "dwc_layer_norm_ref_bwd": [_P] * 9 + [_I] * 7 + [_P],
    # op (0 IN, 1 AdaIN, 2 LayerNorm), dtype, relu, check, arith, c, k,
    # resident, smem, *clusters
    "dwc_norm_bwd_clusters": [_I] * 9 + [ctypes.POINTER(ctypes.c_int)],
    # x, w2p, y, stats, ws, n, h, w, c, dtype, norm_in, relu, pad, two_pass,
    # stream
    "dwc_stem_conv7": [_P, _P, _P, _P, _P] + [_I] * 9 + [_P],
    # x, w2p, g, stats, gc, dxp, dx, dw, ws, n, h, w, c, dtype, norm_in, relu,
    # pad, dw_blocks, stream
    "dwc_stem_conv7_bwd": [_P] * 9 + [_I] * 9 + [_P],
    # proj, w_hh, lengths, out, h, c, acts, cs, batch, steps, hidden, dtype,
    # k, units, rows, stream
    "dwc_lstm": [_P] * 8 + [_I] * 7 + [_P],
    # w_hh, lengths, acts, cs, d_out, d_h, d_c, dproj, batch, steps, hidden,
    # dtype, k, units, rows, stream
    "dwc_lstm_bwd": [_P] * 8 + [_I] * 7 + [_P],
    # k, steps, stream
    "dwc_lstm_barriers": [_I, _I, _P],
}


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build.build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    # hidden, units, rows, k, dtype, bwd -> bytes (-1: a layout it refuses)
    lib.dwc_lstm_smem.argtypes = [_I] * 6
    lib.dwc_lstm_smem.restype = ctypes.c_longlong
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


def _f32(*shape, like: torch.Tensor) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32, device=like.device)


def _run(name: str, fn, device, *args, count: bool = True,
         arith: bool = False) -> None:
    """Launch `fn(*args, stream)` on `device`'s current stream; count it
    (unless `count` is off: a check, not the op), and in ARITH_LAUNCHES
    too when it ran with `arith` on."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    if count:
        LAUNCHES[name] += 1
        if arith:
            ARITH_LAUNCHES[name] += 1


def _ptr(t):
    return None if t is None else t.data_ptr()


# ------------------------------------------------------------ cluster plans

_SMEM_SM = 233472    # shared memory of an SM (228 KB)
_SMEM_RESERVED = 1024   # what the card reserves of it for each block
_CLUSTER = 8         # blocks per sample: the portable cluster size
_LN_CLUSTER = 16     # the LayerNorm backward's: Hopper's non-portable size
_CHUNKS = 4          # bulk copies per block (csrc kChunks)
_BWD_PER_SM = 2      # rows 5-6's backward: blocks per SM
# op codes of the cluster kernels' C entry points (csrc FwdOp, BwdOp)
_IN, _ADAIN, _LN = 0, 1, 2


def smem_budget(per_sm: int) -> int:
    """Shared memory of a block when `per_sm` blocks share each SM."""
    return _SMEM_SM // per_sm - _SMEM_RESERVED


class ClusterPlan(NamedTuple):
    """How a cluster kernel lays out one call (csrc `fwd_smem`,
    `bwd_smem`): a cluster of k blocks per sample."""
    k: int          # blocks per sample, one cluster
    rows: int       # rows of the longest slab, ceil(hw / k)
    resident: int   # rows a block keeps in shared memory (the rest streams)
    smem: int       # dynamic shared memory of a block, bytes


def cluster_slabs(hw: int, k: int):
    """Rows [start, end) of each block of a sample's cluster, by rank, as
    the kernels cut them (rank * hw // k)."""
    return [(r * hw // k, (r + 1) * hw // k) for r in range(k)]


def _cluster_plan(name: str, n: int, hw: int, c: int, dtype: torch.dtype,
                  staged: int, fixed_floats: int, budget: int,
                  k: int = None, max_k: int = _CLUSTER) -> ClusterPlan:
    """k = min(8, hw) blocks per sample (or min(`k`, `max_k`, hw)), each
    keeping the first `resident` rows of its slab of the `staged` tensors in
    shared memory beside the block's sums (2 * 256 * V lane partials,
    `fixed_floats` * c floats, four mbarriers), as many as fit in `budget`
    bytes.  Raises on a shape the kernels cannot take."""
    if dtype not in _VEC:
        raise TypeError(f"{name}: dtype {dtype} not supported")
    vec, size = _VEC[dtype], torch.finfo(dtype).bits // 8
    if n < 1 or n > 65535 or hw < 1 or c < vec or c % vec or c // vec > _THREADS:
        raise ValueError(f"{name}: no plan for n {n}, hw {hw}, c {c}, {dtype}")
    k = min(k or _CLUSTER, max_k, hw)
    rows = -(-hw // k)
    fixed = 2 * _THREADS * vec * 4 + fixed_floats * c * 4 + _CHUNKS * 8
    per_row = staged * c * size
    resident = min(rows, (budget - fixed) // per_row)
    if resident < 1:
        raise ValueError(f"{name}: not one row of c {c} fits in {budget} bytes "
                         "of shared memory")
    return ClusterPlan(k, rows, resident, fixed + resident * per_row)


# The cluster forward's layout: 6 blocks per sample, a block's shared
# memory capped at a whole SM's 227 KB.  A block takes only what its slab
# needs, so the small slabs share an SM (two blocks of 109 KB at [32, 256,
# 32, 32] in bf16, every cluster on the card at once) and the large ones
# keep most of their rows resident.  On the H100 it beat every other
# layout of `chip_smoke.sweep_fwd_plans` (k 4, 6, 7, 8 x 1-3 blocks per
# SM), per served batch and per training step.
_FWD_K = 6
_FWD_PER_SM = 1


def fwd_plan(n: int, hw: int, c: int, dtype: torch.dtype, per_sm: int = None,
             k: int = None) -> ClusterPlan:
    """The cluster forward's layout for an [n, c, h, w] activation with
    hw = h * w, the instance norm's, AdaIN's and the LayerNorm's: k =
    min(6, hw) blocks per sample, each staging the first rows of its slab
    of x, as many as fit beside 5 * c floats of sums and statistics in
    `smem_budget(1)` bytes.  `per_sm` and `k`: another layout (a sweep's).
    Raises on a shape it cannot take."""
    return _cluster_plan("fwd_plan", n, hw, c, dtype, 1, 5,
                         smem_budget(per_sm or _FWD_PER_SM), k or _FWD_K)


def bwd_plan(n: int, hw: int, c: int, dtype: torch.dtype) -> ClusterPlan:
    """The cluster backward's layout: a cluster per sample, staging x and g
    beside 4 * c floats of sums, in half an SM, so that two blocks share
    each SM: one's loads overlap the other's sums and stores, and twice the
    clusters run at once (30 of 8 blocks on the H100 against 15 at a
    block's full 227 KB).  On the H100 that beat keeping twice the rows
    resident at every training-step site, the slabs that then stream most
    of their rows twice too.  Raises on a shape it cannot take."""
    return _cluster_plan("bwd_plan", n, hw, c, dtype, 2, 4, smem_budget(_BWD_PER_SM))


# The LayerNorm backward's layout: the instance norm's shared memory layout
# (x and g staged beside 4 * c floats), 16 blocks per sample (a non-portable
# cluster), two blocks per SM: 14 clusters on the H100 at once, each keeping
# 74 % of a [., 128, 64, 64] sample resident and 37 % of a [., 64, 128, 128]
# one, and one block's loads overlapping the other's sums and stores.  On
# the H100 it beat every other layout of `chip_smoke.sweep_ln_plans` (k 4,
# 6, 8, 12, 16 x 1-2 blocks per SM) per training step.
_LN_BWD_K = 16
_LN_BWD_PER_SM = 2


def ln_bwd_plan(n: int, hw: int, c: int, dtype: torch.dtype, per_sm: int = None,
                k: int = None) -> ClusterPlan:
    """The LayerNorm backward's layout: k = min(16, hw) blocks per sample,
    staging x and g beside 4 * c floats of sums in `smem_budget(2)` bytes.
    `per_sm` and `k` (up to 16): another layout (a sweep's).  Raises on a
    shape it cannot take."""
    return _cluster_plan("ln_bwd_plan", n, hw, c, dtype, 2, 4,
                         smem_budget(per_sm or _LN_BWD_PER_SM), k or _LN_BWD_K,
                         max_k=_LN_CLUSTER)


def _clusters(name: str, fn, device: int, args) -> int:
    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = fn(*args, ctypes.byref(n))
    if err:
        raise RuntimeError(f"{name} setup failed with CUDA error {err}")
    if n.value == 0:
        raise RuntimeError(f"{name}: no cluster of this plan fits on the card: "
                           f"{args}")
    return n.value


@functools.lru_cache(maxsize=None)
def fwd_clusters(device: int, op: int, dtype: torch.dtype, relu: bool,
                 residual: bool, c: int, plan: ClusterPlan,
                 arith: bool = False) -> int:
    """Set the cluster forward up for this configuration (op 0 instance
    norm, 1 AdaIN, 2 the LayerNorm; `arith`: norm_compute bf16) on card
    `device` (once) and return how many of its clusters fit on the card at
    once; raise if none does."""
    return _clusters("norm forward", _lib().dwc_norm_fwd_clusters, device,
                     (op, _DTYPE_CODE[dtype], int(relu), int(residual),
                      int(arith), c, plan.k, plan.resident, plan.smem))


@functools.lru_cache(maxsize=None)
def bwd_clusters(device: int, op: int, dtype: torch.dtype, relu: bool,
                 check: bool, c: int, plan: ClusterPlan,
                 arith: bool = False) -> int:
    """The same for the cluster backward (op 0 instance norm, 1 AdaIN, 2
    the LayerNorm; `check`: the mask-check variant)."""
    return _clusters("norm backward", _lib().dwc_norm_bwd_clusters, device,
                     (op, _DTYPE_CODE[dtype], int(relu), int(check), int(arith),
                      c, plan.k, plan.resident, plan.smem))


# ------------------------------------------------------------------ forward

def _arith(x: torch.Tensor, arith: bool) -> bool:
    """Whether the bf16 arithmetic applies: asked for, on bf16 data."""
    return bool(arith) and x.dtype == torch.bfloat16


def _forward(name: str, fn, x: torch.Tensor, op: int, relu: bool,
             residual: bool, two_pass: bool, params, plan: ClusterPlan,
             arith: bool = False):
    """One launch of the cluster forward on x; `params`: the pointers
    between x and y in `fn`'s signature.  Returns (y, stats)."""
    n, c, h, w = x.shape
    plan = plan or fwd_plan(n, h * w, c, x.dtype)
    arith = _arith(x, arith)
    fwd_clusters(x.device.index or 0, op, x.dtype, relu, residual, c, plan, arith)
    y = torch.empty_like(x, memory_format=torch.channels_last)
    stats = _f32(n, 2, c, like=x)
    flags = (int(two_pass),) if op == _LN else (int(two_pass), int(relu), int(arith))
    _run(name, fn, x.device, x.data_ptr(), *params, y.data_ptr(), stats.data_ptr(),
         n, h * w, c, _DTYPE_CODE[x.dtype], *flags, plan.k, plan.resident, plan.smem,
         arith=arith)
    return y, stats


def instance_norm(x: torch.Tensor, relu: bool = False, two_pass: bool = True,
                  plan: ClusterPlan = None, arith: bool = False):
    """Per-(n, c) instance norm over H*W, no affine, optional fused ReLU.
    Returns (y, stats).  `plan`: a layout other than `fwd_plan`'s (a
    sweep's); `arith`: norm_compute bf16 (module docstring)."""
    _check_activation("instance_norm", x)
    return _forward("instance_norm", _lib().dwc_instance_norm, x, _IN, relu,
                    False, two_pass, (), plan, arith)


def adain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
          relu: bool = False, two_pass: bool = True, plan: ClusterPlan = None,
          arith: bool = False):
    """IN(x) * scale[n, c] + bias[n, c], optional fused ReLU.
    Returns (y, stats)."""
    _check_activation("adain", x)
    for p in (scale, bias):
        _check_param("adain", x, p, x.shape[:2])
    return _forward("adain", _lib().dwc_adain, x, _ADAIN, relu, False, two_pass,
                    (scale.data_ptr(), bias.data_ptr(), None), plan, arith)


def adain_residual(x: torch.Tensor, y: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor, two_pass: bool = True, plan: ClusterPlan = None,
                   arith: bool = False):
    """x + AdaIN(y): the add is fused into the kernel's store.  Returns
    (out, stats of y)."""
    _check_activation("adain_residual", y)
    _check_like("adain_residual", y, x)
    for p in (scale, bias):
        _check_param("adain_residual", y, p, y.shape[:2])
    return _forward("adain_residual", _lib().dwc_adain, y, _ADAIN, False, True,
                    two_pass, (scale.data_ptr(), bias.data_ptr(), x.data_ptr()), plan,
                    arith)


def fwd_trace(fn, x: torch.Tensor, plan: ClusterPlan = None) -> torch.Tensor:
    """Run `fn()` (one forward of rows 1-4 on x) with the phase trace on: the
    card's nanosecond clock at six points of every block, int64 [n, k, 6]
    (start; its slab summed; the block's sums formed; the statistics known;
    its part of y stored; the end).  A diagnostic: synchronises."""
    n, c, h, w = x.shape
    plan = plan or fwd_plan(n, h * w, c, x.dtype)
    buf = torch.zeros(n, plan.k, 6, dtype=torch.int64, device=x.device)
    with torch.cuda.device(x.device):
        torch.cuda.synchronize()
        try:
            if _lib().dwc_norm_fwd_trace(buf.data_ptr()):
                raise RuntimeError("fwd_trace: could not set the trace buffer")
            fn()
            torch.cuda.synchronize()
        finally:
            _lib().dwc_norm_fwd_trace(None)
    return buf


def layer_norm_ref(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   two_pass: bool = True, plan: ClusterPlan = None):
    """Reference LayerNorm: per-sample mean and unbiased std over C*H*W,
    (x - mean) / (std + eps) * gamma[c] + beta[c].  Returns (y, stats),
    the per-sample statistics at every channel."""
    name = "layer_norm_ref"
    _check_activation(name, x)
    for p in (gamma, beta):
        _check_param(name, x, p, x.shape[1:2])
    return _forward(name, _lib().dwc_layer_norm_ref, x, _LN, False, False, two_pass,
                    (gamma.data_ptr(), beta.data_ptr()), plan)


# ------------------------------------------------------------------ backward

def _check_stats(name: str, x: torch.Tensor, stats: torch.Tensor) -> None:
    _check_param(name, x, stats, (x.shape[0], 2, x.shape[1]))


def _bwd_common(name: str, x, g, stats, op: int, relu: bool, check: bool = False,
                plan: ClusterPlan = None, arith: bool = False):
    """Checks, the plan and its setup; returns (n, hw, c, plan)."""
    _check_activation(name, x)
    _check_like(name, x, g)
    _check_stats(name, x, stats)
    n, c, h, w = x.shape
    plan = plan or (ln_bwd_plan if op == _LN else bwd_plan)(n, h * w, c, x.dtype)
    bwd_clusters(x.device.index or 0, op, x.dtype, relu, check, c, plan, arith)
    return n, h * w, c, plan


def instance_norm_bwd(x: torch.Tensor, g: torch.Tensor, stats: torch.Tensor,
                      relu: bool = False, arith: bool = False) -> torch.Tensor:
    """dx of `instance_norm` at x, given the incoming gradient g and the
    forward's stats; `relu`: the forward fused a ReLU (its mask is
    recomputed from x and the stats); `arith`: the forward's."""
    name = "instance_norm_bwd"
    arith = _arith(x, arith)
    n, hw, c, plan = _bwd_common(name, x, g, stats, _IN, relu, arith=arith)
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    _run(name, _lib().dwc_instance_norm_bwd, x.device, x.data_ptr(), g.data_ptr(),
         stats.data_ptr(), dx.data_ptr(), None, None, n, hw, c,
         _DTYPE_CODE[x.dtype], int(relu), int(arith), plan.k, plan.resident, plan.smem,
         arith=arith)
    return dx


def adain_bwd(x: torch.Tensor, g: torch.Tensor, stats: torch.Tensor,
              scale: torch.Tensor, bias: torch.Tensor = None, relu: bool = False,
              residual: bool = False, arith: bool = False):
    """(dx, dscale, dbias) of AdaIN at x; `relu`: the forward fused a ReLU,
    whose mask is recomputed from x, the stats, scale and `bias`.
    `residual`: the call is the backward of `adain_residual` (counted
    apart; its x gradient is g itself); `arith`: the forward's."""
    name = "adain_residual_bwd" if residual else "adain_bwd"
    arith = _arith(x, arith)
    n, hw, c, plan = _bwd_common(name, x, g, stats, _ADAIN, relu, arith=arith)
    _check_param(name, x, scale, x.shape[:2])
    if relu:
        _check_param(name, x, bias, x.shape[:2])
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    dscale, dbias = _f32(n, c, like=x), _f32(n, c, like=x)
    _run(name, _lib().dwc_adain_bwd, x.device, x.data_ptr(), g.data_ptr(),
         stats.data_ptr(), scale.data_ptr(), _ptr(bias) if relu else None,
         dx.data_ptr(), dscale.data_ptr(), dbias.data_ptr(), None, None, n, hw, c,
         _DTYPE_CODE[x.dtype], int(relu), int(arith), plan.k, plan.resident, plan.smem,
         arith=arith)
    return dx, dscale, dbias


def relu_mask_mismatches(x: torch.Tensor, y: torch.Tensor, stats: torch.Tensor,
                         scale: torch.Tensor = None,
                         bias: torch.Tensor = None, arith: bool = False) -> int:
    """How many elements of the ReLU mask that the instance-norm (AdaIN
    with `scale` and `bias`) backward kernel recomputes from x and the
    stats differ from y > 0, y the forward's fused-ReLU output: the same
    kernel in a variant that also reads y.  A check, not counted as a
    launch; synchronises to read the count."""
    adain = scale is not None
    name = "relu_mask_mismatches"
    arith = _arith(x, arith)
    n, hw, c, plan = _bwd_common(name, x, y, stats, int(adain), True, True,
                                 arith=arith)
    count = torch.zeros(1, dtype=torch.int32, device=x.device)
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    if adain:
        for p in (scale, bias):
            _check_param(name, x, p, x.shape[:2])
        d = _f32(2, n, c, like=x)
        _run(name, _lib().dwc_adain_bwd, x.device, x.data_ptr(), y.data_ptr(),
             stats.data_ptr(), scale.data_ptr(), bias.data_ptr(), dx.data_ptr(),
             d[0].data_ptr(), d[1].data_ptr(), y.data_ptr(), count.data_ptr(), n,
             hw, c, _DTYPE_CODE[x.dtype], 1, int(arith), plan.k, plan.resident,
             plan.smem, count=False)
    else:
        _run(name, _lib().dwc_instance_norm_bwd, x.device, x.data_ptr(),
             y.data_ptr(), stats.data_ptr(), dx.data_ptr(), y.data_ptr(),
             count.data_ptr(), n, hw, c, _DTYPE_CODE[x.dtype], 1, int(arith),
             plan.k, plan.resident, plan.smem, count=False)
    return int(count.item())


@functools.lru_cache(maxsize=None)
def _ln_counter(device: int) -> torch.Tensor:
    """The LayerNorm backward's count of finished samples on card `device`:
    one 32-bit word, zeroed here once; every call leaves it 0 (its last
    cluster sets it back), also when a CUDA graph replays the call.  Calls
    on one card must not overlap in time (one stream), as on the training
    path."""
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("layer_norm_ref_bwd: call it once before capturing "
                           "it in a CUDA graph")
    return torch.zeros(1, dtype=torch.int32, device=torch.device("cuda", device))


def layer_norm_ref_bwd(x: torch.Tensor, g: torch.Tensor, stats: torch.Tensor,
                       gamma: torch.Tensor, plan: ClusterPlan = None):
    """(dx, dgamma, dbeta) of the reference LayerNorm; dgamma and dbeta are
    summed over the batch, in sample order.  `plan`: a layout other than
    `ln_bwd_plan`'s (a sweep's)."""
    name = "layer_norm_ref_bwd"
    n, hw, c, plan = _bwd_common(name, x, g, stats, _LN, False, plan=plan)
    _check_param(name, x, gamma, x.shape[1:2])
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    ws = _f32(n, 2, c, like=x)
    dgamma, dbeta = _f32(c, like=x), _f32(c, like=x)
    _run(name, _lib().dwc_layer_norm_ref_bwd, x.device, x.data_ptr(),
         g.data_ptr(), stats.data_ptr(), gamma.data_ptr(), dx.data_ptr(),
         dgamma.data_ptr(), dbeta.data_ptr(), ws.data_ptr(),
         _ln_counter(x.device.index or 0).data_ptr(), n, hw, c,
         _DTYPE_CODE[x.dtype], plan.k, plan.resident, plan.smem)
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


# -------------------------------------------------- the bi-LSTM recurrence

_LSTM_K = {torch.bfloat16: 8, torch.float32: 16}      # blocks a cluster aims at
_LSTM_ALIGN = {torch.bfloat16: 8, torch.float32: 4}   # units a block: whole 16-byte vectors
_LSTM_PAIRS = 5     # (row, unit) pairs a thread carries (csrc kPairs)
_LSTM_MAX_K = 16    # Hopper's non-portable cluster size


class LstmPlan(NamedTuple):
    """How the recurrence kernels lay out one layer (csrc `Geo`): a cluster
    of k blocks per direction and group of rows, block r owning the hidden
    units [r * units, (r + 1) * units)."""
    k: int          # blocks a cluster
    units: int      # hidden units a block
    rows: int       # rows a cluster (16 or 32)
    groups: int     # clusters a direction
    smem: int       # dynamic shared memory of a forward block, bytes
    smem_bwd: int   # of a backward block


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def lstm_smem(hidden: int, units: int, rows: int, k: int, bf16: bool):
    """(forward, backward) shared memory of a block, bytes (csrc
    `Geo::fwd_smem`, `Geo::bwd_smem`)."""
    size, nc, gs = (2 if bf16 else 4), 4 * units, 4 * units + 8
    if bf16:
        ks = _round_up(hidden, 16) + 8
        wb = _round_up(hidden, 8) * gs
    else:
        ks = _round_up(hidden, 4)
        ks += 0 if (ks // 4) % 2 else 4
        wb = nc * _round_up(hidden, 4)
    fwd = nc * ks * size + 2 * rows * ks * size + rows * gs * 4 + rows * units * size
    bwd = wb * size + rows * gs * size + 2 * k * rows * units * 4
    return fwd, bwd


def lstm_plan(batch: int, hidden: int, dtype: torch.dtype) -> LstmPlan:
    """The recurrence's layout for `batch` rows of `hidden` units: about 8
    blocks a cluster in bf16 (16 in fp32, whose w_hh rows take twice the
    bytes), each owning a whole number of 16-byte vectors of units; 16 rows
    a cluster up to 16 rows, else 32 (as many as the thread's pairs hold),
    and more clusters for more rows.  Raises on a shape it cannot take."""
    if dtype not in _LSTM_K:
        raise TypeError(f"lstm_plan: dtype {dtype} not supported (float32 or bfloat16)")
    if batch < 1 or hidden < 1:
        raise ValueError(f"lstm_plan: no plan for batch {batch}, hidden {hidden}")
    units = _round_up(-(-hidden // _LSTM_K[dtype]), _LSTM_ALIGN[dtype])
    k = -(-hidden // units)
    rows = 16 if batch <= 16 or 32 * units > _LSTM_PAIRS * _THREADS else 32
    fwd, bwd = lstm_smem(hidden, units, rows, k, dtype == torch.bfloat16)
    if k > _LSTM_MAX_K or rows * units > _LSTM_PAIRS * _THREADS \
            or max(fwd, bwd) > smem_budget(1):
        raise ValueError(f"lstm_plan: hidden {hidden} in {dtype} does not fit a "
                         f"cluster ({k} blocks of {units} units, {max(fwd, bwd)} bytes)")
    return LstmPlan(k, units, rows, -(-batch // rows), fwd, bwd)


def _check_lstm(name: str, proj: torch.Tensor, w_hh: torch.Tensor,
                lengths: torch.Tensor) -> None:
    """proj [B, steps, 8H] and w_hh [2, 4H, H] contiguous, of one dtype
    (float32 or bfloat16); lengths int32 [B]; all on one CUDA card."""
    if proj.dtype not in _DTYPE_CODE or w_hh.dtype != proj.dtype:
        raise TypeError(f"{name}: dtype {proj.dtype} / {w_hh.dtype} not supported "
                        "(float32 or bfloat16, the same for proj and w_hh)")
    if w_hh.dim() != 3 or w_hh.shape[0] != 2 or w_hh.shape[1] != 4 * w_hh.shape[2] \
            or proj.dim() != 3 or proj.shape[2] != 8 * w_hh.shape[2] \
            or proj.shape[0] < 1 or proj.shape[1] < 1 \
            or lengths.dtype != torch.int32 or tuple(lengths.shape) != proj.shape[:1]:
        raise ValueError(f"{name}: expected proj [B, steps, 8H], w_hh [2, 4H, H] and "
                         f"int32 lengths [B], got {tuple(proj.shape)}, "
                         f"{tuple(w_hh.shape)}, {lengths.dtype} {tuple(lengths.shape)}")
    if not (proj.is_contiguous() and w_hh.is_contiguous() and lengths.is_contiguous()):
        raise ValueError(f"{name}: proj, w_hh and lengths must be contiguous")
    for t in (proj, w_hh, lengths):
        if t.device.type != "cuda":
            raise ValueError(f"{name}: the kernel takes CUDA tensors, got {t.device}")
    if not proj.device == w_hh.device == lengths.device:
        raise ValueError(f"{name}: proj, w_hh and lengths on different cards")


def lstm(proj: torch.Tensor, w_hh: torch.Tensor, lengths: torch.Tensor,
         save: bool = False):
    """One layer's recurrence, both directions, every step, in one launch.

    proj [B, steps, 8H]: the input projection plus bias of each position,
    direction d's gates (i, f, g, o) at d * 4H, the reverse direction's at
    the positions of the forward input (the kernel reads each row's valid
    prefix reversed); w_hh [2, 4H, H] in proj's dtype; lengths int32 [B], each
    1..steps (not checked: that would synchronise).  `steps` is an upper
    bound: each cluster runs to the longest length among its rows, read on
    the card, and zeroes its outputs past it.  Returns (out [B, steps, 2H],
    zero past each length; h, c [2, B, H]; and with `save` the gate
    activations [2, steps, B, 4H] and c [2, steps, B, H] of every step for
    `lstm_bwd`, else None, None)."""
    name = "lstm"
    _check_lstm(name, proj, w_hh, lengths)
    b, steps, _ = proj.shape
    hid = w_hh.shape[2]
    plan = lstm_plan(b, hid, proj.dtype)
    new = lambda *shape: torch.empty(shape, dtype=proj.dtype, device=proj.device)
    out, h, c = new(b, steps, 2 * hid), new(2, b, hid), new(2, b, hid)
    acts, cs = (new(2, steps, b, 4 * hid), new(2, steps, b, hid)) if save else (None, None)
    _run(name, _lib().dwc_lstm, proj.device, proj.data_ptr(), w_hh.data_ptr(),
         lengths.data_ptr(), out.data_ptr(), h.data_ptr(), c.data_ptr(), _ptr(acts),
         _ptr(cs), b, steps, hid, _DTYPE_CODE[proj.dtype], plan.k, plan.units,
         plan.rows)
    return out, h, c, acts, cs


def lstm_bwd(w_hh: torch.Tensor, lengths: torch.Tensor, acts: torch.Tensor,
             cs: torch.Tensor, d_out=None, d_h=None, d_c=None) -> torch.Tensor:
    """The gradient of `lstm`'s proj, [B, steps, 8H] (zero past each
    length; like `lstm`, each cluster runs to its rows' longest length),
    from the forward's w_hh, lengths and saved acts and cs, and the
    gradients of its outputs (each None for zero)."""
    name = "lstm_bwd"
    _, steps, b, g4 = acts.shape
    hid = g4 // 4
    dproj = acts.new_empty((b, steps, 8 * hid))
    _check_lstm(name, dproj, w_hh, lengths)
    want = {"acts": (acts, (2, steps, b, 4 * hid)), "cs": (cs, (2, steps, b, hid)),
            "d_out": (d_out, (b, steps, 2 * hid)), "d_h": (d_h, (2, b, hid)),
            "d_c": (d_c, (2, b, hid))}
    for key, (t, shape) in want.items():
        if t is not None and (tuple(t.shape) != shape or t.dtype != acts.dtype
                              or t.device != acts.device or not t.is_contiguous()):
            raise ValueError(f"{name}: {key} must be contiguous {acts.dtype} {shape} "
                             f"on {acts.device}, got {t.dtype} {tuple(t.shape)}")
    plan = lstm_plan(b, hid, acts.dtype)
    _run(name, _lib().dwc_lstm_bwd, acts.device, w_hh.data_ptr(), lengths.data_ptr(),
         acts.data_ptr(), cs.data_ptr(), _ptr(d_out), _ptr(d_h), _ptr(d_c),
         dproj.data_ptr(), b, steps, hid, _DTYPE_CODE[acts.dtype], plan.k,
         plan.units, plan.rows)
    return dproj


def lstm_barriers(k: int, steps: int, device=None) -> None:
    """`steps` cluster barriers of one cluster of k blocks and nothing else:
    the recurrence's sequential floor, for a measurement (not counted)."""
    device = torch.device("cuda") if device is None else torch.device(device)
    _run("lstm_barriers", _lib().dwc_lstm_barriers, device, k, steps, count=False)
