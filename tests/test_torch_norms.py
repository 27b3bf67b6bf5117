"""The port's norm ops, padding and upsampling against the JAX package.

Plain PyTorch norms (`dwcgan_tpu_torch.ops.norms`) are held against the jnp
versions (`dwcgan_tpu.ops.norms`) in both stats modes, and against the
Pallas kernels run in interpret mode (2pass, the only mode those kernels
have).  Inputs are numpy draws fed to both sides; fp32 on the CPU, atol 1e-5
(the two differ only in summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwcgan_tpu.ops import blocks as jblocks
from dwcgan_tpu.ops import norms as jnorms
from dwcgan_tpu.ops.pallas import norm_kernels as jpallas
from dwcgan_tpu.ops.resize import upsample2x as j_upsample2x
from dwcgan_tpu_torch.ops import norms
from dwcgan_tpu_torch.ops.blocks import pad2d
from dwcgan_tpu_torch.ops.cuda import kernels
from dwcgan_tpu_torch.ops.resize import upsample2x

torch.set_num_threads(1)

N, H, W, C = 2, 8, 8, 16
ATOL = 1e-5
# (op, fused relu)
CASES = [("instance_norm", False), ("instance_norm", True), ("adain", False),
         ("adain", True), ("adain_residual", False), ("layer_norm_ref", False)]


@pytest.fixture(autouse=True)
def _restore_jax_stats_mode():
    yield
    jnorms.set_stats_mode("2pass")


def _inputs(op, seed):
    """NHWC activations (with per-channel offsets) and fp32 parameters."""
    rng = np.random.default_rng(seed)
    act = lambda: (rng.normal(size=(N, H, W, C)) * rng.uniform(0.5, 2.0, C)
                   + rng.normal(size=C)).astype(np.float32)
    if op == "instance_norm":
        return (act(),)
    if op == "adain":
        return (act(), rng.normal(1.0, 0.3, (N, C)).astype(np.float32),
                rng.normal(0.0, 0.3, (N, C)).astype(np.float32))
    if op == "adain_residual":
        return (act(), act(), rng.normal(1.0, 0.3, (N, C)).astype(np.float32),
                rng.normal(0.0, 0.3, (N, C)).astype(np.float32))
    return (act(), rng.uniform(0, 1, C).astype(np.float32),
            rng.normal(0, 0.3, C).astype(np.float32))


def _to_port(a):
    """NHWC numpy -> NCHW tensor in channels_last memory; params as-is."""
    t = torch.from_numpy(a)
    return t.permute(0, 3, 1, 2) if t.dim() == 4 else t


def _from_port(t):
    return t.permute(0, 2, 3, 1).numpy()


def _port(op, args, relu, stats, fn_table):
    a = [_to_port(x) for x in args]
    if op in ("instance_norm", "adain"):
        return _from_port(fn_table[op](*a, relu=relu, stats=stats))
    return _from_port(fn_table[op](*a, stats=stats))


PLAIN = {"instance_norm": norms.instance_norm_plain, "adain": norms.adain_plain,
         "adain_residual": norms.adain_residual_plain,
         "layer_norm_ref": norms.layer_norm_ref_plain}
PUBLIC = {"instance_norm": norms.instance_norm, "adain": norms.adain,
          "adain_residual": norms.adain_residual,
          "layer_norm_ref": norms.layer_norm_ref}


def _jnp(op, args, relu):
    a = [jnp.asarray(x) for x in args]
    if op == "instance_norm":
        y = jnorms.instance_norm(*a)
    elif op == "adain":
        y = jnorms.adain(*a)
    elif op == "adain_residual":
        x, yy, s, b = a
        y = x + jnorms.adain(yy, s, b)
    else:
        y = jnorms.layer_norm_ref(*a)
    return np.asarray(jax.nn.relu(y) if relu else y)


def _pallas(op, args, relu):
    a = [jnp.asarray(x) for x in args]
    if op == "instance_norm":
        y = jpallas.instance_norm_pallas(*a)
        y = jax.nn.relu(y) if relu else y
    elif op == "adain":
        y = jpallas.adain_pallas(*a, relu)
    elif op == "adain_residual":
        y = jpallas.adain_residual_pallas(*a)
    else:
        y = jpallas.layer_norm_ref_pallas(*a)
    return np.asarray(y)


@pytest.mark.parametrize("stats", ["2pass", "1pass"])
@pytest.mark.parametrize("op,relu", CASES)
def test_plain_norm_matches_jnp(op, relu, stats):
    args = _inputs(op, 0)
    jnorms.set_stats_mode(stats)
    ref = _jnp(op, args, relu)
    np.testing.assert_allclose(_port(op, args, relu, stats, PLAIN), ref,
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("op,relu", CASES)
def test_plain_norm_matches_pallas_interpret(op, relu):
    args = _inputs(op, 1)
    ref = _pallas(op, args, relu)
    np.testing.assert_allclose(_port(op, args, relu, "2pass", PLAIN), ref,
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("op,relu", CASES)
def test_public_op_on_cpu_is_the_plain_version(op, relu):
    """A CPU tensor goes to the plain version and launches no kernel."""
    args = _inputs(op, 2)
    before = dict(kernels.LAUNCHES)
    got = _port(op, args, relu, "1pass", PUBLIC)
    assert kernels.LAUNCHES == before
    np.testing.assert_array_equal(got, _port(op, args, relu, "1pass", PLAIN))


def test_layer_norm_ref_uses_unbiased_std_plus_eps():
    """(x - mean) / (std_unbiased + eps), not / sqrt(var + eps)."""
    x = np.random.default_rng(3).normal(size=(1, 2, 2, 1)).astype(np.float32)
    one = np.ones(1, np.float32)
    zero = np.zeros(1, np.float32)
    got = _port("layer_norm_ref", (x, one, zero), False, "2pass", PLAIN)
    want = (x - x.mean()) / (x.std(ddof=1) + 1e-5)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_bf16_input_keeps_dtype_and_fp32_stats():
    x = _inputs("instance_norm", 4)[0]
    xb = _to_port(x).to(torch.bfloat16)
    y = norms.instance_norm(xb, stats="2pass")
    assert y.dtype == torch.bfloat16
    ref = norms.instance_norm_plain(xb.float(), stats="2pass")
    assert float((y.float() - ref).abs().max()) <= 2 ** -7 * float(ref.abs().max())


def test_unknown_stats_mode_raises():
    x = _to_port(_inputs("instance_norm", 5)[0])
    with pytest.raises(ValueError):
        norms.instance_norm(x, stats="3pass")


@pytest.mark.parametrize("op", ["instance_norm", "adain", "adain_residual",
                                "layer_norm_ref"])
def test_kernel_wrappers_refuse_cpu_tensors(op):
    """The wrappers take CUDA tensors only; they never run the plain code."""
    args = [_to_port(a).contiguous(memory_format=torch.channels_last)
            if a.ndim == 4 else _to_port(a) for a in _inputs(op, 6)]
    fn = getattr(kernels, op)
    with pytest.raises(ValueError, match="CUDA"):
        fn(*args)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_upsample2x_matches_jax(dtype):
    x = np.random.default_rng(7).normal(size=(2, 5, 6, 3)).astype(np.float32)
    if dtype == "bfloat16":
        ref = np.asarray(j_upsample2x(jnp.asarray(x, jnp.bfloat16)), np.float32)
        got = upsample2x(_to_port(x).to(torch.bfloat16)).float()
    else:
        ref = np.asarray(j_upsample2x(jnp.asarray(x)))
        got = upsample2x(_to_port(x))
    assert got.shape == (2, 3, 10, 12)
    np.testing.assert_allclose(_from_port(got), ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("padding", [1, 3])
@pytest.mark.parametrize("pad_type", ["reflect", "replicate", "zero"])
def test_pad2d_matches_jax(pad_type, padding):
    x = np.random.default_rng(8).normal(size=(2, 7, 6, 3)).astype(np.float32)
    ref = np.asarray(jblocks.pad2d(jnp.asarray(x), padding, pad_type))
    np.testing.assert_array_equal(_from_port(pad2d(_to_port(x), padding,
                                                   pad_type)), ref)
