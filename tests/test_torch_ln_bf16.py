"""The reference LayerNorm's plain versions in bf16 against the JAX package.

`norms.layer_norm_ref_plain` and `norms.layer_norm_ref_bwd_plain` (the CPU
path, and the oracle of the card's LayerNorm kernels) against
`dwcgan_tpu.ops.norms.layer_norm_ref` and its `jax.vjp`, on the same bf16
numpy inputs, in both stats modes.  Both sides take their statistics in
fp32 over up to 131 k elements, summed in different orders, so a value near
a bf16 rounding boundary may land on the neighbouring bf16 value:

- y and dx within 1 bf16 ulp of the JAX value plus ATOL at every element,
  and apart at under 1 % of the elements (0.41 % at most measured).  ATOL
  covers values near zero: the fp32 "1pass" variance, sum x^2 - m mean^2,
  loses digits to cancellation, and the JAX side's summation order moves
  such a value by up to 1.7e-5 from a float64 evaluation (22 of its ulps);
- the port's y is correctly rounded: within half a bf16 ulp of a float64
  evaluation of the same formula, plus 1e-6;
- dgamma and dbeta (fp32, summed over the batch) within a relative 1e-4 of
  each gradient's largest magnitude (8e-6 measured).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwcgan_tpu.ops import norms as jnorms
from dwcgan_tpu_torch.ops import norms

torch.set_num_threads(1)

SHAPES = [(3, 16, 16, 32), (2, 32, 32, 64)]   # NHWC
SHARE = 0.01   # of the elements that may sit one ulp apart
ATOL = 2e-5
REL = 1e-4


@pytest.fixture(autouse=True)
def _restore_jax_stats_mode():
    yield
    jnorms.set_stats_mode("2pass")


def _inputs(shape, seed):
    """bf16 activations with per-channel offsets, fp32 gamma and beta, a
    bf16 cotangent; numpy, NHWC."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    bf16 = lambda a: np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16))
    x = bf16(rng.normal(size=shape) * rng.uniform(0.5, 2.0, c) + rng.normal(size=c))
    gamma = rng.uniform(0.2, 1.0, c).astype(np.float32)
    beta = rng.normal(0.0, 0.3, c).astype(np.float32)
    return x, gamma, beta, bf16(rng.normal(size=shape))


def _port(a):
    """NHWC bf16 numpy -> NCHW torch bf16 (channels_last memory)."""
    t = torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    return t.permute(0, 3, 1, 2)


def _ulp(r):
    """Spacing of bf16 values at each element of the bf16 values `r` (fp32)."""
    _, e = np.frexp(np.abs(r))
    return np.where(r == 0, 0.0, np.ldexp(1.0, e - 8))


def _assert_within_one_ulp(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    err = np.abs(got - want)
    assert np.all(err <= _ulp(want) + ATOL), float(err.max())
    assert float(np.mean(err > 0)) < SHARE, float(np.mean(err > 0))


@pytest.mark.parametrize("stats", ["2pass", "1pass"])
@pytest.mark.parametrize("shape", SHAPES)
def test_layer_norm_ref_bf16_forward_matches_jax(shape, stats):
    x, gamma, beta, _ = _inputs(shape, 0)
    jnorms.set_stats_mode(stats)
    want = jnorms.layer_norm_ref(jnp.asarray(x, jnp.bfloat16), jnp.asarray(gamma),
                                 jnp.asarray(beta))
    got = norms.layer_norm_ref_plain(_port(x), torch.from_numpy(gamma),
                                     torch.from_numpy(beta), stats=stats)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    got = got.float().permute(0, 2, 3, 1).numpy()
    _assert_within_one_ulp(got, np.asarray(want.astype(jnp.float32)))
    exact = norms.layer_norm_ref_plain(
        _port(x).double(), torch.from_numpy(gamma).double(),
        torch.from_numpy(beta).double(), stats=stats).permute(0, 2, 3, 1).numpy()
    assert np.all(np.abs(got - exact) <= _ulp(got) / 2 + 1e-6)


@pytest.mark.parametrize("stats", ["2pass", "1pass"])
@pytest.mark.parametrize("shape", SHAPES)
def test_layer_norm_ref_bf16_backward_matches_jax_vjp(shape, stats):
    x, gamma, beta, g = _inputs(shape, 1)
    jnorms.set_stats_mode(stats)
    _, vjp = jax.vjp(jnorms.layer_norm_ref, jnp.asarray(x, jnp.bfloat16),
                     jnp.asarray(gamma), jnp.asarray(beta))
    jdx, jdgamma, jdbeta = vjp(jnp.asarray(g, jnp.bfloat16))
    dx, dgamma, dbeta = norms.layer_norm_ref_bwd_plain(
        _port(x), torch.from_numpy(gamma), _port(g), stats=stats)
    assert dx.dtype == torch.bfloat16 and jdx.dtype == jnp.bfloat16
    _assert_within_one_ulp(dx.float().permute(0, 2, 3, 1).numpy(),
                           np.asarray(jdx.astype(jnp.float32)))
    for got, want in ((dgamma, jdgamma), (dbeta, jdbeta)):
        want = np.asarray(want)
        err = float(np.abs(got.numpy() - want).max())
        assert err <= REL * float(np.abs(want).max()), err
