"""The reference LayerNorm's cluster kernels (rows 4 and 7), on the CPU.

The forward runs the instance norm's cluster layout, `kernels.fwd_plan`;
the backward its own, `kernels.ln_bwd_plan`: k blocks per sample (up to 16,
Hopper's non-portable cluster size), each owning a slab of rows and keeping
the first `resident` of them (of x and g) in shared memory.  At every
serving and training-step site of the LayerNorm and at ragged shapes (one
sample, rows not a multiple of the blocks, fewer pixels than blocks, c 8
in bf16 and c 4 in fp32), in fp32 and bf16: the slabs partition the rows,
each block's resident and streamed rows make up its slab, and the block's
shared memory (the layouts of `fwd_smem` and `bwd_smem` in
csrc/norm_kernels.cu) fits the share of an SM's 228 KB that the plan's
blocks per SM leave it.  Shapes the kernels cannot take raise.

The kernels form the per-sample statistics, and the backward's scalars A
and B, as sums over the channels of per-channel sums, and dgamma and dbeta
as sums over the samples of per-sample channel sums.  In float64 that
order gives the plain versions' values (`norms.layer_norm_ref_plain`,
`norms.layer_norm_ref_bwd_plain`) to 1e-12.
"""

import numpy as np
import pytest
import torch

from dwcgan_tpu_torch.ops import norms
from dwcgan_tpu_torch.ops.cuda import kernels

torch.set_num_threads(1)

SMEM_SM = 233472   # an SM's 228 KB; the card reserves 1 KB of it per block
THREADS = 256

# (n, c, h, w) of the LayerNorm's sites: one served batch of 32
# (chip_smoke.py's SITES) and one training step at batch 16 (its BWD_SITES:
# decode at 4n, the cycle at n)
SERVE_SITES = [(32, 128, 64, 64), (32, 64, 128, 128)]
STEP_SITES = [(b, c, hw, hw) for b in (64, 16) for c, hw in ((128, 64), (64, 128))]
RAGGED = [(1, 8, 7, 9), (2, 8, 33, 3), (3, 8, 1, 5), (2, 16, 1, 1), (1, 64, 13, 11)]
DTYPES = [torch.float32, torch.bfloat16]
CASES = [(s, d) for s in SERVE_SITES + STEP_SITES + RAGGED for d in DTYPES] + [
    ((3, 4, 5, 7), torch.float32)]   # c 4: one 16-byte group of fp32
# the layouts chip_smoke.sweep_ln_plans tries: (blocks per SM, blocks per sample)
FWD_LAYOUTS = [(p, k) for p in (1, 2) for k in (4, 6, 8)]
BWD_LAYOUTS = [(p, k) for p in (1, 2) for k in (4, 6, 8, 12, 16)]


def _layout_bytes(c, resident, dtype, staged, fixed_floats):
    """Shared memory of one block: the staged tensors' resident rows, the
    lane partial sums, `fixed_floats` * c floats of sums, four mbarriers."""
    size, vec = (4, 4) if dtype == torch.float32 else (2, 8)
    return staged * resident * c * size + 2 * THREADS * vec * 4 + fixed_floats * c * 4 + 4 * 8


def _check_plan(plan, n, c, hw, dtype, staged, fixed_floats, budget, k):
    assert plan.k == min(k, hw)
    slabs = kernels.cluster_slabs(hw, plan.k)
    assert len(slabs) == plan.k and slabs[0][0] == 0 and slabs[-1][1] == hw
    assert all(a < b for a, b in slabs)                     # none empty
    assert all(slabs[i][1] == slabs[i + 1][0] for i in range(plan.k - 1))
    assert plan.rows == max(b - a for a, b in slabs) == -(-hw // plan.k)
    for a, b in slabs:
        resident = min(plan.resident, b - a)
        assert resident >= 1 and resident + (b - a - resident) == b - a
    assert plan.smem == _layout_bytes(c, plan.resident, dtype, staged, fixed_floats) <= budget
    if plan.resident < plan.rows:
        assert _layout_bytes(c, plan.resident + 1, dtype, staged, fixed_floats) > budget


@pytest.mark.parametrize("per_sm,k", [(None, 6)] + FWD_LAYOUTS)
@pytest.mark.parametrize("shape,dtype", CASES)
def test_forward_plan_partitions_and_fits(shape, dtype, per_sm, k):
    """The forward stages x beside 5 * c floats (three sums, the two
    statistics), a block up to a whole SM by default."""
    n, c, h, w = shape
    plan = kernels.fwd_plan(n, h * w, c, dtype, per_sm=per_sm, k=None if per_sm is None else k)
    budget = SMEM_SM // (per_sm or 1) - 1024
    _check_plan(plan, n, c, h * w, dtype, 1, 5, budget, k)


@pytest.mark.parametrize("per_sm,k", [(None, 16)] + BWD_LAYOUTS)
@pytest.mark.parametrize("shape,dtype", CASES)
def test_backward_plan_partitions_and_fits(shape, dtype, per_sm, k):
    """The backward stages x and g beside 4 * c floats (the block's and
    the cluster's sums), 16 blocks of half an SM by default."""
    n, c, h, w = shape
    plan = kernels.ln_bwd_plan(n, h * w, c, dtype, per_sm=per_sm,
                               k=None if per_sm is None else k)
    budget = SMEM_SM // (per_sm or 2) - 1024
    _check_plan(plan, n, c, h * w, dtype, 2, 4, budget, k)


def test_backward_plan_resident_share_at_the_step_sites():
    """bf16, the default plan (16 blocks of half an SM): 128 channels of 64
    x 64 keep 189 of 256 rows, 64 of 128 x 128 383 of 1024; 8 blocks (rows
    5-6's layout) keep as many of twice the rows; 16 blocks of a whole SM
    keep all 256 rows of the first and 839 of 1024 of the second."""
    for n, c, h, w in STEP_SITES:
        plan = kernels.ln_bwd_plan(n, h * w, c, torch.bfloat16)
        assert (plan.k, plan.rows, plan.resident) == {
            128: (16, 256, 189), 64: (16, 1024, 383)}[c], plan
        assert kernels.ln_bwd_plan(n, h * w, c, torch.bfloat16, k=8).resident \
            == kernels.bwd_plan(n, h * w, c, torch.bfloat16).resident == plan.resident
        wide = kernels.ln_bwd_plan(n, h * w, c, torch.bfloat16, per_sm=1, k=16)
        assert (wide.k, wide.rows) == (16, h * w // 16)
        assert wide.resident == {128: 256, 64: 839}[c], wide


def test_backward_plan_caps_its_cluster_at_16():
    assert kernels.ln_bwd_plan(2, 4096, 64, torch.bfloat16, k=32).k == 16
    assert kernels.fwd_plan(2, 4096, 64, torch.bfloat16, k=16).k == 8


@pytest.mark.parametrize("plan", [kernels.fwd_plan, kernels.ln_bwd_plan])
@pytest.mark.parametrize("n,hw,c,dtype", [
    (0, 16, 64, torch.float32),        # no sample
    (2, 0, 64, torch.float32),         # no pixel
    (2, 16, 12, torch.bfloat16),       # c not a multiple of 8 bf16 values
    (2, 16, 6, torch.float32),         # nor of 4 fp32 values
    (2, 16, 2056, torch.bfloat16),     # 257 channel groups of 8
    (2, 16, 64, torch.float16),        # no half kernel
    (70000, 16, 64, torch.float32)])   # beyond the grid's second dimension
def test_plans_refuse_what_the_kernels_cannot_take(plan, n, hw, c, dtype):
    with pytest.raises((ValueError, TypeError)):
        plan(n, hw, c, dtype)


def _inputs(seed, shape=(3, 12, 5, 7)):
    rng = np.random.default_rng(seed)
    n, c = shape[:2]
    x = rng.normal(size=shape) * rng.uniform(0.5, 2.0, (1, c, 1, 1)) \
        + rng.normal(size=(1, c, 1, 1))
    gamma, beta = rng.uniform(0.2, 1.0, c), rng.normal(0.0, 0.3, c)
    return (torch.from_numpy(a) for a in (x, gamma, beta, rng.normal(size=shape)))


@pytest.mark.parametrize("stats", ["2pass", "1pass"])
def test_statistics_from_channel_sums(stats):
    """The forward's statistics as the kernel forms them: per-channel sums
    of x and x^2 (2pass: of (x - mean)^2), summed over the channels, then
    mean = s / m, var = ... / (m - 1), factor = 1 / (std + eps)."""
    x, gamma, beta, _ = _inputs(0)
    m = x[0].numel()
    mean = x.sum(dim=(2, 3)).sum(dim=1) / m
    if stats == "1pass":
        var = torch.clamp(x.square().sum(dim=(2, 3)).sum(dim=1) - m * mean * mean,
                          min=0) / (m - 1)
    else:
        var = (x - mean[:, None, None, None]).square().sum(dim=(2, 3)).sum(dim=1) / (m - 1)
    fac = 1 / (var.sqrt() + norms.EPS)
    y = (x - mean[:, None, None, None]) * fac[:, None, None, None] \
        * gamma[None, :, None, None] + beta[None, :, None, None]
    torch.testing.assert_close(y, norms.layer_norm_ref_plain(x, gamma, beta, stats),
                               rtol=0, atol=1e-12)


def test_backward_from_channel_sums():
    """The backward as the kernel forms it: per (sample, channel) sums of g
    and g * xh; A = sum_c gamma_c sum g, B = sum_c gamma_c sum g xh; dx =
    (gamma_c g - A / m) f - (x - mean) B / ((m - 1) s d); dgamma and dbeta
    the per-sample channel sums summed over the samples in order."""
    x, gamma, _, g = _inputs(1)
    m = x[0].numel()
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    std = ((x - mean).square().sum(dim=(1, 2, 3), keepdim=True) / (m - 1)).sqrt()
    d = std + norms.EPS
    f = 1 / d
    xh = (x - mean) * f
    sum_g, sum_gxh = g.sum(dim=(2, 3)), (g * xh).sum(dim=(2, 3))        # [n, c]
    a = (gamma * sum_g).sum(dim=1)[:, None, None, None]
    b = (gamma * sum_gxh).sum(dim=1)[:, None, None, None]
    dx = (gamma[None, :, None, None] * g - a / m) * f - (x - mean) * b / ((m - 1) * std * d)
    dgamma, dbeta = torch.zeros_like(gamma), torch.zeros_like(gamma)
    for q in range(x.shape[0]):
        dgamma, dbeta = dgamma + sum_gxh[q], dbeta + sum_g[q]
    for got, want in zip((dx, dgamma, dbeta),
                         norms.layer_norm_ref_bwd_plain(x, gamma, g, "2pass")):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
