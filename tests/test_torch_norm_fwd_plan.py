"""The instance-norm and AdaIN forward kernel's plan, on the CPU.

`kernels.fwd_plan` lays out one call of the cluster forward (rows 1-3 of
the port's kernel table): k blocks per sample, each owning a slab of rows
and keeping the first `resident` of them (of x alone) in shared memory.
At every serving and training-step site of rows 1-3 and at ragged shapes
(one sample, 7 x 9 pixels, fewer pixels than blocks, 8 and 16 channels), in
fp32 and bf16: the slabs partition the rows exactly, each block's resident
and streamed rows make up its slab, and the block's shared memory (the
layout of `fwd_smem` in csrc/norm_kernels.cu) stays within the share of an
SM's 228 KB that the plan's blocks-per-SM choice leaves it.  Shapes the
kernel cannot take raise.
"""

import pytest
import torch

from dwcgan_tpu_torch.ops.cuda import kernels

torch.set_num_threads(1)

SMEM_SM = 233472   # an SM's 228 KB; the card reserves 1 KB of it per block
THREADS = 256

# (n, c, h, w) of rows 1-3 of one served batch of 32 (chip_smoke.py's
# SITES) and of one training step at batch 16 (its BWD_SITES: encode at n
# and 3n, VGG, decode at 4n and the cycle at n)
SERVE_SITES = [(32, 64, 128, 128), (32, 128, 64, 64), (32, 256, 32, 32)]
STEP_SITES = [(b, c, hw, hw) for b in (16, 48)
              for c, hw in ((64, 128), (128, 64), (256, 32))] + [
    (16, 512, 16, 16), (64, 256, 32, 32)]
RAGGED = [(1, 64, 12, 12), (2, 16, 7, 9), (3, 8, 1, 5), (1, 8, 2, 3),
          (2, 16, 1, 1), (1, 256, 5, 7), (70, 512, 3, 3)]
DTYPES = [torch.float32, torch.bfloat16]


def _layout_bytes(c, resident, dtype):
    """Shared memory of one block: x of the resident rows, the lane partial
    sums, the block's three sums and the two statistics, four mbarriers."""
    size, vec = (4, 4) if dtype == torch.float32 else (2, 8)
    return resident * c * size + 2 * THREADS * vec * 4 + 5 * c * 4 + 4 * 8


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SERVE_SITES + STEP_SITES + RAGGED)
def test_plan_partitions_each_sample(shape, dtype):
    n, c, h, w = shape
    hw = h * w
    plan = kernels.fwd_plan(n, hw, c, dtype)
    assert 1 <= plan.k <= min(8, hw)
    slabs = kernels.cluster_slabs(hw, plan.k)
    assert len(slabs) == plan.k and slabs[0][0] == 0 and slabs[-1][1] == hw
    assert all(a < b for a, b in slabs)                     # none empty
    assert all(slabs[i][1] == slabs[i + 1][0] for i in range(plan.k - 1))
    assert plan.rows == max(b - a for a, b in slabs) == -(-hw // plan.k)
    for a, b in slabs:
        resident = min(plan.resident, b - a)
        streamed = b - a - resident
        assert resident >= 1 and streamed >= 0 and resident + streamed == b - a


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SERVE_SITES + STEP_SITES + RAGGED)
def test_plan_fits_its_share_of_an_sm(shape, dtype):
    """The block's shared memory is the layout of `fwd_smem` and fits a
    whole SM's share (227 KB, the most a block can have); it keeps as many
    rows as fit there, so that a small slab takes only what it needs."""
    n, c, h, w = shape
    budget = SMEM_SM - 1024
    assert kernels.smem_budget(1) == budget == 232448
    plan = kernels.fwd_plan(n, h * w, c, dtype)
    assert plan.k == min(6, h * w)
    assert plan.smem == _layout_bytes(c, plan.resident, dtype) <= budget
    if plan.resident < plan.rows:
        assert _layout_bytes(c, plan.resident + 1, dtype) > budget


def test_plan_at_the_serving_sites():
    """bf16 at the serving batch: [32, 256, 32, 32] keeps its whole slab
    of 171 rows in 109 KB, so two blocks share an SM; [32, 128, 64, 64]
    keeps all its 683 rows; [32, 64, 128, 128] 1677 of 2731."""
    want = {(256, 32): (171, 171), (128, 64): (683, 683), (64, 128): (2731, 1677)}
    for n, c, h, w in SERVE_SITES:
        plan = kernels.fwd_plan(n, h * w, c, torch.bfloat16)
        assert (plan.rows, plan.resident) == want[c, h], (c, h, plan)
    assert kernels.fwd_plan(32, 1024, 256, torch.bfloat16).smem <= kernels.smem_budget(2)


def test_plan_keeps_about_twice_the_backward_rows():
    """It stages x alone, so a block holds about twice the rows that a
    backward block (x and g) holds in the same bytes (less its larger
    fixed part: the statistics and the centred sums)."""
    for n, c, h, w in SERVE_SITES + STEP_SITES:
        for dtype in DTYPES:
            fwd = kernels.fwd_plan(n, h * w, c, dtype, per_sm=2, k=8)
            bwd = kernels.bwd_plan(n, h * w, c, dtype)
            assert fwd.k == bwd.k == 8
            assert fwd.resident == fwd.rows or fwd.resident >= 1.9 * bwd.resident


@pytest.mark.parametrize("n,hw,c,dtype", [
    (0, 16, 64, torch.float32),        # no sample
    (2, 0, 64, torch.float32),         # no pixel
    (2, 16, 12, torch.bfloat16),       # c not a multiple of 8 bf16 values
    (2, 16, 6, torch.float32),         # nor of 4 fp32 values
    (2, 16, 2056, torch.bfloat16),     # 257 channel groups of 8
    (2, 16, 1028, torch.float32),      # 257 channel groups of 4
    (2, 16, 64, torch.float16),        # no half kernel
    (70000, 16, 64, torch.float32)])   # beyond the grid's second dimension
def test_plan_refuses_what_the_kernel_cannot_take(n, hw, c, dtype):
    with pytest.raises((ValueError, TypeError)):
        kernels.fwd_plan(n, hw, c, dtype)
