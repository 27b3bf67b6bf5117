"""The instance-norm and AdaIN backward kernel's plan and its ReLU mask
rule, on the CPU.

`kernels.bwd_plan` lays out one call of the cluster kernel: k blocks per
sample, each owning a slab of rows and keeping the first `resident` of them
in shared memory.  At every training-step site of rows 5 and 6 and at
ragged shapes (one sample, 7 x 9 pixels, fewer pixels than blocks, 8 and 16
channels), in fp32 and bf16: the slabs partition the rows exactly, each
block's resident and streamed rows make up its slab, and the block's shared
memory (the layout of `bwd_smem` in csrc/norm_kernels.cu) stays within half
an SM's 228 KB, so that two blocks share each SM.

The kernel takes a fused ReLU's mask from x, not from the output: the
forward's value before the ReLU, rounded to the activation dtype, > 0.
`norms.relu_mask_plain` is that rule in plain form; it equals y > 0 of the
plain forward for the instance norm and AdaIN, in both dtypes and both
stats modes, and so does the rule applied to the forward kernel's own
order of fp32 operations (`normed`, then `affine`'s fused multiply-add).
"""

import numpy as np
import pytest
import torch

from dwcgan_tpu_torch.ops import norms
from dwcgan_tpu_torch.ops.cuda import kernels

torch.set_num_threads(1)

SMEM_HALF = 115712   # half an SM's 228 KB less a block's reserved 1 KB
THREADS = 256

# (n, c, h, w) of the instance-norm and AdaIN backward sites of one training
# step at batch 16 (chip_smoke.py's BWD_SITES): encode at n and 3n, VGG,
# decode at 4n and the cycle at n
STEP_SITES = [(b, c, hw, hw) for b in (16, 48)
              for c, hw in ((64, 128), (128, 64), (256, 32))] + [
    (16, 512, 16, 16), (64, 256, 32, 32)]
RAGGED = [(1, 64, 12, 12), (2, 16, 7, 9), (3, 8, 1, 5), (1, 8, 2, 3),
          (2, 16, 1, 1), (1, 256, 5, 7)]
DTYPES = [torch.float32, torch.bfloat16]


def _layout_bytes(c, resident, dtype):
    """Shared memory of one block: x and g of the resident rows, the lane
    partial sums, the block's and the cluster's sums, four mbarriers."""
    size, vec = (4, 4) if dtype == torch.float32 else (2, 8)
    return 2 * resident * c * size + 2 * THREADS * vec * 4 + 4 * c * 4 + 4 * 8


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", STEP_SITES + RAGGED)
def test_plan_partitions_each_sample(shape, dtype):
    n, c, h, w = shape
    hw = h * w
    plan = kernels.bwd_plan(n, hw, c, dtype)
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
    # as many rows resident as fit in half an SM (two blocks share each SM)
    assert plan.smem == _layout_bytes(c, plan.resident, dtype) <= SMEM_HALF
    if plan.resident < plan.rows:
        assert _layout_bytes(c, plan.resident + 1, dtype) > SMEM_HALF


def test_plan_resident_share_at_the_step_sites():
    """bf16: the VGG site keeps its whole slab; 256 channels of 32 x 32 keep
    92 of 128 rows, 128 of 64 x 64 189 of 512, 64 of 128 x 128 383 of
    2048."""
    want = {(512, 16): 32, (256, 32): 92, (128, 64): 189, (64, 128): 383}
    for n, c, h, w in STEP_SITES:
        plan = kernels.bwd_plan(n, h * w, c, torch.bfloat16)
        assert plan.k == 8 and plan.rows == h * w // 8
        assert plan.resident == want[c, h], (n, c, h, w, plan)


@pytest.mark.parametrize("n,hw,c,dtype", [
    (0, 16, 64, torch.float32), (2, 0, 64, torch.float32),
    (2, 16, 12, torch.bfloat16), (2, 16, 4096, torch.bfloat16),
    (2, 16, 64, torch.float16), (70000, 16, 64, torch.float32)])
def test_plan_refuses_what_the_kernel_cannot_take(n, hw, c, dtype):
    with pytest.raises((ValueError, TypeError)):
        kernels.bwd_plan(n, hw, c, dtype)


def _kernel_order(x, scale, bias, stats):
    """The forward kernel's value before its ReLU, in its order of fp32
    operations: the statistics as the kernel forms them from the sums, then
    `normed` (x - mean, rounded, times the factor, rounded) and `affine`
    (one fused multiply-add: the exact product plus the bias, rounded once;
    float64 holds the product exactly)."""
    x32 = x.float()
    hw = x.shape[2] * x.shape[3]
    mean = x32.sum(dim=(2, 3), keepdim=True) / hw
    if stats == "1pass":
        var = torch.clamp(x32.square().sum(dim=(2, 3), keepdim=True) / hw
                          - mean * mean, min=0.0)
    else:
        var = (x32 - mean).square().sum(dim=(2, 3), keepdim=True) / hw
    t = (x32 - mean) * (1 / torch.sqrt(var + norms.EPS))
    if scale is None:
        return t
    return (t.double() * scale.double()[:, :, None, None]
            + bias.double()[:, :, None, None]).float()


@pytest.mark.parametrize("order", ["plain", "kernel"])
@pytest.mark.parametrize("stats", ["2pass", "1pass"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", ["instance_norm", "adain"])
def test_relu_mask_from_x_is_y_positive(op, dtype, stats, order):
    """The mask rule against the plain forward's y > 0 and against y > 0 of
    the forward in the kernel's order of `normed` and `affine` (the ReLU of
    that value, rounded to the dtype, as the kernel stores it)."""
    rng = np.random.default_rng(0)
    n, c, h, w = 3, 16, 9, 7
    x = rng.standard_normal((n, c, h, w)) * rng.uniform(0.5, 2, (n, c, 1, 1)) \
        + rng.standard_normal((n, c, 1, 1))
    x = torch.from_numpy(x.astype(np.float32)).to(dtype)
    scale = bias = None
    if op == "adain":
        scale = torch.from_numpy((1 + 0.5 * rng.standard_normal((n, c))).astype(np.float32))
        bias = torch.from_numpy((0.3 * rng.standard_normal((n, c))).astype(np.float32))
    if order == "kernel":
        t = _kernel_order(x, scale, bias, stats)
        y = torch.clamp(t, min=0.0).to(dtype)
        mask = t.to(dtype) > 0
    elif op == "instance_norm":
        y = norms.instance_norm_plain(x, relu=True, stats=stats)
        mask = norms.relu_mask_plain(x, stats=stats)
    else:
        y = norms.adain_plain(x, scale, bias, relu=True, stats=stats)
        mask = norms.relu_mask_plain(x, scale, bias, stats=stats)
    assert mask.dtype == torch.bool and mask.shape == x.shape
    assert 0.2 < float(mask.float().mean()) < 0.8     # both sides of zero
    assert torch.equal(mask, y > 0)
