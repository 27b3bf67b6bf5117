"""The port's fused 7x7 stem (`ops/stem.py`, its plain route on the CPU)
against the JAX `stem_conv7` (dwcgan_tpu/ops/pallas/stem_kernels.py), which
runs in Pallas interpret mode here.

fp32, N = 2, 16 x 16, C = 8, inputs from a numpy seed.  Forward within atol
2e-5 and dx, dW, db within atol 5e-5 (the tolerances of
tests/test_stem_kernels.py, which holds the JAX kernel against its jnp
reference); the padding adjoint alone against `_unpad_grad` exactly up to
fp32 summation order; `stem_applicable` against JAX's on a grid; one bf16
case within 2 bf16 ulps of the JAX kernel.  The JAX weight is HWIO, the
port's OIHW: w_oihw = w_hwio.transpose(3, 2, 0, 1).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwcgan_tpu.ops.pallas import stem_kernels as jstem
from dwcgan_tpu_torch.ops import stem
from dwcgan_tpu_torch.ops.blocks import Conv2dBlock

torch.set_num_threads(1)

N, H, W, C = 2, 16, 16, 8
FWD_ATOL = 2e-5
GRAD_ATOL = 5e-5


def _inputs(seed, c=C):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, H, W, 3)).astype(np.float32)
    w = (rng.normal(size=(7, 7, 3, c)) * 0.2).astype(np.float32)   # HWIO
    b = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    ct = rng.normal(size=(N, H, W, c)).astype(np.float32)
    return x, w, b, ct


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("norm,act,pad_type", [
    ("in", "relu", "reflect"),      # ContentEncoder stem
    ("none", "relu", "reflect"),    # StyleEncoder stem
    ("in", "relu", "zero"),
    ("none", "none", "replicate"),
    ("in", "none", "replicate"),
])
def test_forward_matches_jax(norm, act, pad_type):
    x, w, b, _ = _inputs(0)
    want = np.asarray(jstem.stem_conv7(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(b), norm, act, pad_type))
    got = stem.stem_conv7(torch.from_numpy(x), _oihw(w), torch.from_numpy(b),
                          norm, act, pad_type)
    assert tuple(got.shape) == (N, H, W, C) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=FWD_ATOL, rtol=0)


@pytest.mark.parametrize("norm,act,pad_type", [
    ("in", "relu", "reflect"),
    ("none", "relu", "zero"),
    ("in", "none", "replicate"),
    ("none", "relu", "reflect"),
])
def test_gradients_match_jax(norm, act, pad_type):
    x, w, b, ct = _inputs(1)

    def loss(x, w, b):
        return jnp.sum(jstem.stem_conv7(x, w, b, norm, act, pad_type) * ct)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w),
                                            jnp.asarray(b))
    xt = torch.from_numpy(x).requires_grad_()
    wt = _oihw(w).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    y = stem.stem_conv7(xt, wt, bt, norm, act, pad_type)
    (y * torch.from_numpy(ct)).sum().backward()
    got = (xt.grad.numpy(), wt.grad.numpy().transpose(2, 3, 1, 0), bt.grad.numpy())
    for name, g, w_ in zip(("dx", "dw", "db"), got, want):
        np.testing.assert_allclose(g, np.asarray(w_), atol=GRAD_ATOL, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("pad_type", stem.PAD_TYPES)
def test_padding_adjoint_matches_jax(pad_type):
    rng = np.random.default_rng(2)
    dxp = rng.normal(size=(N, 3, H + 6, W + 6)).astype(np.float32)
    want = np.asarray(jstem._unpad_grad(jnp.asarray(dxp), pad_type))
    got = stem.unpad_grad(torch.from_numpy(dxp), pad_type).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("pad_type", stem.PAD_TYPES)
def test_padding_adjoint_is_the_adjoint(pad_type):
    """<pad(x), d> == <x, unpad_grad(d)> for the port's own pad."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(N, 3, H, W)))
    d = torch.from_numpy(rng.normal(size=(N, 3, H + 6, W + 6)))
    lhs = float((stem._pad(x, pad_type) * d).sum())
    rhs = float((x * stem.unpad_grad(d, pad_type)).sum())
    assert abs(lhs - rhs) < 1e-9 * max(1.0, abs(lhs))


def test_stem_applicable_matches_jax():
    grid = itertools.product((3, 4, 7), (1, 2), (1, 3), (3, 8),
                             ("in", "none", "ln", "adain"),
                             ("relu", "none", "lrelu"))
    for args in grid:
        assert stem.stem_applicable(*args) == jstem.stem_applicable(*args), args


@pytest.mark.parametrize("norm", ["in", "none"])
def test_conv2dblock_stem_matches_the_plain_block(norm):
    """Conv2dBlock(stem=True) against the same block without it, on the
    same parameters (the plain block's norm in 1pass, the stem's mode)."""
    x, _, _, _ = _inputs(4)
    plain = Conv2dBlock(3, C, 7, 1, 3, norm, "relu", "reflect")
    plain.stats = "1pass"
    fused = Conv2dBlock(3, C, 7, 1, 3, norm, "relu", "reflect", stem=True)
    fused.load_state_dict(plain.state_dict())
    assert fused.stem and not plain.stem
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad():
        want, got = plain(xt), fused(xt)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=FWD_ATOL, rtol=0)


def test_conv2dblock_stem_flag_ignored_where_not_applicable():
    blk = Conv2dBlock(8, 8, 7, 1, 3, "in", "relu", "reflect", stem=True)
    assert not blk.stem   # 8 input channels: not a stem


def test_no_dx_work_without_an_image_gradient(monkeypatch):
    x, w, b, ct = _inputs(5)

    def no_dx(*args):
        raise AssertionError("dX computed for an image that needs no gradient")

    monkeypatch.setattr(stem, "_dx_plain", no_dx)
    wt = _oihw(w).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    xt = torch.from_numpy(x)
    y = stem.stem_conv7(xt, wt, bt, "in", "relu", "reflect")
    (y * torch.from_numpy(ct)).sum().backward()
    assert xt.grad is None and wt.grad is not None and bt.grad is not None
    dx, dw, db = stem.stem_conv7_bwd_plain(xt, wt.detach(), bt.detach(),
                                           torch.from_numpy(ct),
                                           need_dx=False)
    assert dx is None
    torch.testing.assert_close(dw, wt.grad, rtol=0, atol=0)


def test_stats_modes_agree_in_fp32():
    """1pass and 2pass differ only by rounding at these well-scaled inputs."""
    x, w, b, _ = _inputs(6)
    args = (torch.from_numpy(x), _oihw(w), torch.from_numpy(b), "in", "relu",
            "reflect")
    one = stem.stem_conv7_plain(*args, stats="1pass")
    two = stem.stem_conv7_plain(*args, stats="2pass")
    np.testing.assert_allclose(one.numpy(), two.numpy(), atol=1e-5, rtol=0)


def _bf16_ulp(r):
    """Spacing of bf16 values at each element of the fp32 array r."""
    _, e = np.frexp(np.abs(r))
    return np.where(r == 0, 0.0, np.ldexp(1.0, e - 8))


def test_bf16_forward_within_two_ulps_of_jax():
    x, w, b, _ = _inputs(7)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jstem.stem_conv7(xb, jnp.asarray(w, jnp.bfloat16),
                                       jnp.asarray(b), "in", "relu",
                                       "reflect"), np.float32)
    got = stem.stem_conv7(torch.from_numpy(x).bfloat16(), _oihw(w),
                          torch.from_numpy(b), "in", "relu", "reflect")
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.all(np.abs(got - want) <= 2 * _bf16_ulp(want) + 1e-6)
