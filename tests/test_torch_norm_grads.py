"""Gradients of the port's norm ops against `jax.vjp` of the JAX package.

The same numpy inputs and the same cotangent go through:

- the port's public ops on CPU tensors (the `torch.autograd.Function`s,
  whose CPU backward is the plain `*_bwd_plain` formula), via
  `torch.autograd.grad`;
- `jax.vjp` of the jnp norms (`dwcgan_tpu/ops/norms.py`), in both stats
  modes;
- `jax.vjp` of the Pallas kernels in interpret mode
  (`dwcgan_tpu/ops/pallas/norm_kernels.py`), whose custom VJPs run the
  backward kernels `_in_bwd_kernel`, `_adain_bwd_kernel`, `_ln_bwd_kernel`
  (2pass, the only mode they have).

fp32 on the CPU; every gradient within 1e-4 of its largest magnitude (the
two sides differ in summation order only).  `gradcheck` holds the plain
backward against finite differences in float64, and the card's kernels are
held against the same plain backward in `test_torch_cuda_kernels.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwcgan_tpu.ops import norms as jnorms
from dwcgan_tpu.ops.pallas import norm_kernels as jpallas
from dwcgan_tpu_torch.ops import norms
from dwcgan_tpu_torch.ops.cuda import kernels

torch.set_num_threads(1)

N, H, W, C = 2, 6, 5, 8
REL = 1e-4
CASES = [("instance_norm", False), ("instance_norm", True), ("adain", False),
         ("adain", True), ("adain_residual", False), ("layer_norm_ref", False)]


@pytest.fixture(autouse=True)
def _restore_jax_stats_mode():
    yield
    jnorms.set_stats_mode("2pass")


def _inputs(op, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    act = lambda: (rng.normal(size=(N, H, W, C)) * rng.uniform(0.5, 2.0, C)
                   + rng.normal(size=C)).astype(dtype)
    vec = lambda loc, *s: rng.normal(loc, 0.3, s).astype(dtype)
    if op == "instance_norm":
        args = (act(),)
    elif op == "adain":
        args = (act(), vec(1.0, N, C), vec(0.0, N, C))
    elif op == "adain_residual":
        args = (act(), act(), vec(1.0, N, C), vec(0.0, N, C))
    else:
        args = (act(), rng.uniform(0.2, 1.0, C).astype(dtype), vec(0.0, C))
    return args, rng.normal(size=(N, H, W, C)).astype(dtype)


def _jax_fn(op, relu, pallas):
    if pallas:
        fns = {"instance_norm": lambda x: jpallas.instance_norm_pallas(x),
               "adain": lambda x, s, b: jpallas.adain_pallas(x, s, b, relu),
               "adain_residual": jpallas.adain_residual_pallas,
               "layer_norm_ref": jpallas.layer_norm_ref_pallas}
        f = fns[op]
        if op == "instance_norm" and relu:
            return lambda x: jax.nn.relu(f(x))
        return f
    fns = {"instance_norm": jnorms.instance_norm, "adain": jnorms.adain,
           "adain_residual": lambda x, y, s, b: x + jnorms.adain(y, s, b),
           "layer_norm_ref": jnorms.layer_norm_ref}
    f = fns[op]
    return (lambda *a: jax.nn.relu(f(*a))) if relu else f


def _jax_grads(op, relu, stats, args, g, pallas=False):
    jnorms.set_stats_mode(stats)
    out, vjp = jax.vjp(_jax_fn(op, relu, pallas), *map(jnp.asarray, args))
    return [np.asarray(t) for t in vjp(jnp.asarray(g))]


def _nchw(a):
    t = torch.from_numpy(a)
    return t.permute(0, 3, 1, 2) if t.dim() == 4 else t


def _port_grads(op, relu, stats, args, g):
    ts = [_nchw(a).clone().requires_grad_() for a in args]
    kw = {"relu": relu} if op in ("instance_norm", "adain") else {}
    out = getattr(norms, op)(*ts, stats=stats, **kw)
    grads = torch.autograd.grad(out, ts, _nchw(g))
    return [gr.permute(0, 2, 3, 1).numpy() if gr.dim() == 4 else gr.numpy()
            for gr in grads]


def _close(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        scale = float(np.abs(b).max())
        np.testing.assert_allclose(a, b, atol=REL * scale, rtol=0)


@pytest.mark.parametrize("stats", ["2pass", "1pass"])
@pytest.mark.parametrize("op,relu", CASES)
def test_grads_match_jnp_vjp(op, relu, stats):
    args, g = _inputs(op, 0)
    _close(_port_grads(op, relu, stats, args, g),
           _jax_grads(op, relu, stats, args, g))


@pytest.mark.parametrize("op,relu", CASES)
def test_grads_match_pallas_backward_kernels(op, relu):
    args, g = _inputs(op, 1)
    _close(_port_grads(op, relu, "2pass", args, g),
           _jax_grads(op, relu, "2pass", args, g, pallas=True))


@pytest.mark.parametrize("stats", ["2pass", "1pass"])
@pytest.mark.parametrize("op,relu", CASES)
def test_plain_backward_passes_gradcheck_in_float64(op, relu, stats):
    args, _ = _inputs(op, 2, np.float64)
    ts = tuple(_nchw(a).clone().requires_grad_() for a in args)
    kw = {"relu": relu} if op in ("instance_norm", "adain") else {}
    fn = lambda *a: getattr(norms, op)(*a, stats=stats, **kw)
    assert torch.autograd.gradcheck(fn, ts, eps=1e-6, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("op,relu", CASES)
def test_cpu_backward_launches_no_kernel(op, relu):
    args, g = _inputs(op, 3)
    before = dict(kernels.LAUNCHES)
    _port_grads(op, relu, "1pass", args, g)
    assert kernels.LAUNCHES == before


def test_the_backward_is_differentiable_once():
    """AdaIN's backward, which only the generator runs, is differentiable
    once; the instance norm's is differentiable once more, for the
    penalties through a discriminator with a norm (ROADMAP F10;
    `tests/test_torch_norm_penalty.py` holds it against JAX)."""
    x, scale, bias = (_nchw(a).clone().requires_grad_()
                      for a in _inputs("adain", 4)[0])
    (gx,) = torch.autograd.grad(norms.adain(x, scale, bias).square().sum(), x,
                                create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable|differentiable"):
        gx.sum().backward()
    x = _nchw(_inputs("instance_norm", 4)[0][0]).clone().requires_grad_()
    (gx,) = torch.autograd.grad(norms.instance_norm(x).square().sum(), x,
                                create_graph=True)
    gx.square().sum().backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())
