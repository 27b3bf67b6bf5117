"""`norm_compute: bf16` in the port against the JAX package on the CPU.

JAX (dwcgan_tpu/ops/norms.py:53-81, 101-150) runs the instance norm's and
AdaIN's normalise chain in the activation dtype when the mode is bf16 and
x is not fp32, each op rounded; the statistics stay fp32.  The port's plain
versions (`ops/norms.py`, `arith="bf16"`) compute the same function, and
the blocks, models, step and sampler take the mode from `cfg.norm_compute`
(`set_norm_compute`), per module rather than as JAX's process global.

Tolerances and why:

- the plain forwards (instance norm, with and without its fused ReLU,
  AdaIN and the residual form `x + AdaIN(y)`) bit-equal to the jitted JAX
  functions in bf16 mode, both stats modes, three shapes: the same
  roundings at the same points;
- the backwards (the port's autograd against `jax.vjp`): each gradient's
  relative L2 distance from JAX bf16 within JAX's own distance between its
  fp32 and bf16 modes on the same input, plus 2.5e-3 (the slack of
  `test_torch_block_options.py::test_step_metrics_match_jax_bf16`).  They
  cannot be bit-equal: JAX's CPU backend sums each reduction of the VJP
  (d mean, d rstd, d scale, d bias) serially in bf16, the port accumulates
  in fp32 and rounds once (`tests/test_torch_bias_grad_order.py`, F9's
  rule);
- the bf16 step with `norm_compute: bf16` on `configs/smoke.yaml` held
  against the JAX step as `test_step_metrics_match_jax_bf16` holds the
  fp32-arithmetic step: every metric no farther from JAX's than JAX's
  fp32 step is, plus 2.5e-3 (5e-3 for the gradient norms), the losses'
  summed relative difference within 3/4 of JAX's own summed gap;
- serving (`make_infer_fn`) in bf16 with the mode on, against JAX's at the
  tolerance of the fp32-arithmetic bf16 serving check below, measured in
  the same test: the port's largest difference from JAX with the mode on
  within twice its largest with the mode off (the content encoder's IN
  ResBlocks amplify 1-ulp summation-order differences of the convolutions
  in both), and the mode visibly changes the output on both sides;
- fp32 activations with the mode on: bit-equal to the mode off, forward
  and backward, as JAX's `_low_precision` ignores fp32.

JAX's modes are process globals: the `jax_modes` fixture restores
`set_compute_mode("fp32")` and `set_stats_mode("2pass")` after every test,
so that a later test file on the same worker sees the defaults.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwcgan_tpu.config import load_config as jax_load_config
from dwcgan_tpu.data.pipeline import synthetic_batch as jax_synthetic_batch
from dwcgan_tpu.models.generator import Generator as JaxGenerator
from dwcgan_tpu.ops import norms as jnorms
from dwcgan_tpu.text.vocab import Vocab as JaxVocab, encode_commands
from dwcgan_tpu.train.sampler import make_infer_fn as jax_make_infer_fn
from dwcgan_tpu.train.state import build_models, create_train_state, make_optimizer
from dwcgan_tpu.train.step import make_train_step as jax_make_train_step
from dwcgan_tpu_torch.config import load_config
from dwcgan_tpu_torch.data.pipeline import synthetic_batch, to_device
from dwcgan_tpu_torch.interop.jax_params import load_jax_dis_params, load_jax_params
from dwcgan_tpu_torch.models.generator import build_generator
from dwcgan_tpu_torch.ops import norms
from dwcgan_tpu_torch.train.sampler import make_infer_fn
from dwcgan_tpu_torch.train.state import create_train_state as port_create_state
from dwcgan_tpu_torch.train.step import make_train_step

torch.set_num_threads(1)

CONFIG = "configs/smoke.yaml"
BATCH, VOCAB = 2, 102
SHAPES = [(2, 16, 16, 8), (3, 8, 8, 32), (1, 7, 5, 24)]   # NHWC
OPS = ["in", "in_relu", "adain", "residual"]
BF16_RTOL = 2.5e-3
GRAD_NORMS = ("grad_gen_norm", "grad_dis_norm")
LOSS_SHARE = 0.75
SERVE_FACTOR = 2.0
# the JAX steps compile at LLVM's lowest optimisation level, the same XLA
# program (as `test_torch_block_options.py`)
FAST_COMPILE = {"xla_backend_optimization_level": 0}


@pytest.fixture(autouse=True)
def jax_modes():
    yield
    jnorms.set_compute_mode("fp32")
    jnorms.set_stats_mode("2pass")


def _inputs(shape, seed):
    """x with per-(n, c) offsets and spreads, a residual, AdaIN's scale
    and bias, an incoming gradient: numpy fp32 (x, g NHWC)."""
    rng = np.random.default_rng(seed)
    n, _, _, c = shape
    x = (rng.standard_normal(shape) * rng.uniform(0.5, 2.0, (n, 1, 1, c))
         + rng.standard_normal((n, 1, 1, c))).astype(np.float32)
    res = rng.standard_normal(shape).astype(np.float32)
    scale = (1 + 0.3 * rng.standard_normal((n, c))).astype(np.float32)
    bias = (0.3 * rng.standard_normal((n, c))).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    return x, res, scale, bias, g


def _jax_fn(op):
    if op == "in":
        return lambda x, r, s, b: jnorms.instance_norm(x)
    if op == "in_relu":
        return lambda x, r, s, b: jax.nn.relu(jnorms.instance_norm(x))
    if op == "adain":
        return lambda x, r, s, b: jnorms.adain(x, s, b)
    return lambda x, r, s, b: r + jnorms.adain(x, s, b)


def _port(op, x, r, s, b, stats, arith, plain=False):
    if op in ("in", "in_relu"):
        f = norms.instance_norm_plain if plain else norms.instance_norm
        return f(x, relu=op == "in_relu", stats=stats, arith=arith)
    if op == "adain":
        f = norms.adain_plain if plain else norms.adain
        return f(x, s, b, stats=stats, arith=arith)
    f = norms.adain_residual_plain if plain else norms.adain_residual
    return f(r, x, s, b, stats=stats, arith=arith)


def _nchw(a, dtype=torch.bfloat16):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2))).to(dtype)


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _jax(op, stats, mode, arrays):
    """The jitted JAX op in bf16 (its inputs rounded to bf16) under `mode`:
    (output, its VJP at g for x, the residual, scale and bias)."""
    x, res, scale, bias, g = arrays
    jnorms.set_stats_mode(stats)
    jnorms.set_compute_mode(mode)
    args = [jnp.asarray(a, jnp.bfloat16) for a in (x, res, scale, bias)]
    y, vjp = jax.vjp(jax.jit(_jax_fn(op)), *args)
    grads = vjp(jnp.asarray(g, jnp.bfloat16))
    return np.asarray(y, np.float32), [np.asarray(v, np.float32) for v in grads]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("stats", ["2pass", "1pass"])
@pytest.mark.parametrize("op", OPS)
def test_plain_forward_bit_equal_to_jax_bf16_mode(op, stats, shape):
    arrays = _inputs(shape, 0)
    want, _ = _jax(op, stats, "bf16", arrays)
    x, res, scale, bias, _ = arrays
    got = _port(op, _nchw(x), _nchw(res), torch.from_numpy(scale).bfloat16(),
                torch.from_numpy(bias).bfloat16(), stats, "bf16", plain=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_nhwc(got), want)
    # the public op (the autograd Function) computes the same on the CPU
    again = _port(op, _nchw(x), _nchw(res), torch.from_numpy(scale).bfloat16(),
                  torch.from_numpy(bias).bfloat16(), stats, "bf16")
    assert torch.equal(again, got)


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("stats", ["2pass", "1pass"])
@pytest.mark.parametrize("op", OPS)
def test_backward_within_jax_gap(op, stats, shape):
    arrays = _inputs(shape, 1)
    _, want = _jax(op, stats, "bf16", arrays)
    _, w32 = _jax(op, stats, "fp32", arrays)
    x, res, scale, bias, g = arrays
    leaves = [_nchw(x).requires_grad_(), _nchw(res).requires_grad_(),
              torch.from_numpy(scale).bfloat16().requires_grad_(),
              torch.from_numpy(bias).bfloat16().requires_grad_()]
    _port(op, *leaves, stats, "bf16").backward(_nchw(g))
    used = {"in": [0], "in_relu": [0], "adain": [0, 2, 3], "residual": [0, 1, 2, 3]}[op]
    for i in used:
        got = leaves[i].grad
        got = _nhwc(got) if got.dim() == 4 else got.float().numpy()
        gap = _rel(w32[i], want[i])
        assert _rel(got, want[i]) <= gap + BF16_RTOL, (i, _rel(got, want[i]), gap)


@pytest.mark.parametrize("op", OPS)
def test_fp32_activations_ignore_the_mode(op):
    x, res, scale, bias, g = _inputs((2, 8, 8, 16), 2)
    outs = []
    for arith in ("fp32", "bf16"):
        leaves = [_nchw(x, torch.float32).requires_grad_(),
                  _nchw(res, torch.float32).requires_grad_(),
                  torch.from_numpy(scale).requires_grad_(),
                  torch.from_numpy(bias).requires_grad_()]
        y = _port(op, *leaves, "2pass", arith)
        y.backward(_nchw(g, torch.float32))
        outs.append([y.detach()] + [t.grad for t in leaves if t.grad is not None])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_low_precision_rule():
    bf, f32 = torch.zeros(1, dtype=torch.bfloat16), torch.zeros(1)
    assert norms.low_precision(bf, "bf16") and not norms.low_precision(f32, "bf16")
    assert not norms.low_precision(bf, "fp32")
    with pytest.raises(ValueError, match="arith"):
        norms.instance_norm(bf.reshape(1, 1, 1, 1), arith="fp16")


# ------------------------------------------------------------- the step

def _cfgs(dtype, mode):
    jc, tc = jax_load_config(CONFIG), load_config(CONFIG)
    for c in (jc, tc):
        c.batch_size, c.compute_dtype, c.norm_compute = BATCH, dtype, mode
    return jc, tc


def _draws(rng, n, k, c):
    """The normal draws of JAX step 0 (its key discipline)."""
    key = jax.random.fold_in(rng, 0)
    _, k_g = jax.random.split(key)
    keys = jax.random.split(k_g, 8)
    as_t = lambda kk: torch.from_numpy(np.array(jax.random.normal(kk, (n, k, c))))
    return {"style1": as_t(keys[3]), "style2": as_t(keys[4])}


@pytest.fixture(scope="module")
def steps():
    """Step 0 of the shared step (VGG off, dropout off): JAX in fp32, JAX
    in bf16 with `norm_compute: bf16`, the port in bf16 with it, from the
    same parameters and draws."""
    jc, _ = _cfgs("float32", "fp32")
    state0 = create_train_state(jc, jax.random.PRNGKey(0), VOCAB)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    p_gen, p_dis = np_tree(state0.gen_params), np_tree(state0.dis_params)
    batch = jax_synthetic_batch(BATCH, 32, 8, jc.max_text_len, seed=3)
    out = {}
    for name, dtype, mode in (("jax32", "float32", "fp32"),
                              ("jax", "bfloat16", "bf16")):
        jcfg, _ = _cfgs(dtype, mode)
        gen, dis = build_models(jcfg, VOCAB)
        gen_tx = make_optimizer(jcfg, state0.gen_params)
        dis_tx = make_optimizer(jcfg, state0.dis_params)
        state = state0.replace(gen_opt_state=gen_tx.init(state0.gen_params),
                               dis_opt_state=dis_tx.init(state0.dis_params))
        try:
            fn = jax.jit(jax_make_train_step(jcfg, gen, dis, gen_tx, dis_tx,
                                             _deterministic=True))
            fn = fn.lower(state, batch).compile(FAST_COMPILE)
            _, m = fn(state, batch)
        finally:
            jnorms.set_compute_mode("fp32")
            jnorms.set_stats_mode("2pass")
        out[name] = {k: float(v) for k, v in m.items()}
    _, tcfg = _cfgs("bfloat16", "bf16")
    ts = port_create_state(tcfg, VOCAB, device="cpu")
    for mod in (ts.gen, ts.ema_gen):
        load_jax_params(mod, p_gen)
    for mod in (ts.dis, ts.ema_dis):
        load_jax_dis_params(mod, p_dis)
    step = make_train_step(tcfg, ts.gen, ts.dis, ts.gen_opt, ts.dis_opt,
                           _deterministic=True)
    b = to_device(synthetic_batch(BATCH, 32, 8, tcfg.max_text_len, seed=3), "cpu")
    arith = {m.arith for m in ts.gen.modules() if hasattr(m, "arith")}
    got = step(ts, b, draws=_draws(state0.rng, BATCH, 8, tcfg.c_dim))
    out["port"] = {k: float(v) for k, v in got.items()}
    out["arith"] = arith
    return out


def test_step_metrics_match_jax_norm_compute_bf16(steps):
    w32, want, got = steps["jax32"], steps["jax"], steps["port"]
    assert steps["arith"] == {"bf16"}
    assert sorted(got) == sorted(want)
    keys = [k for k in want if want[k] != 0]
    assert all(got[k] == 0.0 for k in want if want[k] == 0)
    rel = {k: abs(got[k] - want[k]) / abs(want[k]) for k in keys}
    jgap = {k: abs(w32[k] - want[k]) / abs(want[k]) for k in keys}
    for k in keys:
        slack = BF16_RTOL * (2 if k in GRAD_NORMS else 1)
        assert rel[k] <= jgap[k] + slack, (k, rel[k], jgap[k])
    losses = [k for k in keys if k not in GRAD_NORMS]
    share = sum(rel[k] for k in losses) / sum(jgap[k] for k in losses)
    assert share <= LOSS_SHARE, (share, rel, jgap)


# ------------------------------------------------------------- serving

def test_serving_matches_jax_make_infer_fn():
    cfg = jax_load_config(CONFIG)
    cfg.compute_dtype = "bfloat16"
    vocab = JaxVocab(cfg.dataset)
    gen = JaxGenerator(cfg=cfg.gen, input_dim=cfg.input_dim,
                       vocab_size=vocab.size, dtype=jnp.bfloat16, use_pallas=False)
    rng = np.random.default_rng(5)
    images = rng.uniform(-1, 1, (3, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    params = jax.jit(gen.init)({"params": jax.random.PRNGKey(1),
                                "dropout": jax.random.PRNGKey(2)},
                               jnp.zeros((1,) + images.shape[1:]))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    ids, lens = encode_commands(["make her smile", "add eyeglasses",
                                 "remove the beard"], vocab, cfg.max_text_len)
    outs = {}
    for mode in ("fp32", "bf16"):
        cfg.norm_compute = mode
        want = np.asarray(jax.jit(jax_make_infer_fn(cfg, gen))(params, images, ids, lens),
                          np.float32)
        tcfg = load_config(CONFIG)
        tcfg.compute_dtype, tcfg.norm_compute = "bfloat16", mode
        port = build_generator(tcfg, vocab.size, device="cpu")
        load_jax_params(port, params)
        got = make_infer_fn(tcfg, port)(torch.from_numpy(images),
                                        torch.from_numpy(ids).long(),
                                        torch.from_numpy(lens).long())
        outs[mode] = (got.float().numpy(), want)
    err = {m: float(np.abs(g - w).max()) for m, (g, w) in outs.items()}
    moved = {side: float(np.abs(outs["bf16"][side] - outs["fp32"][side]).max())
             for side in (0, 1)}
    print(f"serving: port vs JAX max abs diff, mode off {err['fp32']:.3e}, "
          f"on {err['bf16']:.3e}; the mode moves the output by {moved}")
    assert np.isfinite(outs["bf16"][0]).all()
    assert err["bf16"] <= SERVE_FACTOR * max(err["fp32"], 2.0 ** -8), err
    assert moved[0] > 0 and moved[1] > 0


@pytest.mark.parametrize("op", OPS)
def test_chain_from_given_statistics_is_the_plain_forward(op):
    """`bf16_chain_plain`, the oracle the card's kernels are held to bit for
    bit at their own statistics, fed the plain version's statistics, is
    the plain bf16-arithmetic forward."""
    x, res, scale, bias, _ = _inputs((2, 6, 5, 16), 3)
    xt, rt = _nchw(x), _nchw(res)
    st, sb = torch.from_numpy(scale).bfloat16(), torch.from_numpy(bias).bfloat16()
    for stats in ("2pass", "1pass"):
        mean, var = norms._moments_hw(xt.float(), stats)
        given = torch.stack([mean.flatten(1), torch.rsqrt(var + norms.EPS).flatten(1)], 1)
        affine = (None, None) if op.startswith("in") else (st, sb)
        got = norms.bf16_chain_plain(xt, given, *affine, relu=op == "in_relu",
                                     residual=rt if op == "residual" else None)
        assert torch.equal(got, _port(op, xt, rt, st, sb, stats, "bf16", plain=True))
