"""One training step of the port against `make_train_step(...,
_deterministic=True)` of the JAX package.

`configs/smoke.yaml` widths, 32 px, fp32, batch 2, on the CPU.  The JAX
state is made once (module fixture); its parameters go into the port's
generator, discriminator and EMA copies.  Both sides get the same numpy
batch and the same style draws (the port's step takes the normal draws JAX
made from its step keys).  Variants:

- the flagship's shared forward with VGG off, attention gate closed
  (step 0 < attention_warm_iter), 2pass norms;
- VGG on, attention gate open (attention_warm_iter 0), 1pass norms, and a
  frozen word embedding (the pretrained-table case);
- the non-shared step with n_critic 2, two steps: D alone, then D and G.

Tolerances and why:

- every metric within rtol 1e-4 (fp32 on both sides; only summation order
  and conv algorithms differ; measured agreement is about 1e-5);
- Adam's first moments (the gradients, (1 - beta1) (g + wd p)) per
  parameter within 5e-3 of the leaf's L2 norm, plus 1e-6 of the largest
  moment anywhere: ReLU masks and L1 signs flip where a pre-activation is
  zero within rounding, and the conv biases in front of an instance norm
  have a true gradient of zero, so theirs is rounding noise on both sides;
- the updated parameters within 1e-6, except where Adam's first step,
  about lr * sign(g), takes the sign of such a noise-level gradient: there
  up to 2 lr, on at most 1 % of the elements; EMA copies within 1e-6.

One more step, the shared one, in bf16 on both sides (`compute_dtype:
bfloat16`, one extra JAX compile).  The JAX step's metrics in fp32 and in
bf16 differ by 8.19e-4 relative on average (up to 3.2e-3); a port step that
computed in fp32 would be exactly that far from the bf16 reference.  The
port cannot be bit-equal: the content encoder's IN ResBlocks at 8 x 8 turn
a 1-ulp difference of one convolution's summation order into up to 0.03 in
the content code, and the JAX step itself moves its `grad_gen_norm` by
2.3e-3 between two XLA rewrites of the same convolutions (`parity_convs`
"head" and "all").  Measured port vs JAX: 2.54e-4 on average, 1.8e-3 at
most.  So: the mean within half the gap, every metric within rtol 2.5e-3,
and each discriminator leaf's Adam first moment within 5 % (relative L2;
measured 2.6 %, the JAX fp32/bf16 gap 15.5 %: a discriminator that rounds
elsewhere, as the port's LeakyReLU once did, is 16 % off).
"""

import jax
import numpy as np
import optax
import pytest
import torch

from dwcgan_tpu.config import load_config as jax_load_config
from dwcgan_tpu.data.pipeline import synthetic_batch as jax_synthetic_batch
from dwcgan_tpu.interop.torch_import import (convert_reference_discriminator,
                                             convert_reference_generator)
from dwcgan_tpu.models.vgg import init_random_vgg, make_vgg_loss_fn as jax_vgg_loss
from dwcgan_tpu.ops import norms as jnorms
from dwcgan_tpu.train.state import build_models, create_train_state, make_optimizer
from dwcgan_tpu.train.step import make_train_step as jax_make_train_step
from dwcgan_tpu_torch.config import load_config
from dwcgan_tpu_torch.data.pipeline import synthetic_batch, to_device
from dwcgan_tpu_torch.interop.jax_params import (flatten_params, jax_vgg_to_state_dict,
                                                 load_jax_dis_params, load_jax_params)
from dwcgan_tpu_torch.models.vgg import Vgg16Features, make_vgg_loss_fn
from dwcgan_tpu_torch.train.state import create_train_state as port_create_state
from dwcgan_tpu_torch.train.step import make_train_step

torch.set_num_threads(1)

CONFIG = "configs/smoke.yaml"
BATCH, VOCAB = 2, 102
METRIC_RTOL = 1e-4
MOMENT_REL, MOMENT_FLOOR = 5e-3, 1e-6
PARAM_ATOL, FLIP_SHARE = 1e-6, 0.01
BF16_GAP_MEAN = 8.19e-4     # mean relative metric gap, JAX fp32 vs bf16 step
BF16_MEAN_SHARE = 0.5
BF16_METRIC_RTOL = 2.5e-3
BF16_DIS_MOMENT_REL = 0.05
VARIANTS = {
    "shared": dict(),
    "shared_vgg_att_1pass_frozen": dict(vgg_w=0.1, attention_warm_iter=0,
                                        norm_stats="1pass", frozen=True),
    "n_critic2": dict(n_critic=2, steps=2),
}


def _cfgs(over):
    jc, tc = jax_load_config(CONFIG), load_config(CONFIG)
    for c in (jc, tc):
        c.batch_size = BATCH
        for k in ("vgg_w", "attention_warm_iter", "norm_stats", "n_critic"):
            if k in over:
                setattr(c, k, over[k])
    return jc, tc


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _adam_mu(opt_state):
    found = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    return flatten_params(_np(found[0].mu))


def _draws(rng, step, n, k, c):
    """The normal draws of the JAX step `step` (its key discipline)."""
    key = jax.random.fold_in(rng, step)
    k_d, k_g = jax.random.split(key)
    keys = jax.random.split(k_g, 8)
    d_sty = jax.random.split(k_d, 4)[2]
    as_t = lambda kk: torch.from_numpy(np.array(jax.random.normal(kk, (n, k, c))))
    return {"style1": as_t(keys[3]), "style2": as_t(keys[4]), "d_style1": as_t(d_sty)}


@pytest.fixture(scope="module")
def jax_init():
    cfg, _ = _cfgs({})
    state = create_train_state(cfg, jax.random.PRNGKey(0), VOCAB)
    return state, _np(init_random_vgg(0))


@pytest.fixture(scope="module", params=list(VARIANTS))
def run(request, jax_init):
    over = VARIANTS[request.param]
    jcfg, tcfg = _cfgs(over)
    state0, vgg_vars = jax_init
    frozen = over.get("frozen", False)
    gen, dis = build_models(jcfg, VOCAB)
    gen_tx = make_optimizer(jcfg, state0.gen_params, freeze_embedding=frozen)
    dis_tx = make_optimizer(jcfg, state0.dis_params)
    state = state0.replace(gen_opt_state=gen_tx.init(state0.gen_params),
                           dis_opt_state=dis_tx.init(state0.dis_params))
    use_vgg = jcfg.vgg_w > 0
    steps = over.get("steps", 1)
    batches = [jax_synthetic_batch(BATCH, 32, 8, jcfg.max_text_len, seed=3 + i)
               for i in range(steps)]
    p_gen, p_dis = _np(state.gen_params), _np(state.dis_params)
    try:
        fn = jax.jit(jax_make_train_step(
            jcfg, gen, dis, gen_tx, dis_tx, _deterministic=True,
            vgg_loss_fn=jax_vgg_loss(vgg_vars) if use_vgg else None))
        jax_metrics = []
        for b in batches:
            state, m = fn(state, b)
            jax_metrics.append({k: float(v) for k, v in m.items()})
    finally:
        jnorms.set_stats_mode("2pass")

    embed = p_gen["enc_txt"]["embedding"] if frozen else None
    ts = port_create_state(tcfg, VOCAB, device="cpu", embed_table=embed)
    for m in (ts.gen, ts.ema_gen):
        load_jax_params(m, p_gen)
    for m in (ts.dis, ts.ema_dis):
        load_jax_dis_params(m, p_dis)
    vgg = None
    if use_vgg:
        net = Vgg16Features()
        net.load_state_dict({k: torch.from_numpy(v) for k, v in
                             jax_vgg_to_state_dict(vgg_vars["params"]).items()})
        vgg = make_vgg_loss_fn(net, stats=tcfg.norm_stats)
    step = make_train_step(tcfg, ts.gen, ts.dis, ts.gen_opt, ts.dis_opt,
                           vgg_loss_fn=vgg, _deterministic=True)
    embed0 = ts.gen.enc_txt.embed_tokens.weight.detach().clone()
    port_metrics = []
    for i in range(steps):
        b = to_device(synthetic_batch(BATCH, 32, 8, tcfg.max_text_len, seed=3 + i), "cpu")
        port_metrics.append({k: float(v) for k, v in step(
            ts, b, draws=_draws(state0.rng, i, BATCH, 8, tcfg.c_dim)).items()})
    return dict(name=request.param, jcfg=jcfg, jstate=state, ts=ts,
                jax_metrics=jax_metrics, port_metrics=port_metrics,
                p_gen=p_gen, embed0=embed0, frozen=frozen)


@pytest.fixture(scope="module")
def bf16_run(jax_init):
    """The shared step (VGG off) in bf16 on both sides: (JAX metrics, port
    metrics, JAX discriminator first moments, port state, JAX config)."""
    jcfg, tcfg = _cfgs({})
    jcfg.compute_dtype = tcfg.compute_dtype = "bfloat16"
    state0, _ = jax_init
    gen, dis = build_models(jcfg, VOCAB)
    gen_tx = make_optimizer(jcfg, state0.gen_params)
    dis_tx = make_optimizer(jcfg, state0.dis_params)
    state = state0.replace(gen_opt_state=gen_tx.init(state0.gen_params),
                           dis_opt_state=dis_tx.init(state0.dis_params))
    p_gen, p_dis = _np(state.gen_params), _np(state.dis_params)
    batch = jax_synthetic_batch(BATCH, 32, 8, jcfg.max_text_len, seed=3)
    try:
        state, m = jax.jit(jax_make_train_step(jcfg, gen, dis, gen_tx, dis_tx,
                                               _deterministic=True))(state, batch)
    finally:
        jnorms.set_stats_mode("2pass")
    ts = port_create_state(tcfg, VOCAB, device="cpu")
    for mod in (ts.gen, ts.ema_gen):
        load_jax_params(mod, p_gen)
    for mod in (ts.dis, ts.ema_dis):
        load_jax_dis_params(mod, p_dis)
    step = make_train_step(tcfg, ts.gen, ts.dis, ts.gen_opt, ts.dis_opt,
                           _deterministic=True)
    b = to_device(synthetic_batch(BATCH, 32, 8, tcfg.max_text_len, seed=3), "cpu")
    got = step(ts, b, draws=_draws(state0.rng, 0, BATCH, 8, tcfg.c_dim))
    return ({k: float(v) for k, v in m.items()}, {k: float(v) for k, v in got.items()},
            _adam_mu(state.dis_opt_state), ts, jcfg)


def test_bf16_step_matches_jax_bf16(bf16_run):
    want, got, dis_mu, ts, cfg = bf16_run
    assert sorted(got) == sorted(want)
    rel = {k: abs(got[k] - want[k]) / abs(want[k]) for k in want if want[k] != 0}
    assert all(got[k] == 0.0 for k in want if want[k] == 0)
    assert all(r <= BF16_METRIC_RTOL for r in rel.values()), rel
    mean = sum(rel.values()) / len(rel)
    assert mean <= BF16_MEAN_SHARE * BF16_GAP_MEAN, mean
    dsd = {n: ts.dis_opt.state[p]["exp_avg"] for n, p in ts.dis.named_parameters()}
    port_mu = flatten_params(convert_reference_discriminator(dsd, cfg.dis))
    for k, w in dis_mu.items():
        err = np.linalg.norm(port_mu[k] - w)
        assert err <= BF16_DIS_MOMENT_REL * np.linalg.norm(w), (k, err)


def _port_gen(ts, sd, cfg):
    return flatten_params(convert_reference_generator(sd, cfg.gen, VOCAB))


def test_metrics_match(run):
    for want, got in zip(run["jax_metrics"], run["port_metrics"]):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=METRIC_RTOL,
                                       atol=1e-6, err_msg=k)


def _moments_close(got, want, skip=()):
    gmax = max(float(np.abs(v).max()) for v in want.values())
    for k in want:
        if k in skip:
            continue
        err = np.linalg.norm(got[k] - want[k])
        tol = MOMENT_REL * np.linalg.norm(want[k]) + MOMENT_FLOOR * gmax * np.sqrt(want[k].size)
        assert err <= tol, (k, err, tol)


def test_adam_first_moments_match(run):
    """The gradients, as both optimizers hold them: exp_avg and mu."""
    ts, cfg = run["ts"], run["jcfg"]
    state = run["jstate"]
    gsd = {n: ts.gen_opt.state[p]["exp_avg"] if p in ts.gen_opt.state
           else torch.zeros_like(p) for n, p in ts.gen.named_parameters()}
    skip = ("enc_txt/embedding",) if run["frozen"] else ()
    _moments_close(_port_gen(ts, gsd, cfg), _adam_mu(state.gen_opt_state), skip)
    dsd = {n: ts.dis_opt.state[p]["exp_avg"] for n, p in ts.dis.named_parameters()}
    _moments_close(flatten_params(convert_reference_discriminator(dsd, cfg.dis)),
                   _adam_mu(state.dis_opt_state))


def _params_close(got, want, lr):
    flips = total = 0
    for k in want:
        d = np.abs(got[k] - want[k])
        assert d.max() <= 2 * lr + PARAM_ATOL, (k, d.max())
        flips += int((d > PARAM_ATOL).sum())
        total += d.size
    assert flips <= FLIP_SHARE * total, (flips, total)


def test_updated_params_and_ema_match(run):
    ts, cfg, state = run["ts"], run["jcfg"], run["jstate"]
    lr = cfg.lr
    _params_close(_port_gen(ts, ts.gen.state_dict(), cfg),
                  flatten_params(_np(state.gen_params)), lr)
    _params_close(flatten_params(convert_reference_discriminator(
        ts.dis.state_dict(), cfg.dis)), flatten_params(_np(state.dis_params)), lr)
    for got, want in ((_port_gen(ts, ts.ema_gen.state_dict(), cfg),
                       flatten_params(_np(state.ema_gen_params))),
                      (flatten_params(convert_reference_discriminator(
                          ts.ema_dis.state_dict(), cfg.dis)),
                       flatten_params(_np(state.ema_dis_params)))):
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=PARAM_ATOL, rtol=0,
                                       err_msg=k)


def test_frozen_parameters_stay_fixed(run):
    ts = run["ts"]
    for name, p in ts.gen.enc_txt.lstm.named_parameters():
        if name.startswith("bias_hh"):
            assert not p.requires_grad and float(p.abs().max()) == 0.0, name
            assert p not in ts.gen_opt.state
    emb = ts.gen.enc_txt.embed_tokens.weight
    if run["frozen"]:
        assert torch.equal(emb.detach(), run["embed0"])
        assert emb not in ts.gen_opt.state
    else:
        assert not torch.equal(emb.detach(), run["embed0"])


def test_discriminator_takes_no_gradient_from_the_generator_backward(run):
    """After a step D's gradients are cleared by its own update; the G
    backward (its adversarial head ran through D) left none behind, and D
    is trainable again."""
    ts = run["ts"]
    for p in ts.dis.parameters():
        assert p.grad is None and p.requires_grad


def test_generator_updates_every_n_critic_steps(run):
    n_critic = VARIANTS[run["name"]].get("n_critic", 1)
    for i, m in enumerate(run["port_metrics"]):
        assert m["grad_dis_norm"] > 0.0
        if (i + 1) % n_critic:
            assert m["loss_gen_total"] == 0.0 and m["grad_gen_norm"] == 0.0
        else:
            assert m["loss_gen_total"] != 0.0 and m["grad_gen_norm"] > 0.0


def test_bn_discriminator_is_rejected():
    _, cfg = _cfgs({})
    ts = port_create_state(cfg, VOCAB, device="cpu")
    cfg.dis.norm = "bn"
    with pytest.raises(ValueError, match="bn"):
        make_train_step(cfg, ts.gen, ts.dis, ts.gen_opt, ts.dis_opt)
