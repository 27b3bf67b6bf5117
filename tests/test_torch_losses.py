"""The port's losses, penalties, style sampling, schedules and optimizer
against the JAX package, on the CPU in fp32, with the same numpy inputs.

Tolerances: values and gradients within rtol 1e-5 / atol 1e-6 (summation
order only), except the R1 and GP penalties (a gradient of a gradient
through a small discriminator: rtol 1e-4) and the three optimizer steps
(atol 1e-6 on parameters of size ~1, a few ulps: the two apply the bias
corrections and the learning rate in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dwcgan_tpu.config import load_config as jax_load_config
from dwcgan_tpu.losses import gan as jgan
from dwcgan_tpu.losses import gmm as jgmm
from dwcgan_tpu.models.discriminator import MsImageDis as JaxDis
from dwcgan_tpu.train.sampling import sample_style as jax_sample_style
from dwcgan_tpu.train.schedules import lr_schedule as jax_lr_schedule
from dwcgan_tpu.train.state import ema_update as jax_ema_update
from dwcgan_tpu.train.state import make_optimizer as jax_make_optimizer
from dwcgan_tpu_torch.config import load_config
from dwcgan_tpu_torch.interop.jax_params import load_jax_dis_params
from dwcgan_tpu_torch.losses import gan, gmm
from dwcgan_tpu_torch.models.discriminator import MsImageDis
from dwcgan_tpu_torch.train.sampling import sample_style
from dwcgan_tpu_torch.train.schedules import lr_schedule
from dwcgan_tpu_torch.train.state import ema_update, make_optimizer

torch.set_num_threads(1)

CONFIG = "configs/smoke.yaml"
RTOL, ATOL = 1e-5, 1e-6
rng = np.random.default_rng(0)


def _outs(n=3, k=8):
    """Per-scale (src, cls) outputs of two scales, numpy."""
    return [(rng.normal(size=(n, 4, 4, 1)).astype(np.float32),
             rng.normal(size=(n, k)).astype(np.float32)),
            (rng.normal(size=(n, 2, 2, 1)).astype(np.float32),
             rng.normal(size=(n, k)).astype(np.float32))]


def _value_and_grads(jfn, tfn, arrays):
    """jax.value_and_grad over every array vs torch autograd."""
    jv, jg = jax.value_and_grad(lambda *a: jfn(*a), argnums=tuple(
        range(len(arrays))))(*map(jnp.asarray, arrays))
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    tv = tfn(*ts)
    tg = torch.autograd.grad(tv, ts, allow_unused=True)
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=RTOL, atol=ATOL)
    for a, b in zip(tg, jg):
        b = np.asarray(b)
        a = np.zeros_like(b) if a is None else a.numpy()
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("gan_type", ["lsgan", "nsgan", "wgan"])
def test_dis_and_gen_adversarial_losses(gan_type):
    (fs, fc), (fs2, fc2) = _outs()
    (rs, rc), (rs2, rc2) = _outs()
    lab = rng.integers(0, 2, (3, 8)).astype(np.float32)

    def j_d(a, b, c, d, e, f, g, h):
        return jgan.dis_loss([(a, b), (c, d)], [(e, f), (g, h)], jnp.asarray(lab),
                             gan_type, "CelebA", 1.0, 0.5)

    def t_d(a, b, c, d, e, f, g, h):
        return gan.dis_loss([(a, b), (c, d)], [(e, f), (g, h)], torch.from_numpy(lab),
                            gan_type, "CelebA", 1.0, 0.5)

    _value_and_grads(j_d, t_d, [fs, fc, fs2, fc2, rs, rc, rs2, rc2])
    _value_and_grads(
        lambda a, b, c, d: jgan.gen_adv_loss([(a, b), (c, d)], jnp.asarray(lab),
                                             gan_type, "CelebA", 2.0, 1.0),
        lambda a, b, c, d: gan.gen_adv_loss([(a, b), (c, d)], torch.from_numpy(lab),
                                            gan_type, "CelebA", 2.0, 1.0),
        [fs, fc, fs2, fc2])


def test_categorical_classification_loss():
    logits = rng.normal(size=(5, 4)).astype(np.float32)
    target = rng.integers(0, 4, 5)
    _value_and_grads(
        lambda a: jgan.classification_loss(a, jnp.asarray(target), "RaFD"),
        lambda a: gan.classification_loss(a, torch.from_numpy(target), "RaFD"),
        [logits])


def test_recon_and_diversity():
    x, y = (rng.normal(size=(2, 5, 5, 3)).astype(np.float32) for _ in range(2))
    _value_and_grads(jgan.recon_l1, gan.recon_l1, [x, y])
    # the second argument is detached: its gradient is zero (None in torch)
    _value_and_grads(jgan.diversity_loss, gan.diversity_loss, [x, y])


@pytest.fixture(scope="module")
def small_dis():
    jcfg = jax_load_config(CONFIG)
    jdis = JaxDis(cfg=jcfg.dis, dtype=jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, jdis.init(
        jax.random.PRNGKey(2), jnp.zeros((1, 32, 32, 3)))["params"])
    port = MsImageDis(load_config(CONFIG).dis)
    load_jax_dis_params(port, params)
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    return jdis, params, port, x


@pytest.mark.parametrize("penalty", ["r1_penalty", "gradient_penalty"])
def test_input_gradient_penalties(small_dis, penalty):
    """Value and the gradient with respect to D's parameters (through the
    gradient of D's scale-0 output with respect to the image)."""
    jdis, params, port, x = small_dis

    def jloss(p):
        src0 = lambda im: jdis.apply({"params": p}, im, False)[0][0]
        return getattr(jgan, penalty)(src0, jnp.asarray(x))

    jv, jg = jax.value_and_grad(jloss)(params)
    port.zero_grad()
    tv = getattr(gan, penalty)(lambda im: port(im, multiscale=False)[0][0],
                               torch.from_numpy(x))
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-4)
    w = port.cnns_feat[0][0].conv.weight.grad.permute(2, 3, 1, 0).numpy()
    want = np.asarray(jg["scale_0"]["Conv2dBlock_0"]["Conv_0"]["kernel"])
    np.testing.assert_allclose(w, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    assert port.cnns_feat[1][0].conv.weight.grad is None   # scale 1 unused


@pytest.mark.parametrize("fn", ["gmm_kl", "gmm_emd"])
def test_gmm_distances(fn):
    mu = rng.normal(size=(3, 8, 4)).astype(np.float32)
    logvar = rng.normal(0, 0.3, (3, 8, 4)).astype(np.float32)
    means = rng.integers(0, 2, (3, 8)).astype(np.float32) * 2 - 1
    if fn == "gmm_kl":
        _value_and_grads(lambda a, b: jgmm.gmm_kl(a, b, jnp.asarray(means), 0.25),
                         lambda a, b: gmm.gmm_kl(a, b, torch.from_numpy(means), 0.25),
                         [mu, logvar])
    else:
        _value_and_grads(lambda a: jgmm.gmm_emd(a, jnp.asarray(means)),
                         lambda a: gmm.gmm_emd(a, torch.from_numpy(means)), [mu])


def test_sample_style_with_injected_draws():
    key = jax.random.PRNGKey(9)
    means = rng.integers(0, 2, (4, 8)).astype(np.float32) * 2 - 1
    want = np.asarray(jax_sample_style(key, jnp.asarray(means), 8, 0.5))
    eps = np.array(jax.random.normal(key, (4, 8, 8), jnp.float32))
    got = sample_style(torch.from_numpy(means), 8, 0.5, eps=torch.from_numpy(eps))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    g = torch.Generator().manual_seed(1)
    drawn = sample_style(torch.from_numpy(means), 8, 0.5, generator=g)
    assert drawn.shape == (4, 64) and drawn.dtype == torch.float32


@pytest.mark.parametrize("policy,t_mult", [("const", 1), ("step", 1),
                                           ("cosa", 1), ("cosa", 2)])
def test_schedules(policy, t_mult):
    cfg, jcfg = load_config(CONFIG), jax_load_config(CONFIG)
    for c in (cfg, jcfg):
        c.lr_policy, c.t_mult, c.step_size, c.gamma, c.eta_min = \
            policy, t_mult, 7, 0.5, 1e-6
    f, jf = lr_schedule(cfg), jax_lr_schedule(jcfg)
    for step in (0, 1, 6, 7, 8, 20, 21, 50):
        np.testing.assert_allclose(f(step), float(jf(step)), rtol=1e-6, err_msg=step)


def test_coupled_adam_and_ema_over_three_steps():
    """torch Adam(weight_decay) with lr set per step, and EMA lerp, against
    the optax chain of the JAX step (add_decayed_weights -> scale_by_adam
    -> scale(-1), updates times lr) and its `ema_update`."""
    cfg, jcfg = load_config(CONFIG), jax_load_config(CONFIG)
    p0 = rng.normal(size=(6, 5)).astype(np.float32)
    grads = [rng.normal(size=(6, 5)).astype(np.float32) for _ in range(3)]
    lrs = [1e-3, 5e-4, 2e-4]

    tx = jax_make_optimizer(jcfg, {"w": p0})
    jp, jema, opt_state = {"w": jnp.asarray(p0)}, {"w": jnp.asarray(p0)}, None
    opt_state = tx.init(jp)
    for g, lr in zip(grads, lrs):
        upd, opt_state = tx.update({"w": jnp.asarray(g)}, opt_state, jp)
        jp = optax.apply_updates(jp, jax.tree_util.tree_map(lambda u: u * lr, upd))
        jema = jax_ema_update(jp, jema)

    w = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    ema = torch.nn.Module()
    ema.w = torch.nn.Parameter(torch.from_numpy(p0.copy()), requires_grad=False)
    net = torch.nn.Module()
    net.w = w
    opt = make_optimizer(cfg, [w])
    for g, lr in zip(grads, lrs):
        w.grad = torch.from_numpy(g)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        ema_update(ema, net)
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(jp["w"]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ema.w.numpy(), np.asarray(jema["w"]), atol=1e-6, rtol=0)
    adam = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]
    np.testing.assert_allclose(opt.state[w]["exp_avg"].numpy(),
                               np.asarray(adam.mu["w"]), rtol=1e-6, atol=1e-7)
