"""The gradient penalty and R1 through a discriminator with a norm (ROADMAP
F10): the instance norm's and the reference LayerNorm's backward are
differentiable once more (`ops/norms.py::_SecondOrder`).

1. `torch.autograd.gradgradcheck` of `instance_norm` (with and without its
   fused ReLU) and `layer_norm_ref` in float64, both stats modes (the
   plain versions keep float64): the second derivatives against finite
   differences of the first, at gradgradcheck's default tolerances.
2. One fp32 step of `configs/smoke.yaml` (32 px, batch 2) with
   `dis.norm: in` and `gp_w 1`, and with `dis.norm: ln` and R1 every step,
   against JAX's `make_train_step(..., _deterministic=True)` on the port's
   seed-0 weights with JAX's draws: every metric within
   `tests/test_torch_train_step.py`'s rtol 1e-4.  (Before the fix the
   port raised on both.)
"""

import jax
import numpy as np
import pytest
import torch

from dwcgan_tpu.config import load_config as jax_load_config
from dwcgan_tpu.data.pipeline import Batch as JaxBatch
from dwcgan_tpu.interop.torch_import import (convert_reference_discriminator,
                                             convert_reference_generator)
from dwcgan_tpu.ops import norms as jnorms
from dwcgan_tpu.train.state import TrainState, build_models, make_optimizer
from dwcgan_tpu.train.step import make_train_step as jax_make_train_step
from dwcgan_tpu_torch.config import load_config
from dwcgan_tpu_torch.data.pipeline import synthetic_batch, to_device
from dwcgan_tpu_torch.ops.norms import instance_norm, layer_norm_ref
from dwcgan_tpu_torch.train.state import create_train_state
from dwcgan_tpu_torch.train.step import make_train_step

torch.set_num_threads(1)

CONFIG = "configs/smoke.yaml"
BATCH, VOCAB = 2, 102
METRIC_RTOL = 1e-4
PENALTIES = {"in_gp": {"norm": "in", "gp_w": 1.0},
             "ln_r1": {"norm": "ln", "use_r1": True, "d_reg_every": 1}}


@pytest.mark.parametrize("stats", ["2pass", "1pass"])
@pytest.mark.parametrize("op", ["instance_norm", "instance_norm_relu", "layer_norm_ref"])
def test_norms_are_twice_differentiable(op, stats):
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 3, 4, 5, generator=g, dtype=torch.float64, requires_grad=True)
    if op == "layer_norm_ref":
        gamma = torch.rand(3, generator=g, dtype=torch.float64, requires_grad=True)
        beta = torch.randn(3, generator=g, dtype=torch.float64, requires_grad=True)
        assert torch.autograd.gradgradcheck(
            lambda t, a, b: layer_norm_ref(t, a, b, stats), (x, gamma, beta))
    else:
        relu = op.endswith("relu")
        assert torch.autograd.gradgradcheck(lambda t: instance_norm(t, relu, stats), (x,))


def _cfgs(over):
    jc, tc = jax_load_config(CONFIG), load_config(CONFIG)
    for c in (jc, tc):
        c.batch_size = BATCH
        c.dis.norm = over["norm"]
        for k in ("gp_w", "use_r1", "d_reg_every"):
            if k in over:
                setattr(c, k, over[k])
    return jc, tc


@pytest.mark.parametrize("variant", list(PENALTIES))
def test_penalty_step_through_a_normed_discriminator_matches_jax(variant):
    jcfg, tcfg = _cfgs(PENALTIES[variant])
    ts = create_train_state(tcfg, VOCAB, device="cpu", seed=0)
    gp = convert_reference_generator(ts.gen.state_dict(), jcfg.gen, VOCAB)["params"]
    dp = convert_reference_discriminator(ts.dis.state_dict(), jcfg.dis)["params"]
    for name, v in ts.dis.state_dict().items():   # the importer takes no norm leaf
        if ".norm." in name:
            _, s, j, _, leaf = name.split(".")
            dp[f"scale_{s}"][f"Conv2dBlock_{j}"][f"ln_{leaf}"] = v.numpy().copy()
    gen, dis = build_models(jcfg, VOCAB)
    gen_tx, dis_tx = make_optimizer(jcfg, gp), make_optimizer(jcfg, dp)
    copy = lambda t: jax.tree_util.tree_map(np.array, t)
    state = TrainState(step=np.zeros((), np.int32), gen_params=gp, dis_params=dp,
                       ema_gen_params=copy(gp), ema_dis_params=copy(dp),
                       gen_opt_state=gen_tx.init(gp), dis_opt_state=dis_tx.init(dp),
                       rng=jax.random.PRNGKey(2))
    k_d, k_g = jax.random.split(jax.random.fold_in(state.rng, 0))
    keys = jax.random.split(k_g, 8)
    normal = lambda kk: np.array(jax.random.normal(kk, (BATCH, 8, jcfg.c_dim)))
    draws = {"style1": normal(keys[3]), "style2": normal(keys[4]),
             "gp_alpha": np.array(jax.random.uniform(jax.random.split(k_d, 4)[3],
                                                     (BATCH, 1, 1, 1)))}
    batch = synthetic_batch(BATCH, 32, 8, tcfg.max_text_len, seed=3)
    try:
        fn = jax.jit(jax_make_train_step(jcfg, gen, dis, gen_tx, dis_tx,
                                         _deterministic=True))
        jb = JaxBatch(*batch)
        fn = fn.lower(state, jb).compile({"xla_backend_optimization_level": 0})
        want = {k: float(v) for k, v in fn(state, jb)[1].items()}
    finally:
        jnorms.set_stats_mode("2pass")
    step = make_train_step(tcfg, ts.gen, ts.dis, ts.gen_opt, ts.dis_opt,
                           _deterministic=True)
    got = {k: float(v) for k, v in step(ts, to_device(batch, "cpu"), draws={
        k: torch.from_numpy(v) for k, v in draws.items()}).items()}
    penalty = "loss_gp" if "gp_w" in PENALTIES[variant] else "loss_r1"
    assert want[penalty] > 0 and got[penalty] > 0
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=METRIC_RTOL, atol=1e-7,
                                   err_msg=k)
