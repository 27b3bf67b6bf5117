"""ROADMAP F12 against the reference: does JAX's own 1 x 2 step drift from
one device over 4 steps as the port's 1 x 2 step drifts from one process?

Config: `tests/test_torch_tp_checkpoint.py`'s (`configs/smoke.yaml` widths
at 64 px, five discriminator layers, batch 4), fp32, the per-step
`synthetic_batch` seeds 0-3, the port's seed-0 parameters on both sides
(into JAX by `convert_reference_*`).  Nothing is frozen.

- JAX: `make_train_step` under `jax.jit` (LLVM's lowest optimisation
  level, which orders no sum otherwise), on `create_mesh(data=1,
  model=2)` with `place_state(..., use_tp=True)`, as
  `tests/test_tp_parity.py` builds it, and on one device; the state moves
  from step to step as JAX's CLI moves it (the step's outputs, resharded
  by GSPMD, go back in).
- The port: two gloo ranks of this file (`python <this file> RANK WORLD
  TMP`, a `FileStore`) with `mesh_model 2`, and one process, each from the
  same weights with its own random draws.

Printed: the relative gap of `grad_gen_norm` and of the losses at each
step, for JAX and for the port, and the sign flips of step 1's gradient of
the style MLP's AdaIN head (`mlp/LinearBlock_2/Dense_0/kernel`, the port's
`mlp.model.2.fc.weight`), read back from Adam's first moment (JAX's
coupled weight decay is taken off again; Adam's own input is printed too),
and per tensor the elements of Adam's step-1 input that take the other
sign on 1 x 2.

Measured on the CPU (`-s` prints it): JAX's `grad_gen_norm` gap 8.2e-6,
2.8e-4, 6.5e-5, 1.9e-3 at steps 1-4, the port's 2.4e-7, 1.1e-6, 2.8e-5,
4.5e-4; JAX's step-1 head gradient flips sign at 20 of 4096 elements, none
above 2.8e-8 of a largest 0.39, and at none of Adam's input (the coupled
decay wd * p outweighs them).  So JAX's own 1 x 2 step drifts from one
device as the port's does, and F12 is closed as the reference's own
behaviour (as F9 was): the test holds both step-4 gaps above ten times
their step 1's, JAX's at 2.5e-5 or more, the two within a factor of 10 of
each other, and JAX's flips in the head to rounding noise.  About 80 s
alone (three JAX compiles; the port's ranks run meanwhile).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from test_torch_tp_checkpoint import BATCH, STEPS, VOCAB, write_config

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300
HEAD = ("mlp", "LinearBlock_2", "Dense_0", "kernel")
SAME_ORDER = 10.0        # step 4's gaps, JAX's against the port's
FLIP_NOISE = 1e-7        # a flipped element, of the head's largest |g|
LOSSES = ("loss_gen_total", "loss_dis_all")

torch.set_num_threads(1)


def _port_cfg(path, model=1):
    from dwcgan_tpu_torch.config import load_config
    cfg = load_config(path)
    cfg.mesh_model = model
    return cfg


def _port_run(cfg, axis=None):
    """STEPS steps of the port from its seed-0 state: the metrics of each."""
    from dwcgan_tpu_torch.data.pipeline import synthetic_batch, to_device
    from dwcgan_tpu_torch.train.state import create_train_state
    from dwcgan_tpu_torch.train.step import make_train_step
    state = create_train_state(cfg, VOCAB, device="cpu", seed=0, axis=axis)
    step = make_train_step(cfg, state.gen, state.dis, state.gen_opt, state.dis_opt,
                           axis=axis)
    return [{k: float(v) for k, v in step(state, to_device(
        synthetic_batch(BATCH, cfg.image_size, 8, cfg.max_text_len, seed=i),
        "cpu")).items()} for i in range(STEPS)]


def _worker(rank, world, tmp):
    import torch.distributed as dist
    from dwcgan_tpu_torch.parallel.mesh import DataAxis
    tmp = Path(tmp)
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp / "store"), world),
                            rank=rank, world_size=world)
    try:
        cfg = _port_cfg(str(tmp / "tp.yaml"), world)
        torch.save(_port_run(cfg, DataAxis.from_config(cfg)), tmp / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _start_ranks(tmp, world=2):
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK")}
    env["PYTHONPATH"] = str(ROOT)
    return [subprocess.Popen([sys.executable, __file__, str(r), str(world), str(tmp)],
                             cwd=ROOT, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def _join(procs):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"


def _jax_run(path, model, params):
    """STEPS steps of JAX's jitted step on a data=1 x model mesh: the
    metrics of each and step 1's Adam input of the head (first moment over
    1 - beta1)."""
    import jax
    from dwcgan_tpu.config import load_config as jax_load_config
    from dwcgan_tpu.data.pipeline import Batch, shard_batch, synthetic_batch
    from dwcgan_tpu.parallel.mesh import create_mesh, place_state
    from dwcgan_tpu.train.state import TrainState, build_models, make_optimizer
    from dwcgan_tpu.train.step import make_train_step
    cfg = jax_load_config(path)
    gp, dp = params
    gen, dis = build_models(cfg, VOCAB)
    gen_tx, dis_tx = make_optimizer(cfg, gp), make_optimizer(cfg, dp)
    copy = lambda t: jax.tree_util.tree_map(np.array, t)
    state = TrainState(step=np.zeros((), np.int32), gen_params=copy(gp),
                       dis_params=copy(dp), ema_gen_params=copy(gp),
                       ema_dis_params=copy(dp), gen_opt_state=gen_tx.init(gp),
                       dis_opt_state=dis_tx.init(dp), rng=jax.random.PRNGKey(cfg.seed))
    mesh = create_mesh(data=1, model=model)
    state = place_state(state, mesh, use_tp=model > 1)
    fn = jax.jit(make_train_step(cfg, gen, dis, gen_tx, dis_tx), donate_argnums=0,
                 compiler_options={"xla_backend_optimization_level": 0})
    rows, first = [], None
    for i in range(STEPS):
        b = synthetic_batch(BATCH, cfg.image_size, 8, cfg.max_text_len, seed=i)
        state, m = fn(state, shard_batch(Batch(*(np.asarray(x) for x in b)), mesh))
        rows.append({k: float(v) for k, v in m.items()})
        if i == 0:
            adam = [s for s in jax.tree_util.tree_leaves(
                state.gen_opt_state, is_leaf=lambda s: hasattr(s, "mu"))
                if hasattr(s, "mu")][0]
            first = {"/".join(k.key for k in path): np.asarray(v, np.float64)
                     / (1.0 - cfg.beta1)
                     for path, v in jax.tree_util.tree_leaves_with_path(adam.mu)}
    return rows, first, cfg.weight_decay


def _gaps(rows, ref):
    return [{k: abs(a[k] - b[k]) / max(abs(b[k]), 1e-12)
             for k in ("grad_gen_norm",) + LOSSES} for a, b in zip(rows, ref)]


def test_jax_own_1x2_step_drifts_from_one_device_as_the_port_does(tmp_path):
    from dwcgan_tpu.config import load_config as jax_load_config
    from dwcgan_tpu.interop.torch_import import (convert_reference_discriminator,
                                                 convert_reference_generator)
    from dwcgan_tpu_torch.train.state import create_train_state
    path = write_config(tmp_path / "tp.yaml")
    procs = _start_ranks(tmp_path)     # the port's ranks run beside JAX
    try:
        jcfg = jax_load_config(path)
        ts = create_train_state(_port_cfg(path), VOCAB, device="cpu", seed=0)
        params = (convert_reference_generator(ts.gen.state_dict(), jcfg.gen, VOCAB)["params"],
                  convert_reference_discriminator(ts.dis.state_dict(), jcfg.dis)["params"])
        p0 = np.asarray(params[0]["mlp"]["LinearBlock_2"]["Dense_0"]["kernel"])
        jax_tp, adam_tp, wd = _jax_run(path, 2, params)
        jax_one, adam_one, _ = _jax_run(path, 1, params)
        port_one = _port_run(_port_cfg(path))
    finally:
        _join(procs)
    port_tp = torch.load(tmp_path / "rank0.pt", weights_only=False)
    assert port_tp == torch.load(tmp_path / "rank1.pt", weights_only=False)

    jax_gap, port_gap = _gaps(jax_tp, jax_one), _gaps(port_tp, port_one)
    for i in range(STEPS):
        fmt = lambda g: ", ".join(f"{k} {v:.3e}" for k, v in g.items())
        print(f"step {i + 1}: JAX 1x2 vs one device: {fmt(jax_gap[i])}; "
              f"port 1x2 vs one process: {fmt(port_gap[i])}")
    # the head's gradient: Adam's input less the coupled decay (wd * p0,
    # rounded as JAX adds it), signs of 1 x 2 against one device
    head_tp, head_one = adam_tp["/".join(HEAD)], adam_one["/".join(HEAD)]
    decay = (np.float32(wd) * p0).astype(np.float64)
    g_tp, g_one = head_tp - decay, head_one - decay
    flip = (g_tp > 0) != (g_one > 0)
    scale = float(np.abs(g_one).max())
    largest = float(np.abs(g_one[flip]).max()) if flip.any() else 0.0
    adam_flips = int(((head_tp > 0) != (head_one > 0)).sum())
    print(f"step 1, {'/'.join(HEAD)}: {int(flip.sum())} of {flip.size} gradient "
          f"elements flip sign (largest |g| {largest:.3e}; the tensor's largest "
          f"{scale:.3e}); {adam_flips} flip in Adam's input g + wd * p")
    moved = {k: int(((v > 0) != (adam_one[k] > 0)).sum()) for k, v in adam_tp.items()}
    print("step 1, JAX's Adam input g + wd * p, elements of other sign on 1 x 2 than "
          "on one device: " + ", ".join(f"{k} {n}" for k, n in moved.items() if n))

    # the reference drifts: step 4's gap is far above step 1's rounding, on
    # both sides, and of one order
    j4, p4 = jax_gap[-1]["grad_gen_norm"], port_gap[-1]["grad_gen_norm"]
    assert j4 >= 2.5e-5 and j4 > 10 * jax_gap[0]["grad_gen_norm"]
    assert p4 > 10 * port_gap[0]["grad_gen_norm"]
    assert 1 / SAME_ORDER <= j4 / p4 <= SAME_ORDER, (j4, p4)
    # JAX's own sign flips in the head are rounding noise, as the port's
    assert largest <= FLIP_NOISE * scale, (largest, scale)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
