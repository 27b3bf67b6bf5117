"""Data-parallel training in the port (`parallel/mesh.py`) on the CPU:
`configs/smoke.yaml` widths, 32 px, fp32, one thread a process.

Two ranks are two processes of this file (`python <this file> <mode> ...`),
joined over gloo by a `FileStore` in the test's directory (the CLI's by
`env://` on localhost, as `torch.distributed.run` sets it); every wait on
them has a 300 s timeout, so a hang fails the test.

1. A 2-rank step with `state.rng`'s draws and dropout on (GP on, so its
   mixing weights are drawn too; the shared step and the non-shared one
   with n_critic 2) equals one process on the global batch of 4: every
   metric of the first step within rtol 1e-5 (measured: 1.4e-7 at most),
   the parameters after 2 steps within rtol 1e-5 plus an atol of 4.108 lr:
   the ranks' gradients are averaged in another summation order than one
   process's, and Adam moves a parameter by lr * m_hat / sqrt(v_hat), at
   most 1 lr at its first step and 1.054 lr at its second (betas 0.5,
   0.999; largest where the second gradient is twice the first), so a
   gradient that is rounding noise (a conv bias in front of an instance
   norm has a true gradient of 0; a few weights) can move a parameter
   that far one way on one side and the other way on the other.  So the
   second step starts from parameters that differ there: its losses stay
   within rtol 1e-5 (measured 2.1e-7), its gradient norms within 1e-4
   (measured 1.1e-5 for G's).  The ranks' parameters are bit-equal to each
   other.
2. The 2-rank port with JAX's draws injected (each rank its rows) and
   dropout off equals the JAX step on the global batch at
   `tests/test_multihost.py`'s rtol 2e-4 / atol 1e-5, every metric.
3. The row-window draws: a draw for a pass-batched [3n] call on this
   rank's rows equals the matching rows of the one-process [3B] draw, bit
   for bit (`Rows.draw`, dropout, the style draws, the LSTM's mask drawn
   at the full length); no processes.
4. The training CLI on 2 ranks x 2 steps of `--procedural_data`: rank 0
   wrote the metric log, the grids, `index.html` and the checkpoint; rank
   1, given an output path of its own, wrote nothing there; the checkpoint
   restores bit-equal into a one-process trainer, and equals both ranks'
   final states.
5. `DataAxis` takes the model axis into its mesh (`mesh_model` 2 over 4
   ranks: a data axis of 2), takes a mesh smaller than the world as JAX
   does, and rejects a model axis that does not divide the ranks, a mesh
   larger than the world, and a batch the data axis does not divide, with
   JAX's messages where JAX has them
   (`tests/test_torch_tensor_parallel.py` holds every case against JAX's
   `create_mesh`).
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
CONFIG = str(ROOT / "configs" / "smoke.yaml")
VOCAB, GLOBAL, WORLD, STEPS = 102, 4, 2, 2
TIMEOUT = 300
METRIC_RTOL, PARAM_RTOL = 1e-5, 1e-5
LATER_NORM_RTOL = 1e-4     # gradient norms after the first Adam step
ADAM_STEP_MAX = (1.0, 1.054)   # largest Adam update per step, in lr
GRAD_NORMS = ("grad_gen_norm", "grad_dis_norm")
JAX_RTOL, JAX_ATOL = 2e-4, 1e-5
VARIANTS = {"shared": {}, "n_critic2": {"n_critic": 2}}

torch.set_num_threads(1)


def _cfg(over=None):
    from dwcgan_tpu_torch.config import load_config
    cfg = load_config(CONFIG)
    cfg.batch_size, cfg.gp_w = GLOBAL, 1.0
    for k, v in (over or {}).items():
        setattr(cfg, k, v)
    return cfg


def _global_batches(cfg):
    from dwcgan_tpu_torch.data.pipeline import synthetic_batch
    return [synthetic_batch(GLOBAL, 32, 8, cfg.max_text_len, seed=3 + i)
            for i in range(STEPS)]


def _rows(batch, rank, world):
    from dwcgan_tpu_torch.data.pipeline import Batch
    n = GLOBAL // world
    return Batch(*(np.asarray(a)[rank * n:(rank + 1) * n] for a in batch))


def _run_steps(cfg, rank, world, draws=None, deterministic=False):
    """STEPS steps of the port on this rank's rows (one process: the whole
    global batch): (metrics per step, parameter state dicts)."""
    from dwcgan_tpu_torch.data.pipeline import to_device
    from dwcgan_tpu_torch.parallel.mesh import DataAxis
    from dwcgan_tpu_torch.train.state import create_train_state
    from dwcgan_tpu_torch.train.step import make_train_step
    axis = DataAxis.from_config(cfg)
    assert (axis.rank, axis.world) == (rank, world)
    state = create_train_state(cfg, VOCAB, device="cpu", seed=0)
    if draws is not None:
        load_jax_state(state, draws["params"])
    step = make_train_step(cfg, state.gen, state.dis, state.gen_opt, state.dis_opt,
                           _deterministic=deterministic, axis=axis)
    metrics = []
    for i, b in enumerate(_global_batches(cfg)):
        mine = None
        if draws is not None:
            n = GLOBAL // world
            mine = {k: torch.from_numpy(v[i][rank * n:(rank + 1) * n])
                    for k, v in draws["steps"].items()}
        m = step(state, to_device(_rows(b, rank, world), "cpu"), draws=mine)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, {"gen": state.gen.state_dict(), "dis": state.dis.state_dict()}


def load_jax_state(state, params):
    from dwcgan_tpu_torch.interop.jax_params import load_jax_dis_params, load_jax_params
    for m in (state.gen, state.ema_gen):
        load_jax_params(m, params["gen"])
    for m in (state.dis, state.ema_dis):
        load_jax_dis_params(m, params["dis"])


# ------------------------------------------------------- the rank processes

def _join(tmp, rank, world):
    import torch.distributed as dist
    store = dist.FileStore(str(Path(tmp) / "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)


def _worker(mode, rank, world, tmp, arg):
    import torch.distributed as dist
    tmp = Path(tmp)
    if mode == "cli":
        from dwcgan_tpu_torch.cli import train
        out = tmp / ("out" if rank == 0 else "r1")
        state, _ = train.main(["--config", CONFIG, "--procedural_data",
                               "--procedural_size", "64", "--max_steps", str(STEPS),
                               "--output_path", str(out), "--device", "cpu"])
        torch.save(_state_tensors(state), tmp / f"state{rank}.pt")
        return
    _join(tmp, rank, world)
    try:
        if mode == "step":
            metrics, params = _run_steps(_cfg(VARIANTS[arg]), rank, world)
        else:   # "jax": JAX's draws and parameters, dropout off
            draws = torch.load(tmp / "jax_inputs.pt", weights_only=False)
            metrics, params = _run_steps(_cfg(), rank, world, draws, deterministic=True)
        torch.save({"metrics": metrics, "params": params}, tmp / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _state_tensors(state):
    out = {"step": torch.tensor(state.step), "rng": state.rng.get_state()}
    for name in ("gen", "dis", "ema_gen", "ema_dis"):
        for k, v in getattr(state, name).state_dict().items():
            out[f"{name}.{k}"] = v.detach().clone()
    for name in ("gen_opt", "dis_opt"):
        for i, st in getattr(state, name).state_dict()["state"].items():
            for k, v in st.items():
                out[f"{name}.{i}.{k}"] = v.detach().clone()
    return out


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(mode, tmp, arg="", env_launch=False):
    """Run WORLD rank processes of this file; fail with their output if one
    fails or any outlives TIMEOUT."""
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK")}
    env["PYTHONPATH"] = str(ROOT)
    port = str(_free_port())
    procs = []
    for rank in range(WORLD):
        if env_launch:   # as torch.distributed.run sets it
            env = dict(env, WORLD_SIZE=str(WORLD), RANK=str(rank), LOCAL_RANK=str(rank),
                       MASTER_ADDR="localhost", MASTER_PORT=port)
        procs.append(subprocess.Popen(
            [sys.executable, __file__, mode, str(rank), str(WORLD), str(tmp), arg],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
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
    return outs


# ------------------------------------------------------------------- tests

@pytest.mark.parametrize("variant", list(VARIANTS))
def test_two_ranks_equal_one_process_on_the_global_batch(tmp_path, variant):
    _launch("step", tmp_path, variant)
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(WORLD)]
    cfg = _cfg(VARIANTS[variant])
    want_metrics, want_params = _run_steps(cfg, 0, 1)
    atol = 2 * cfg.lr * sum(ADAM_STEP_MAX[:STEPS])
    for r in ranks:
        assert len(r["metrics"]) == STEPS
        for i, (got, want) in enumerate(zip(r["metrics"], want_metrics)):
            assert sorted(got) == sorted(want)
            for k in want:
                rtol = LATER_NORM_RTOL if i and k in GRAD_NORMS else METRIC_RTOL
                np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=1e-7,
                                           err_msg=f"step {i} {k}")
        for net in ("gen", "dis"):
            for k, w in want_params[net].items():
                np.testing.assert_allclose(r["params"][net][k].numpy(), w.numpy(),
                                           rtol=PARAM_RTOL, atol=atol, err_msg=k)
    for net in ("gen", "dis"):
        for k, v in ranks[0]["params"][net].items():
            assert torch.equal(v, ranks[1]["params"][net][k]), k


@pytest.fixture(scope="module")
def jax_step():
    """The JAX step on the global batch (dropout off, compiled once): its
    metrics, and the parameters and style draws the port is given."""
    import jax
    from dwcgan_tpu.config import load_config as jax_load_config
    from dwcgan_tpu.data.pipeline import Batch as JaxBatch
    from dwcgan_tpu.ops import norms as jnorms
    from dwcgan_tpu.train.state import build_models, create_train_state, make_optimizer
    from dwcgan_tpu.train.step import make_train_step as jax_make_train_step
    jcfg = jax_load_config(CONFIG)
    jcfg.batch_size, jcfg.gp_w = GLOBAL, 1.0
    state = create_train_state(jcfg, jax.random.PRNGKey(0), VOCAB)
    gen, dis = build_models(jcfg, VOCAB)
    gen_tx = make_optimizer(jcfg, state.gen_params)
    dis_tx = make_optimizer(jcfg, state.dis_params)
    state = state.replace(gen_opt_state=gen_tx.init(state.gen_params),
                          dis_opt_state=dis_tx.init(state.dis_params))
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    params = {"gen": np_tree(state.gen_params), "dis": np_tree(state.dis_params)}
    draws = {"style1": [], "style2": [], "gp_alpha": []}
    for i in range(STEPS):
        k_d, k_g = jax.random.split(jax.random.fold_in(state.rng, i))
        keys = jax.random.split(k_g, 8)
        normal = lambda kk: np.array(jax.random.normal(kk, (GLOBAL, 8, jcfg.c_dim)))
        draws["style1"].append(normal(keys[3]))
        draws["style2"].append(normal(keys[4]))
        alpha = jax.random.uniform(jax.random.split(k_d, 4)[3], (GLOBAL, 1, 1, 1))
        draws["gp_alpha"].append(np.array(alpha))
    try:
        fn = jax.jit(jax_make_train_step(jcfg, gen, dis, gen_tx, dis_tx,
                                         _deterministic=True))
        batches = [JaxBatch(*b) for b in _global_batches(jcfg)]
        # LLVM's lowest optimisation level: the same XLA program, compiled
        # in a third of the time (as `test_torch_block_options.py`)
        fn = fn.lower(state, batches[0]).compile(
            {"xla_backend_optimization_level": 0})
        metrics = []
        for b in batches:
            state, m = fn(state, b)
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        jnorms.set_stats_mode("2pass")
    return {"metrics": metrics, "inputs": {"params": params, "steps": draws}}


def test_two_ranks_equal_the_jax_step_on_the_global_batch(tmp_path, jax_step):
    torch.save(jax_step["inputs"], tmp_path / "jax_inputs.pt")
    _launch("jax", tmp_path)
    for r in range(WORLD):
        got = torch.load(tmp_path / f"rank{r}.pt")["metrics"]
        for g, w in zip(got, jax_step["metrics"]):
            assert sorted(g) == sorted(w)
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=JAX_RTOL, atol=JAX_ATOL,
                                           err_msg=f"rank {r} {k}")


def test_row_window_draws_equal_the_global_draw_rows():
    from dwcgan_tpu_torch.ops.blocks import dropout
    from dwcgan_tpu_torch.parallel.mesh import Rows
    from dwcgan_tpu_torch.train.sampling import sample_style
    B, n = 8, 2
    one = lambda: torch.Generator().manual_seed(5)
    for offset in range(0, B, n):
        rows = Rows(B, offset, n)
        take = lambda t, k: torch.cat([t[j * B + offset:j * B + offset + n]
                                       for j in range(k)])
        for fn in (torch.rand, torch.randn):
            got = rows.draw(fn, (3 * n, 5, 4), one())
            want = fn((3 * B, 5, 4), generator=one())
            assert torch.equal(got, take(want, 3))
        x = torch.ones(3 * B, 6, 10)
        got = dropout(x[:3 * n], 0.5, True, one(), rows)
        assert torch.equal(got, take(dropout(x, 0.5, True, one()), 3))
        # the LSTM's mask: drawn at the full length, cut to the batch's
        got = dropout(x[:3 * n, :4], 0.5, True, one(), rows, length=6)
        assert torch.equal(got, take(dropout(x[:, :4], 0.5, True, one(), length=6), 3))
        means = torch.ones(4 * n, 8)
        got = sample_style(means, 8, 0.5, generator=one(), rows=rows)
        want = sample_style(torch.ones(4 * B, 8), 8, 0.5, generator=one())
        assert torch.equal(got, take(want, 4))
    with pytest.raises(ValueError, match="chunks"):
        Rows(B, 0, n).draw(torch.rand, (3, 2), one())


def test_cli_on_two_ranks(tmp_path):
    from dwcgan_tpu_torch.cli.train import build_trainer
    from dwcgan_tpu_torch.train.checkpoint import (CheckpointManager,
                                                   checkpoint_header)
    _launch("cli", tmp_path, env_launch=True)
    assert not (tmp_path / "r1").exists()          # rank 1 wrote nothing
    out = tmp_path / "out" / "outputs" / "smoke"
    with open(tmp_path / "out" / "logs" / "smoke" / "metrics.jsonl") as f:
        log = [json.loads(line) for line in f]
    assert [r["step"] for r in log] == [STEPS]   # log_iter 5: the clean end's row
    assert (out / "config.yaml").exists() and (out / "index.html").exists()
    assert any(p.name.startswith("train_current") for p in (out / "images").iterdir())
    assert sorted(p.name for p in (out / "checkpoints").iterdir()) == \
        [f"ckpt_{STEPS:08d}.pt"]
    from dwcgan_tpu_torch.config import load_config
    cfg = load_config(CONFIG)
    fresh = build_trainer(cfg, "cpu")[0]
    CheckpointManager(str(out / "checkpoints"),
                      header=checkpoint_header(cfg, VOCAB, "smoke")).restore(fresh)
    got = _state_tensors(fresh)
    ranks = [torch.load(tmp_path / f"state{r}.pt") for r in range(WORLD)]
    for want in ranks:
        assert got.keys() == want.keys()
        bad = [k for k, v in want.items() if not torch.equal(v, got[k])]
        assert not bad, bad[:8]


def test_data_axis_rejects_what_jax_rejects():
    from dwcgan_tpu_torch.parallel.mesh import DataAxis, check_mesh
    cfg = _cfg()
    axis = DataAxis.from_config(cfg)
    assert (axis.rank, axis.world, axis.local_batch, axis.rows) == (0, 1, GLOBAL, None)
    assert (axis.model, axis.data, axis.data_rank, axis.model_rank) == (1, 1, 0, 0)
    assert check_mesh(cfg, 2) == 2 and check_mesh(cfg, 4) == 4
    cfg.mesh_model = 2
    assert check_mesh(cfg, 2) == 1 and check_mesh(cfg, 4) == 2
    with pytest.raises(ValueError, match="mesh_model 2 does not divide the 1 devices"):
        DataAxis.from_config(cfg)
    cfg.mesh_model, cfg.mesh_data = 1, 2
    with pytest.raises(ValueError, match=r"mesh 2x1 needs 2 devices, have 1"):
        DataAxis.from_config(cfg)
    assert check_mesh(cfg, 4) == 2   # JAX's mesh on the first 2 of 4 devices
    cfg.mesh_data, cfg.batch_size = -1, 6
    with pytest.raises(ValueError, match=r"batch_size 6 must be divisible by the "
                       r"data mesh axis \(4\); set batch_size or mesh_data "
                       r"accordingly"):
        check_mesh(cfg, 4)


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
            sys.argv[5] if len(sys.argv) > 5 else "")
