"""Checkpoints and the training CLI under tensor parallelism, on the CPU.

A checkpoint file holds full tensors whatever the mesh that wrote it
(`train/checkpoint.py`, `parallel/rules.py`), so a snapshot of any mesh
restores bit-equal into any other.  Ranks are processes of this file over
gloo (a `FileStore` in the test's directory; the CLI's by `env://` on
localhost, as `torch.distributed.run` sets it), one thread each, every
wait 300 s at most.  Config: `configs/smoke.yaml` widths at 64 px with five
discriminator layers, so that every rule of `parallel/rules.py` engages
(`tests/test_torch_tensor_parallel.py`), batch 4.

1. The chain 1 x 1 -> 1 x 2 -> 2 x 1 -> 2 x 2 -> 1 x 1: each mesh restores
   the file the one before it wrote and saves it again (every tensor, the
   optimizers' moments and the step's generator state bit-equal to the
   file it read), takes a step and saves; the 2 x 2 ranks and one process
   also warm-start a fresh state from the 1 x 2 file (every parameter but
   the word embedding bit-equal to the donor's).
2. `cli/train.py --mesh_model 2 --device cpu` on 2 ranks: 2 steps, then
   `--resume 1` to step 4, equals 4 steps straight on the same mesh bit
   for bit (metric rows and checkpoint) and one process within
   `test_tp_parity.py`'s tolerances: the first step's metrics within rtol
   2e-4 / atol 1e-5, the parameters after 4 steps within rtol 2e-4 plus
   its atol 2.5e-4 a step; the later steps' metrics within what the
   divergence of rounding-noise gradients gives (`LATER_RTOL`); rank 0 wrote the grids,
   the log and the snapshots, rank 1 (given an output path of its own)
   nothing; the mesh line reads {'data': 1, 'model': 2}.
3. Where the later steps' gap starts (ROADMAP F12): 4 steps on 1 x 2
   against one process with the conv biases that feed an instance norm or
   AdaIN frozen (their gradients zeroed on both sides).  Step 1's
   generator gradients agree with one process's to rounding (each tensor
   within `GRAD_RTOL` of its largest element) and differ in sign only
   where they are rounding noise (under `FLIP_NOISE` of that element);
   Adam's first step then moves each such element by up to lr either way,
   so the later steps stay within `LATER_RTOL` only.  Freezing the biases
   does not bring steps 2-4 to step 1's rtol: the numbers are printed.
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
import yaml

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "configs" / "smoke.yaml"
VOCAB, BATCH = 102, 4
TIMEOUT = 300
RTOL, ATOL = 2e-4, 1e-5                  # test_tp_parity.py's, one step
PARAM_RTOL, PARAM_ATOL_STEP = 2e-4, 2.5e-4   # its parameters, per step
# after the first step the two runs diverge as any two runs do whose
# rounding-noise gradients (a conv bias in front of an instance norm has a
# true gradient of 0) take other signs: Adam moves those parameters by lr
# one way or the other, and the difference grows about tenfold a step here
# (G's gradient norm: 2.6e-4, 5.1e-3, 8.3e-3 relative at steps 2-4; the
# losses 1.2e-5, 1.7e-4, 7.8e-4)
LATER_RTOL, LATER_NORM_RTOL = 2e-3, 2e-2
GRAD_NORMS = ("grad_gen_norm", "grad_dis_norm")
OVER = {"image_size": 64, "crop_size": 80, "batch_size": BATCH, "log_iter": 1,
        "image_display_iter": 2, "image_save_iter": 4, "snapshot_save_iter": 2,
        "num_workers": 0}
DIS_OVER = {"n_layer": 5, "image_size": 64}
CHAIN = (("1x2", 2, 2), ("2x1", 2, 1), ("2x2", 4, 2))   # (name, world, model)
STEPS = 4
GRAD_RTOL = 5e-5     # step 1's gradients, of each tensor's largest element
FLIP_NOISE = 1e-7    # a sign flip's size, of its tensor's largest element

torch.set_num_threads(1)


def write_config(path):
    with open(CONFIG) as f:
        raw = yaml.safe_load(f)
    raw.update(OVER)
    raw["dis"] = {**raw["dis"], **DIS_OVER}
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def _cfg(path, model=1):
    from dwcgan_tpu_torch.config import load_config
    cfg = load_config(path)
    cfg.mesh_model = model
    return cfg


def _step_once(state, cfg, axis):
    from dwcgan_tpu_torch.data.pipeline import Batch, synthetic_batch, to_device
    from dwcgan_tpu_torch.train.step import make_train_step
    step = make_train_step(cfg, state.gen, state.dis, state.gen_opt, state.dis_opt,
                           axis=axis)
    b = synthetic_batch(BATCH, cfg.image_size, 8, cfg.max_text_len, seed=state.step)
    if axis is not None and axis.grouped:
        n = axis.local_batch
        b = Batch(*(np.asarray(a)[axis.data_rank * n:(axis.data_rank + 1) * n] for a in b))
    step(state, to_device(b, "cpu"))


def _manager(directory, cfg, axis=None):
    from dwcgan_tpu_torch.train.checkpoint import CheckpointManager, checkpoint_header
    return CheckpointManager(str(directory), header=checkpoint_header(cfg, VOCAB, "tp"),
                             axis=axis)


def _donor_params(path):
    from dwcgan_tpu_torch.train.checkpoint import checkpoint_file, read_checkpoint
    ck = read_checkpoint(checkpoint_file(str(path)))
    return {f"{n}.{k}": v for n in ("gen", "dis") for k, v in ck[n].items()
            if "embed_tokens" not in k}


def _full_params(state):
    from dwcgan_tpu_torch.parallel.rules import full_state_dict
    return {f"{n}.{k}": v for n in ("gen", "dis")
            for k, v in full_state_dict(getattr(state, n)).items()
            if "embed_tokens" not in k}


def _restore_resave_step(tmp, src, dst, cfg, axis=None, donor=None):
    """Restore `src` into a state of another seed on this mesh, save it
    again under `dst`/again, take a step and save under `dst`/next; with
    `donor`, also warm-start a fresh state from it and return its full
    parameters."""
    from dwcgan_tpu_torch.train.checkpoint import warm_start
    from dwcgan_tpu_torch.train.state import create_train_state
    state = create_train_state(cfg, VOCAB, device="cpu", seed=7, axis=axis)
    _manager(tmp / src, cfg, axis).restore(state)
    _manager(tmp / dst / "again", cfg, axis).save(state)
    _step_once(state, cfg, axis)
    _manager(tmp / dst / "next", cfg, axis).save(state)
    if donor is None:
        return None
    fresh = create_train_state(cfg, VOCAB, device="cpu", seed=9, axis=axis)
    warm_start(fresh, str(tmp / donor))
    return _full_params(fresh)


def _frozen_grad_run(cfg, axis=None):
    """STEPS steps from the seed-0 state with the conv biases in front of an
    instance norm or AdaIN frozen: per step the metrics and this rank's
    generator gradients as Adam takes them (a sharded tensor's slice, with
    its dimension)."""
    from dwcgan_tpu_torch.data.pipeline import Batch, synthetic_batch, to_device
    from dwcgan_tpu_torch.ops.blocks import Conv2dBlock
    from dwcgan_tpu_torch.train import step as step_mod
    from dwcgan_tpu_torch.train.state import create_train_state
    state = create_train_state(cfg, VOCAB, device="cpu", seed=0, axis=axis)
    for m in state.gen.modules():
        if isinstance(m, Conv2dBlock) and m.norm_type in ("in", "adain"):
            m.conv.bias.register_hook(torch.zeros_like)
    names = {id(p): n for n, p in state.gen.named_parameters()}
    grads, apply = {}, step_mod._apply

    def capture(opt, lr):
        for group in opt.param_groups:
            for p in group["params"]:
                if id(p) in names and p.grad is not None:
                    shard = getattr(p, "tp_shard", None)
                    grads[names[id(p)]] = (p.grad.clone(), shard and shard.dim)
        apply(opt, lr)

    step = step_mod.make_train_step(cfg, state.gen, state.dis, state.gen_opt, state.dis_opt, axis=axis)
    out = []
    step_mod._apply = capture
    try:
        for i in range(STEPS):
            b = synthetic_batch(BATCH, cfg.image_size, 8, cfg.max_text_len, seed=i)
            if axis is not None and axis.grouped:
                n = axis.local_batch
                b = Batch(*(np.asarray(a)[axis.data_rank * n:(axis.data_rank + 1) * n]
                            for a in b))
            grads.clear()
            metrics = {k: float(v) for k, v in step(state, to_device(b, "cpu")).items()}
            out.append((metrics, dict(grads)))
    finally:
        step_mod._apply = apply
    return out


# ------------------------------------------------------- the rank processes

def _worker(mode, rank, world, tmp, arg):
    import torch.distributed as dist
    tmp = Path(tmp)
    if mode == "cli":
        # "first": 2 steps, "resumed": on to 4 from its checkpoint (every
        # rank reads it), "straight": 4; rank 1 of the other two runs gets
        # an output path of its own, where it must write nothing
        from dwcgan_tpu_torch.cli import train
        run = "straight" if arg == "straight" else "resumed"
        out = tmp / (run if rank == 0 or arg == "resumed" else f"{run}_r{rank}")
        steps = STEPS // 2 if arg == "first" else STEPS
        train.main(["--config", str(tmp / "tp.yaml"), "--procedural_data",
                    "--procedural_size", "16", "--max_steps", str(steps),
                    "--output_path", str(out), "--device", "cpu", "--mesh_model", "2",
                    *(["--resume", "1"] if arg == "resumed" else [])])
        return
    from dwcgan_tpu_torch.parallel.mesh import DataAxis
    if mode == "grads":
        dist.init_process_group("gloo", store=dist.FileStore(str(tmp / "store_grads"), world),
                                rank=rank, world_size=world)
        try:
            cfg = _cfg(str(tmp / "tp.yaml"), world)
            torch.save(_frozen_grad_run(cfg, DataAxis.from_config(cfg)),
                       tmp / f"grads{rank}.pt")
        finally:
            dist.destroy_process_group()
        return
    name, src, donor = arg.split(":")
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp / f"store_{name}"), world),
                            rank=rank, world_size=world)
    try:
        model = {n: m for n, _, m in CHAIN}[name]
        cfg = _cfg(str(tmp / "tp.yaml"), model)
        axis = DataAxis.from_config(cfg)
        warm = _restore_resave_step(tmp, src, name, cfg, axis, donor or None)
        if warm is not None:
            torch.save(warm, tmp / f"warm_{name}_{rank}.pt")
    finally:
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(mode, tmp, world, arg, env_launch=False):
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK")}
    env["PYTHONPATH"] = str(ROOT)
    port = str(_free_port())
    procs = []
    for rank in range(world):
        if env_launch:   # as torch.distributed.run sets it
            env = dict(env, WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
                       MASTER_ADDR="localhost", MASTER_PORT=port)
        procs.append(subprocess.Popen(
            [sys.executable, __file__, mode, str(rank), str(world), str(tmp), arg],
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

def _assert_files_equal(a, b):
    from dwcgan_tpu_torch.train.checkpoint import checkpoint_file
    fa = torch.load(checkpoint_file(str(a)), weights_only=True)
    fb = torch.load(checkpoint_file(str(b)), weights_only=True)

    def walk(x, y, path):
        if isinstance(x, dict):
            assert isinstance(y, dict) and x.keys() == y.keys(), path
            for k in x:
                walk(x[k], y[k], f"{path}/{k}")
        elif isinstance(x, (list, tuple)):
            assert len(x) == len(y), path
            for i, (u, v) in enumerate(zip(x, y)):
                walk(u, v, f"{path}/{i}")
        elif torch.is_tensor(x):
            assert x.dtype == y.dtype and torch.equal(x, y), path
        else:
            assert x == y, path
    walk(fa, fb, "")


def test_checkpoints_restore_bit_equal_across_meshes(tmp_path):
    from dwcgan_tpu_torch.train.state import create_train_state
    path = write_config(tmp_path / "tp.yaml")
    cfg = _cfg(path)
    state = create_train_state(cfg, VOCAB, device="cpu", seed=0)
    _step_once(state, cfg, None)
    _manager(tmp_path / "1x1", cfg).save(state)
    src = "1x1"
    for name, world, _ in CHAIN:
        donor = "1x2/next" if name == "2x2" else ""
        _launch("ckpt", tmp_path, world, f"{name}:{src}:{donor}")
        _assert_files_equal(tmp_path / name / "again", tmp_path / src)
        src = f"{name}/next"
    warm = _restore_resave_step(tmp_path, src, "back", cfg, donor="1x2/next")
    _assert_files_equal(tmp_path / "back" / "again", tmp_path / src)
    want = _donor_params(tmp_path / "1x2" / "next")
    for got in [warm] + [torch.load(tmp_path / f"warm_2x2_{r}.pt") for r in range(4)]:
        assert got.keys() == want.keys()
        bad = [k for k, v in want.items() if not torch.equal(got[k], v)]
        assert not bad, bad[:8]
    # every file of the chain holds full tensors: the step moved on each mesh
    steps = [torch.load(str(next((tmp_path / d).iterdir())), weights_only=True)["step"]
             for d in ("1x1", "1x2/next", "2x1/next", "2x2/next", "back/next")]
    assert steps == [1, 2, 3, 4, 5]


def _rows(out):
    with open(out / "logs" / "tp" / "metrics.jsonl") as f:
        return [json.loads(ln) for ln in f]


def _last_ckpt(out):
    from dwcgan_tpu_torch.train.checkpoint import checkpoint_file
    return torch.load(checkpoint_file(str(out / "outputs" / "tp" / "checkpoints")),
                      weights_only=True)


def test_cli_trains_resumes_and_renders_under_tp(tmp_path):
    from dwcgan_tpu_torch.cli import train
    write_config(tmp_path / "tp.yaml")
    outs = _launch("cli", tmp_path, 2, "first", env_launch=True)
    assert "mesh: {'data': 1, 'model': 2} over 2 devices" in outs[0]
    _launch("cli", tmp_path, 2, "resumed", env_launch=True)
    _launch("cli", tmp_path, 2, "straight", env_launch=True)
    for run in ("resumed", "straight"):
        assert not (tmp_path / f"{run}_r1").exists()      # rank 1 wrote nothing
    train.main(["--config", str(tmp_path / "tp.yaml"), "--procedural_data",
                "--procedural_size", "16", "--max_steps", str(STEPS),
                "--output_path", str(tmp_path / "one"), "--device", "cpu"])
    resumed, straight, one = (tmp_path / d for d in ("resumed", "straight", "one"))
    images = sorted(p.name for p in (resumed / "outputs" / "tp" / "images").iterdir())
    assert images == sorted(p.name for p in (one / "outputs" / "tp" / "images").iterdir())
    assert {"train_current.jpg", "test_00000004.jpg", "train_00000004.jpg"} <= set(images)
    rows = {k: _rows(d) for k, d in (("resumed", resumed), ("straight", straight),
                                     ("one", one))}
    drop = ("time", "steps_per_sec", "images_per_sec")
    strip = lambda rs: [{k: v for k, v in r.items() if k not in drop} for r in rs]
    assert [r["step"] for r in rows["resumed"]] == list(range(1, STEPS + 1))
    assert strip(rows["resumed"]) == strip(rows["straight"])
    _assert_files_equal(resumed / "outputs" / "tp" / "checkpoints",
                        straight / "outputs" / "tp" / "checkpoints")
    for i, (got, want) in enumerate(zip(strip(rows["resumed"]), strip(rows["one"]))):
        assert got.keys() == want.keys()
        for k in want:
            rtol = RTOL if i == 0 else LATER_NORM_RTOL if k in GRAD_NORMS else LATER_RTOL
            np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=ATOL,
                                       err_msg=f"step {i + 1} {k}")
    got, want = _last_ckpt(resumed), _last_ckpt(one)
    for net in ("gen", "dis", "ema_gen", "ema_dis"):
        for k, w in want[net].items():
            np.testing.assert_allclose(got[net][k].numpy(), w.numpy(), rtol=PARAM_RTOL,
                                       atol=PARAM_ATOL_STEP * STEPS, err_msg=f"{net}.{k}")



def test_later_step_gap_starts_at_rounding_noise_sign_flips(tmp_path):
    write_config(tmp_path / "tp.yaml")
    _launch("grads", tmp_path, 2, "")
    ranks = [torch.load(tmp_path / f"grads{r}.pt", weights_only=False) for r in range(2)]
    one = _frozen_grad_run(_cfg(str(tmp_path / "tp.yaml")))
    (_, g0), (_, g1) = ranks[0][0], ranks[1][0]
    flips = {}
    for name, (want, _) in one[0][1].items():
        got, dim = g0[name]
        if dim is not None:
            got = torch.cat([got, g1[name][0]], dim)
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= GRAD_RTOL * scale, name
        flip = (got > 0) != (want > 0)
        if flip.any():
            flips[name] = (int(flip.sum()), float(want.abs()[flip].max()), scale, dim)
            assert flips[name][1] <= FLIP_NOISE * scale, (name, flips[name])
    print(f"step 1 sign flips (count, largest |g|, the tensor's largest, shard dim): {flips}")
    for i in range(STEPS):
        got, want = ranks[0][i][0], one[i][0]
        rel = {k: abs(got[k] - w) / max(abs(w), 1e-12) for k, w in want.items()}
        worst = max(rel, key=rel.get)
        print(f"step {i + 1}, conv biases before a norm frozen: worst {worst} "
              f"{rel[worst]:.3e} relative; grad_gen_norm {rel['grad_gen_norm']:.3e}, "
              f"loss_gen_total {rel['loss_gen_total']:.3e}")
        for k, w in want.items():
            rtol = RTOL if i == 0 else LATER_NORM_RTOL if k in GRAD_NORMS else LATER_RTOL
            np.testing.assert_allclose(got[k], w, rtol=rtol, atol=ATOL,
                                       err_msg=f"step {i + 1} {k}")


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
            sys.argv[5] if len(sys.argv) > 5 else "")
