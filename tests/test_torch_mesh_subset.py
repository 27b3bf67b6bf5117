"""A mesh smaller than the world, on the CPU (ROADMAP F11).

JAX builds a `mesh_data x mesh_model` mesh on the first `data * model`
devices and leaves the rest unused (`dwcgan_tpu/parallel/mesh.py:82-92`,
`dwcgan_tpu/cli/train.py:128-132`).  The port builds it on ranks
0 .. data * model - 1; a rank outside it creates the process groups and
exits 0 without a trainer, a feed or a file.  `cli/train.py` at
`configs/smoke.yaml` widths with `mesh_data 1`, 2 steps, `--device cpu`,
ranks over gloo by `env://` on localhost (as `torch.distributed.run` sets
it), one thread each, every wait 300 s at most:

- 2 ranks, a 1 x 1 mesh: the metric rows and every tensor of the last
  checkpoint equal one process's bit for bit;
- 3 ranks, a 1 x 2 mesh (`--mesh_model 2`): the same against the 2-rank
  1 x 2 run;

and in both the idle rank, given an output path of its own, wrote nothing
there, and the mesh line names the mesh, not the world.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import yaml

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "configs" / "smoke.yaml"
TIMEOUT = 300                       # tests/test_torch_tp_checkpoint.py's
STEPS = 2
OVER = {"mesh_data": 1, "batch_size": 4, "log_iter": 1, "image_display_iter": 2,
        "image_save_iter": 2, "snapshot_save_iter": 2, "num_workers": 0}
DROP = ("time", "steps_per_sec", "images_per_sec")

torch.set_num_threads(1)


def _args(tmp, out, model):
    return ["--config", str(tmp / "sub.yaml"), "--procedural_data",
            "--procedural_size", "16", "--max_steps", str(STEPS),
            "--output_path", str(out), "--device", "cpu", "--mesh_model", str(model)]


def _worker(rank, world, tmp, run, model):
    """One rank of `run`: every rank but 0 writes under an output path of
    its own, where an idle rank must leave nothing."""
    from dwcgan_tpu_torch.cli import train
    tmp = Path(tmp)
    out = tmp / (run if rank == 0 else f"{run}_r{rank}")
    train.main(_args(tmp, out, model))


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(tmp, world, run, model):
    """`world` ranks of this file as `torch.distributed.run` starts them;
    every rank must exit 0.  Returns their outputs."""
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK")}
    env.update(PYTHONPATH=str(ROOT), MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(world))
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(rank), str(world), str(tmp), run, str(model)],
        cwd=ROOT, env=dict(env, RANK=str(rank), LOCAL_RANK=str(rank)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(world)]
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


def _rows(out):
    with open(out / "logs" / "sub" / "metrics.jsonl") as f:
        return [{k: v for k, v in json.loads(ln).items() if k not in DROP} for ln in f]


def _checkpoint(out):
    from dwcgan_tpu_torch.train.checkpoint import checkpoint_file
    return torch.load(checkpoint_file(str(out / "outputs" / "sub" / "checkpoints")),
                      weights_only=True)


def _assert_equal(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            _assert_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (u, v) in enumerate(zip(a, b)):
            _assert_equal(u, v, f"{path}/{i}")
    elif torch.is_tensor(a):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    else:
        assert a == b, path


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_subset")
    with open(CONFIG) as f:
        raw = yaml.safe_load(f)
    (tmp / "sub.yaml").write_text(yaml.safe_dump({**raw, **OVER}))
    return tmp


@pytest.mark.parametrize("world,model,reference", [(2, 1, "one"), (3, 2, "pair")])
def test_mesh_smaller_than_the_world_trains_as_the_mesh_alone(tmp, world, model,
                                                              reference):
    from dwcgan_tpu_torch.cli import train
    run = f"sub{world}"
    outs = _launch(tmp, world, run, model)
    assert f"mesh: {{'data': 1, 'model': {model}}} over {model} devices" in outs[0]
    assert f"rank {world - 1} of {world}: outside the 1x{model} mesh, idle" in outs[-1]
    assert not (tmp / f"{run}_r{world - 1}").exists()   # the idle rank wrote nothing
    if reference == "one":
        train.main(_args(tmp, tmp / "one", model))
    else:
        _launch(tmp, model, reference, model)
    got, want = tmp / run, tmp / reference
    assert [r["step"] for r in _rows(got)] == list(range(1, STEPS + 1))
    assert _rows(got) == _rows(want)
    _assert_equal(_checkpoint(got), _checkpoint(want))


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
            int(sys.argv[5]))
