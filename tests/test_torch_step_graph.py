"""The training step as CUDA graphs on the card (`train/step.py::StepGraphs`).

Marked `cuda` (they skip without a card); on a machine with one
(`--noconftest`: the suite's conftest imports JAX, which that machine need
not have):

    python -m pytest tests/test_torch_step_graph.py -m cuda --noconftest -p no:cacheprovider

Two eager steps, a capture and replays against the same steps run eagerly
from the same weights, batches and generator seed: the nets, the EMA
copies, Adam's moments and counts, every returned metric and the
generator's state bit-equal, and the kernel launches the same.  At smoke
widths, in bf16 with the VGG term, and in fp32 with each penalty (GP, R1 on
every other step, so two keys) and the spectral norm.  Two eager runs on
the card are not repeatable with the reflect pad and the bilinear
upsample, whose CUDA backwards add with atomics (ROADMAP F14), nor with
cuDNN's fp32 weight gradients unless it is held to its deterministic
algorithms; so these cases pad with zeros, upsample through
`_upsample2x_fixed_order` (the same function, from ops whose backwards add
in a fixed order) and set `cudnn.deterministic`, and each first checks
that two eager runs agree bit for bit: what is left differs only if the
graph does.  Also: a flip of the attention gate captures a
second graph, and replacing the optimizer state (a checkpoint restore)
drops the graphs; and a replay, profiled, runs every hand-written kernel
an eager step launches, as nodes of the graph.
"""

import copy
import time

import pytest
import torch

from dwcgan_tpu_torch.cli.train import build_trainer, synthetic_batches
from dwcgan_tpu_torch.config import load_config
from dwcgan_tpu_torch.models import generator as generator_mod
from dwcgan_tpu_torch.ops.blocks import channels_last
from dwcgan_tpu_torch.ops.cuda import kernels
from dwcgan_tpu_torch.train import step as step_mod
from dwcgan_tpu_torch.utils.profiling import RECORDER

CONFIG = "configs/smoke.yaml"
SEED = 11

CASES = {
    "bf16_vgg": dict(compute_dtype="bfloat16", vgg_w=0.1),
    "gp": dict(gp_w=10.0),
    "r1": dict(use_r1=True, d_reg_every=2),
    "sn": dict(dis_norm="sn"),
}


def _upsample2x_fixed_order(x: torch.Tensor) -> torch.Tensor:
    """`ops/resize.py::upsample2x` (bilinear 2x, half-pixel centres, fp32)
    from slices, products and sums: each output is 0.75 of its nearest
    input and 0.25 of the next one out, clamped at the edges."""
    def up(t, dim):
        n = t.shape[dim]
        prev = torch.cat([t.narrow(dim, 0, 1), t.narrow(dim, 0, n - 1)], dim)
        nxt = torch.cat([t.narrow(dim, 1, n - 1), t.narrow(dim, n - 1, 1)], dim)
        pair = torch.stack([0.75 * t + 0.25 * prev, 0.75 * t + 0.25 * nxt], dim + 1)
        return pair.flatten(dim, dim + 1)
    return channels_last(up(up(x.float(), 2), 3).to(x.dtype))


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(generator_mod, "upsample2x", _upsample2x_fixed_order)
    return torch.device("cuda")


def _cfg(**over):
    cfg = load_config(CONFIG)
    cfg.batch_size = 4
    cfg.gen.pad_type = cfg.dis.pad_type = "zero"
    for k, v in over.items():
        if k == "dis_norm":
            cfg.dis.norm = v
        else:
            setattr(cfg, k, v)
    return cfg


def _snapshot(state) -> dict:
    """Every tensor of the state and the generator's state, copied."""
    out = {}
    for name in ("gen", "dis", "ema_gen", "ema_dis"):
        for k, v in getattr(state, name).state_dict().items():
            out[f"{name}.{k}"] = v.detach().clone()
    for name in ("gen_opt", "dis_opt"):
        for i, st in getattr(state, name).state_dict()["state"].items():
            for k, v in st.items():
                out[f"{name}.{i}.{k}"] = v.detach().clone()
    out["rng"] = state.rng.get_state()
    return out


def _train(cfg, steps, tmp_path, warm=step_mod.WARM_STEPS):
    """`steps` steps from seeded weights on seeded batches, a key captured
    after `warm` eager steps: (snapshot, each step's metrics, the counts'
    and launches' change, the `graph` count of each `train.step` span)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(step_mod, "WARM_STEPS", warm)
        state, step, _ = build_trainer(cfg, "cuda", seed=SEED, output_path=str(tmp_path))
        batches = synthetic_batches(cfg, "cuda", n=3, seed=SEED)
        counts, launches = dict(step_mod.GRAPH_STEPS), dict(kernels.LAUNCHES)
        t0 = time.perf_counter_ns()
        metrics = []
        for i in range(steps):
            m = step(state, batches[i % len(batches)])
            metrics.append({k: v.clone() if torch.is_tensor(v) else v for k, v in m.items()})
        torch.cuda.synchronize()
    graph = [s.counts["graph"] for s in RECORDER.spans()
             if s.name == "train.step" and s.t0 > t0]
    return (_snapshot(state), metrics,
            {k: step_mod.GRAPH_STEPS[k] - counts[k] for k in counts},
            {k: kernels.LAUNCHES[k] - launches[k] for k in launches}, graph)


def _assert_same(a: dict, b: dict, what: str) -> None:
    assert a.keys() == b.keys(), what
    for k in a:
        if torch.is_tensor(a[k]):
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), (what, k)
        else:
            assert a[k] == b[k], (what, k)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_replays_match_eager_steps(card, case, tmp_path):
    cfg = _cfg(**CASES[case])
    n = 7 if cfg.use_r1 else 5      # R1 every other step: each key twice, then captured
    keys = 2 if cfg.use_r1 else 1
    ref = _train(cfg, n, tmp_path, warm=10 ** 9)
    again = _train(cfg, n, tmp_path, warm=10 ** 9)
    _assert_same(ref[0], again[0], "two eager runs")      # the precondition
    got = _train(cfg, n, tmp_path)
    _assert_same(got[0], ref[0], "state")
    for i, (a, b) in enumerate(zip(got[1], ref[1])):
        _assert_same(a, b, f"metrics of step {i}")
    assert ref[2] == {"capture": 0, "replay": 0, "eager": n}
    warm = keys * step_mod.WARM_STEPS
    assert got[2] == {"capture": keys, "replay": n - warm, "eager": warm}
    assert got[3] == ref[3]          # every kernel launched, as graph nodes
    assert sum(got[4]) == n - warm and ref[4] == [0] * n


@pytest.mark.cuda
def test_an_attention_flip_captures_a_second_graph(card, tmp_path):
    cfg = _cfg(attention_warm_iter=3)
    _, _, counts, _, graph = _train(cfg, 7, tmp_path)
    assert counts == {"capture": 2, "replay": 3, "eager": 4}
    assert graph == [0, 0, 1, 0, 0, 1, 1]


@pytest.mark.cuda
def test_replacing_the_optimizer_state_drops_the_graphs(card, tmp_path):
    cfg = _cfg()
    state, step, _ = build_trainer(cfg, "cuda", seed=SEED, output_path=str(tmp_path))
    batches = synthetic_batches(cfg, "cuda", n=2, seed=SEED)
    counts = dict(step_mod.GRAPH_STEPS)
    for i in range(4):
        step(state, batches[i % 2])
    state.dis_opt.load_state_dict(copy.deepcopy(state.dis_opt.state_dict()))
    for i in range(3):
        step(state, batches[i % 2])
    torch.cuda.synchronize()
    got = {k: step_mod.GRAPH_STEPS[k] - counts[k] for k in counts}
    assert got == {"capture": 2, "replay": 3, "eager": 4}


# the launch counters' kernels by the name the profiler gives them
KERNEL_OF = {"instance_norm": "norm_fwd_cluster_kernel", "adain": "norm_fwd_cluster_kernel",
             "adain_residual": "norm_fwd_cluster_kernel",
             "layer_norm_ref": "ln_fwd_cluster_kernel",
             "instance_norm_bwd": "norm_bwd_cluster_kernel",
             "adain_bwd": "norm_bwd_cluster_kernel",
             "adain_residual_bwd": "norm_bwd_cluster_kernel",
             "layer_norm_ref_bwd": "ln_bwd_cluster_kernel",
             "lstm": "lstm_fwd_kernel", "lstm_bwd": "lstm_bwd_kernel"}


@pytest.mark.cuda
def test_a_replay_runs_the_hand_written_kernels(card, tmp_path):
    """The kernels of one replay, counted by name in a profile of it (as
    the benchmark's trace reads them), are the launches an eager step's
    counters tick, and the counters' replayed bookkeeping says the same."""
    from port_bench.yardstick.trace import profile_slice
    cfg = _cfg()
    state, step, _ = build_trainer(cfg, "cuda", seed=SEED, output_path=str(tmp_path))
    batches = synthetic_batches(cfg, "cuda", n=2, seed=SEED)
    before = dict(kernels.LAUNCHES)
    step(state, batches[0])                        # eager
    eager = {k: v - before[k] for k, v in kernels.LAUNCHES.items() if v != before[k]}
    assert set(eager) <= set(KERNEL_OF) and {"lstm", "lstm_bwd"} <= set(eager)
    for i in range(step_mod.WARM_STEPS):           # the other eager steps, the capture
        step(state, batches[(i + 1) % 2])
    counts, before = dict(step_mod.GRAPH_STEPS), dict(kernels.LAUNCHES)
    ran = profile_slice(lambda: step(state, batches[1]), 1)["kernels"]
    assert {k: step_mod.GRAPH_STEPS[k] - counts[k] for k in counts} == \
        {"capture": 0, "replay": 1, "eager": 0}
    by_name = lambda launches: {n: sum(v for k, v in launches.items() if KERNEL_OF[k] == n)
                                for n in set(KERNEL_OF.values())}
    assert {n: sum(c for k, (c, _) in ran.items() if n in k)
            for n in set(KERNEL_OF.values())} == by_name(eager)
    assert {k: v - before[k] for k, v in kernels.LAUNCHES.items() if v != before[k]} == eager
