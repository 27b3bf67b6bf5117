"""The port's span recorder (`utils/profiling.py`) on the CPU: nesting,
parents and root ids, one stack per thread, the ring's bound and its drop
report, no `record_function` without a profiler, the spans as
`user_annotation` events of a CPU `torch.profiler` trace, and the spans
that one smoke training step, one served batch and the feed record."""

import json
import threading
import time

import numpy as np
import pytest
import torch

from dwcgan_tpu_torch.cli.train import build_trainer
from dwcgan_tpu_torch.cli.translate import synthetic_requests, translate_batch
from dwcgan_tpu_torch.config import load_config
from dwcgan_tpu_torch.data.pipeline import DataPipeline, synthetic_batch, to_device
from dwcgan_tpu_torch.models.generator import build_generator
from dwcgan_tpu_torch.text.vocab import Vocab
from dwcgan_tpu_torch.train.sampler import make_infer_fn
from dwcgan_tpu_torch.utils import profiling
from dwcgan_tpu_torch.utils.profiling import Recorder

torch.set_num_threads(1)

CONFIG = "configs/smoke.yaml"

# the shared step (`fuse_gd_forward`, n_critic 1) and the non-shared one,
# in the order the spans start
SHARED = ["train.step", "train.g_forward", "gen.encode", "gen.encode_txt", "gen.decode",
          "gen.encode", "gen.decode", "loss.vgg", "train.d_update", "train.d_backward",
          "train.adam_d", "train.g_update", "train.g_backward", "train.adam_g", "train.ema"]
SPLIT = ["train.step", "gen.encode", "gen.encode_txt", "gen.decode", "train.d_update",
         "train.d_backward", "train.adam_d", "train.g_forward", "gen.encode",
         "gen.encode_txt", "gen.decode", "gen.encode", "gen.decode", "loss.vgg",
         "train.g_update", "train.g_backward", "train.adam_g", "train.ema"]
PARENT = {"train.g_forward": "train.step", "train.d_update": "train.step",
          "train.g_update": "train.step", "train.ema": "train.step",
          "train.d_backward": "train.d_update", "train.adam_d": "train.d_update",
          "train.g_backward": "train.g_update", "train.adam_g": "train.g_update",
          "loss.vgg": "train.g_forward"}


def since(t_ns):
    return [s for s in profiling.RECORDER.spans() if s.t0 >= t_ns]


def test_spans_nest_with_parents_and_root_ids():
    rec = Recorder()
    with rec.span("a") as a:
        with rec.span("b", ready=3) as b:
            with rec.span("c"):
                pass
        with rec.span("d"):
            pass
    with rec.span("e") as e:
        pass
    got = {s.name: s for s in rec.spans()}
    assert [s.name for s in rec.spans()] == ["a", "b", "c", "d", "e"]
    assert got["a"].parent == 0 and got["a"].root == a.id
    assert got["b"].parent == a.id and got["c"].parent == b.id and got["d"].parent == a.id
    assert {got[k].root for k in "abcd"} == {a.id}
    assert got["e"].parent == 0 and got["e"].root == e.id != a.id
    assert got["b"].counts == {"ready": 3} and got["a"].counts == {}
    assert got["a"].t0 <= got["b"].t0 <= got["c"].t0 <= got["c"].t1 <= got["b"].t1 <= got["a"].t1
    assert rec.totals()["a"][0] == 1 and rec.totals()["a"][1] == got["a"].t1 - got["a"].t0


def test_each_thread_keeps_its_own_stack():
    rec = Recorder()
    opened, done = threading.Barrier(3), threading.Barrier(3)

    def worker(name):
        with rec.span(name):
            opened.wait(timeout=10)
            with rec.span(name + ".inner"):
                done.wait(timeout=10)

    threads = [threading.Thread(target=worker, args=(n,)) for n in ("t1", "t2")]
    with rec.span("main") as main:
        for t in threads:
            t.start()
        opened.wait(timeout=10)
        with rec.span("main.inner"):
            done.wait(timeout=10)
        for t in threads:
            t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    got = {s.name: s for s in rec.spans()}
    for n in ("t1", "t2"):
        assert got[n].parent == 0 and got[n].root == got[n].id != main.id
        assert got[n + ".inner"].parent == got[n].id and got[n + ".inner"].root == got[n].id
        assert got[n].thread == got[n + ".inner"].thread != got["main"].thread
    assert got["main.inner"].parent == main.id
    assert len({got[n].thread for n in ("t1", "t2", "main")}) == 3


def test_the_ring_keeps_its_bound_and_reports_drops():
    rec = Recorder(capacity=4)
    marks = {}
    for i in range(10):
        marks[i] = time.perf_counter_ns()
        with rec.span(f"s{i}"):
            pass
    assert [s.name for s in rec.spans()] == ["s6", "s7", "s8", "s9"]
    assert rec.totals()["s0"][0] == 1 and len(rec.totals()) == 10
    assert rec.dropped_since(marks[5])       # s5, overwritten, ended after it
    assert not rec.dropped_since(marks[6])   # nothing overwritten ended after s6 began
    fresh = Recorder(capacity=4)
    with fresh.span("x"):
        pass
    assert not fresh.dropped_since(0)
    assert profiling.RING >= 1 << 15 and profiling.RECORDER.capacity == profiling.RING


def test_no_record_function_without_a_profiler(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function called with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    rec = Recorder()
    with rec.span("a"):
        with rec.span("b"):
            pass
    assert [s.name for s in rec.spans()] == ["a", "b"]


def test_spans_are_user_annotations_of_a_cpu_profile(tmp_path):
    rec = Recorder()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with rec.span("outer.span"):
            torch.ones(4).sum()
            with rec.span("inner.span"):
                torch.ones(4).mul(2)
    with rec.span("after.span"):      # the profiler is off again
        pass
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ann = {e["name"]: e for e in events if e.get("cat") == "user_annotation"}
    assert {"outer.span", "inner.span"} <= set(ann) and "after.span" not in ann
    o, i = ann["outer.span"], ann["inner.span"]
    assert o["tid"] == i["tid"]
    assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"]
    got = {s.name: s for s in rec.spans()}
    assert got["inner.span"].parent == got["outer.span"].id


def _smoke_cfg(**over):
    cfg = load_config(CONFIG)
    cfg.vgg_w, cfg.vgg_random_fallback, cfg.batch_size = 0.1, True, 2
    for k, v in over.items():
        setattr(cfg, k, v)
    return cfg


@pytest.mark.parametrize("fuse, want", [(True, SHARED), (False, SPLIT)],
                         ids=["shared", "split"])
def test_a_train_step_records_its_phases(tmp_path, fuse, want):
    cfg = _smoke_cfg(fuse_gd_forward=fuse)
    t = time.perf_counter_ns()
    state, step_fn, _ = build_trainer(cfg, "cpu", output_path=str(tmp_path))
    setup = since(t)
    assert [s.name for s in setup] == ["setup.build_trainer", "setup.build_generator"]
    assert setup[1].parent == setup[0].id
    for i in range(2):
        batch = synthetic_batch(2, cfg.image_size, cfg.gen.num_cls, cfg.max_text_len, seed=i)
        t = time.perf_counter_ns()
        step_fn(state, to_device(batch, "cpu"))
        spans = since(t)
        assert [s.name for s in spans] == ["data.to_device"] + want
        root = spans[1]
        assert root.parent == 0 and spans[0].root != root.id
        assert root.counts == {"graph": 0}     # the CPU runs every step eagerly
        assert all(s.root == root.id for s in spans[1:])
        by_id = {s.id: s.name for s in spans}
        for s in spans[2:]:
            if s.name.startswith("gen."):
                assert by_id[s.parent] in ("train.step", "train.g_forward"), s.name
            else:
                assert by_id[s.parent] == PARENT[s.name], s.name


def test_translate_batch_records_its_spans():
    cfg = load_config(CONFIG)
    vocab = Vocab(cfg.dataset)
    gen = build_generator(cfg, vocab.size, device="cpu")
    infer = make_infer_fn(cfg, gen)
    imgs, cmds = synthetic_requests(2, cfg.image_size, seed=3)
    t = time.perf_counter_ns()
    out = translate_batch(infer, imgs, cmds, vocab, cfg.max_text_len, torch.device("cpu"))
    assert out.shape == imgs.shape
    spans = since(t)
    assert [s.name for s in spans] == ["translate.batch", "translate.to_device",
                                       "gen.encode", "gen.encode_txt", "gen.decode"]
    root = spans[0]
    assert root.parent == 0 and all(s.root == root.id for s in spans)
    assert all(s.parent == root.id for s in spans[1:])


class _Items:
    """A map-style dataset of fixed small items (the 5-tuple of a row)."""

    def __len__(self):
        return 64

    def __getitem__(self, i):
        return (np.full((4, 4, 3), i, np.float32), np.zeros(8, np.float32),
                np.ones(8, np.float32), np.arange(6), np.int64(6))


def test_data_next_reports_the_batches_ready():
    pipe = DataPipeline(_Items(), 4, num_workers=2, prefetch=4, seed=0)
    batches = iter(pipe)
    t = time.perf_counter_ns()
    try:
        first = next(batches)
        time.sleep(1.0)        # the workers fill the queue meanwhile
        second = next(batches)
    finally:
        batches.close()
    spans = [s for s in since(t) if s.name == "data.next"]
    assert len(spans) == 2 and all(s.parent == 0 for s in spans)
    assert all(set(s.counts) == {"ready"} and s.counts["ready"] >= 0 for s in spans)
    assert spans[1].counts["ready"] >= 1
    assert first.image.shape == second.image.shape == (4, 4, 4, 3)
