"""The port's training utilities on the CPU: FiniteGuard and StallWatchdog
on tensor metrics (the cases of tests/test_guard_profiling.py), the metric
log, the image grid and the HTML gallery against the JAX package's, the
embedding table and the embedding-file reader against the JAX package's,
and the step timer."""

import builtins
import io
import json
import pickle
import time

import numpy as np
import pytest
import torch

from dwcgan_tpu.cli.train import load_pretrained_embeddings as jax_load_embeddings
from dwcgan_tpu.models.generator import build_embedding_matrix as jax_build_embedding
from dwcgan_tpu.text.vocab import Vocab as JaxVocab
from dwcgan_tpu.utils.html import write_html_gallery as jax_gallery
from dwcgan_tpu.utils.images import make_grid as jax_make_grid
from dwcgan_tpu_torch.cli.train import load_pretrained_embeddings
from dwcgan_tpu_torch.config import load_config
from dwcgan_tpu_torch.models.generator import build_embedding_matrix
from dwcgan_tpu_torch.text.vocab import Vocab
from dwcgan_tpu_torch.utils import images
from dwcgan_tpu_torch.utils.guard import (FiniteGuard, NonFiniteLossError,
                                          StallWatchdog)
from dwcgan_tpu_torch.utils.html import write_html_gallery
from dwcgan_tpu_torch.utils.logging import MetricWriter
from dwcgan_tpu_torch.utils.timer import StepTimer

torch.set_num_threads(1)

T = lambda v: torch.tensor(v, dtype=torch.float32)   # a 0-d metric, as the step's


class _FakeCkpt:
    def __init__(self):
        self.saved = False

    def save(self, state):
        self.saved = True

    def latest_step(self):
        return 42


def test_guard_passes_finite():
    g = FiniteGuard(every=10, patience=1)
    for step in range(1, 50):
        assert g.check(step, {"loss_gen_total": T(1.0), "loss_dis_all": T(2.0),
                              "lr": 1e-4})


def test_guard_trips_on_persistent_nan_without_saving():
    g = FiniteGuard(every=10, patience=2)
    ckpt = _FakeCkpt()
    bad = {"loss_gen_total": T(float("nan")), "loss_dis_all": T(1.0)}
    assert not g.check(10, bad)
    with pytest.raises(NonFiniteLossError, match="step 42"):
        g.check(20, bad, checkpoint=ckpt, state=object())
    assert not ckpt.saved


def test_guard_recovers_after_transient():
    g = FiniteGuard(every=1, patience=3)
    g.check(1, {"loss_gen_total": T(float("inf"))})
    assert g.check(2, {"loss_gen_total": T(0.5)})
    assert g._strikes == 0


class _Unreadable:
    """A metric whose reading (the device sync) fails the test."""

    def __float__(self):
        raise AssertionError("read off the guard's cadence")


def test_guard_reads_metrics_only_on_its_cadence():
    g = FiniteGuard(every=100, patience=1)
    for step in range(1, 100):
        assert g.check(step, {"loss_gen_total": _Unreadable()})
    with pytest.raises(NonFiniteLossError):
        g.check(100, {"loss_gen_total": T(float("nan"))})


def test_guard_watches_grad_norms():
    g = FiniteGuard(every=1, patience=1)
    ok = {"loss_gen_total": T(1.0), "loss_dis_all": T(1.0),
          "grad_gen_norm": T(2.0), "grad_dis_norm": T(3.0)}
    assert g.check(1, ok)
    with pytest.raises(NonFiniteLossError, match="grad_gen_norm"):
        g.check(2, {**ok, "grad_gen_norm": T(float("nan"))})


def test_guard_patience_window_worst_case():
    g = FiniteGuard(every=100, patience=2)
    bad = {"loss_gen_total": T(float("nan"))}
    for step in range(1, 200):
        assert g.check(step, bad) == (step % 100 != 0)
    with pytest.raises(NonFiniteLossError):
        g.check(200, bad)


def test_guard_config_knobs():
    cfg = load_config("configs/smoke.yaml")
    cfg.guard_every, cfg.guard_patience = 7, 3
    g = FiniteGuard(every=cfg.guard_every or cfg.log_iter, patience=cfg.guard_patience)
    assert (g.every, g.patience) == (7, 3)
    cfg.guard_every = 0
    assert FiniteGuard(every=cfg.guard_every or cfg.log_iter).every == cfg.log_iter


def test_stall_watchdog_fires_and_silences():
    buf = io.StringIO()
    wd = StallWatchdog(timeout_s=0.3, out=buf)
    try:
        for _ in range(4):
            wd.beat(1)
            time.sleep(0.1)
        assert wd.stall_warnings == 0
        time.sleep(1.0)
        assert wd.stall_warnings >= 1
        out = buf.getvalue()
        assert "NO PROGRESS" in out and "last completed step: 1" in out
    finally:
        wd.stop()
    n = wd.stall_warnings
    time.sleep(0.6)
    assert wd.stall_warnings == n
    wd._thread.join(timeout=5)
    assert not wd._thread.is_alive()


def test_metric_writer_appends_json_lines(tmp_path):
    w = MetricWriter(str(tmp_path))
    try:
        w.write(1, {"loss_gen_total": T(1.5), "lr": 1e-4})
        w.write(2, {"loss_gen_total": T(float("nan")), "lr": 1e-4})
    finally:
        w.close()
    rows = [json.loads(ln) for ln in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2]
    assert rows[0]["loss_gen_total"] == 1.5 and rows[0]["lr"] == 1e-4
    assert np.isnan(rows[1]["loss_gen_total"]) and "time" in rows[0]


def test_metric_writer_without_tensorboard_writes_json_only(tmp_path, monkeypatch, capsys):
    real_import = builtins.__import__

    def no_tensorboard(name, *args, **kw):
        if name.startswith("torch.utils.tensorboard"):
            raise ImportError("no tensorboard")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_tensorboard)
    w = MetricWriter(str(tmp_path))
    for s in range(3):
        w.write(s, {"x": T(float(s))})
    w.close()
    assert w._tb is None
    assert sorted(p.name for p in tmp_path.iterdir()) == ["metrics.jsonl"]
    assert len((tmp_path / "metrics.jsonl").read_text().splitlines()) == 3
    out = capsys.readouterr()
    assert out.out == "" and out.err == ""


def test_make_grid_matches_jax():
    rng = np.random.default_rng(0)
    rows = [rng.uniform(-1, 1, (5, 8, 6, 3)).astype(np.float32) for _ in range(4)]
    got = images.make_grid(rows, 4)
    assert got.shape == (32, 24, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jax_make_grid(rows, 4))


def test_save_image_grid_falls_back_to_npy_without_pil(tmp_path, monkeypatch):
    rows = [np.zeros((2, 4, 4, 3), np.float32), np.ones((2, 4, 4, 3), np.float32)]
    images.save_image_grid(rows, 2, str(tmp_path / "a.jpg"))
    assert (tmp_path / "a.jpg").exists()
    real_import = builtins.__import__

    def no_pil(name, *args, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    images.save_image_grid(rows, 2, str(tmp_path / "b.jpg"))
    np.testing.assert_array_equal(np.load(tmp_path / "b.jpg.npy"),
                                  images.make_grid(rows, 2))


def test_gallery_matches_jax(tmp_path):
    write_html_gallery(str(tmp_path / "a.html"), 6, 3)
    jax_gallery(str(tmp_path / "b.html"), 6, 3)
    text = (tmp_path / "a.html").read_text()
    assert text.replace("a.html", "b.html") == (tmp_path / "b.html").read_text()
    assert "images/test_00000006.jpg" in text and "images/train_00000003.jpg" in text


@pytest.mark.parametrize("pretrained", [None, {"smile": np.arange(12.0), "her": -np.ones(12)}])
def test_embedding_matrix_matches_jax(pretrained):
    ours = build_embedding_matrix(Vocab("CelebA"), 12, pretrained, seed=3)
    theirs = jax_build_embedding(JaxVocab("CelebA"), 12, pretrained, seed=3)
    assert ours.dtype == np.float32 and ours.shape == (Vocab("CelebA").size, 12)
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("fmt", ["pickle", "npz", "npy"])
def test_embedding_files_read_as_jax_reads_them(tmp_path, fmt):
    words = {"smile": np.arange(4, dtype=np.float32), "her": np.ones(4, np.float32)}
    path = tmp_path / f"emb.{fmt}"
    if fmt == "pickle":
        path.write_bytes(pickle.dumps(words))
    elif fmt == "npz":
        np.savez(path, **words)
    else:
        np.save(path, np.array(words, dtype=object), allow_pickle=True)
    ours, theirs = load_pretrained_embeddings(str(path)), jax_load_embeddings(str(path))
    assert ours.keys() == theirs.keys() == words.keys()
    for k in words:
        np.testing.assert_array_equal(ours[k], theirs[k])


def test_embedding_file_missing_or_unreadable(tmp_path):
    assert load_pretrained_embeddings(None) is None
    assert load_pretrained_embeddings(str(tmp_path / "absent.npy")) is None
    np.save(tmp_path / "plain.npy", np.zeros(3))
    assert load_pretrained_embeddings(str(tmp_path / "plain.npy")) is None


def test_step_timer_fetches_its_tensor():
    class Probe:
        fetched = 0

        def cpu(self):
            Probe.fetched += 1
            return self

    t = StepTimer()
    assert t.lap() == 0.0
    time.sleep(0.01)
    assert t.lap(Probe()) >= 0.01 and Probe.fetched == 1
