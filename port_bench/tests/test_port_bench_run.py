"""The command's arguments, its refusal without a card, and the shape of
the last line of a run (driven on the CPU at smoke widths)."""

import json
import subprocess
import sys

import pytest

import _smoke  # noqa: F401  (the repository on the path)
from _smoke import ROOT, smoke_run
from port_bench import core
from port_bench import run as runmod


def test_arguments():
    a = runmod.parse_args(["--workload", "celeba128.edit-b1", "--seed", str(2 ** 33 + 5),
                           "--seconds", "30", "--trace", "1"])
    assert (a.workload, a.seed, a.seconds, a.trace) == ("celeba128.edit-b1", 2 ** 33 + 5, 30.0, 1)
    for bad in (["--seed", "1", "--seconds", "3"],                        # no workload
                ["--workload", "x", "--seed", "1.5", "--seconds", "3"],   # seed not whole
                ["--workload", "x", "--seed", "1", "--seconds", "0"],
                ["--workload", "x", "--seed", "1", "--seconds", "3", "--trace", "2"]):
        with pytest.raises(SystemExit):
            runmod.parse_args(bad)


def test_no_card_no_result(tmp_path):
    """Without a CUDA card the command exits 2 and prints nothing on
    standard output (it never falls back to the CPU)."""
    if _card():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                          "celeba128.serve-b32", "--seed", "7", "--seconds", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and out.stdout == ""
    assert "CUDA card" in out.stderr


def test_unknown_workload_fails(tmp_path):
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "no-such-cell",
                          "--seed", "7", "--seconds", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.parametrize("trace", [False, True])
def test_last_line(tmp_path, monkeypatch, trace):
    from port_bench.yardstick import readers
    if trace and not _card():
        # the CPU runs no device operation: its operators stand in for the
        # device's, busy for most of the profiled slice (0.6 to 1.03 of the
        # window's period), which the profiler slows
        from port_bench.yardstick import trace as tracemod
        monkeypatch.setattr(tracemod, "DEVICE_CATS", tracemod.DEVICE_CATS + ("cpu_op",))
    seen = []

    def window_busy_s(rec):
        seen.append(rec)
        return window_busy_s.read(rec)
    window_busy_s.read = readers.window_busy_s
    monkeypatch.setattr(readers, "window_busy_s", window_busy_s)
    line = runmod.execute(smoke_run("serve", tmp_path, trace=trace), t_start=0.0)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    cell = smoke_run("serve", tmp_path).cell
    want = cell["per_layer"] if trace else cell["end_to_end"]
    assert set(line["metrics"]) <= set(want)
    if not trace:
        assert set(line["metrics"]) == set(want)
    for name, m in line["metrics"].items():
        assert m["unit"] == core.load_metric(name).UNIT and m["value"] == m["value"]
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        # busy is the slice's time per batch times the window's batches,
        # capped at the window only within the tolerance
        tr, units = seen[-1]["trace"], seen[-1]["units"]
        busy, window = line["device"]["busy_s"], line["device"]["window_s"]
        raw = tr["busy_s"] / tr["units"] * units
        assert line["metrics"]["device_busy_ms.serve"]["value"] == 1e3 * (tr["busy_s"] / tr["units"])
        if raw <= window * readers.SATURATED_UP_TO:
            assert 0 < busy <= window and busy == min(raw, window)
        else:
            assert busy == raw > window
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(set(v) == {"value", "limit"} for v in line["checks"].values())
    json.dumps(line)


def _card() -> bool:
    import torch
    return torch.cuda.is_available()

