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
def test_last_line(tmp_path, trace):
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
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(set(v) == {"value", "limit"} for v in line["checks"].values())
    json.dumps(line)


def _card() -> bool:
    import torch
    return torch.cuda.is_available()

