"""`correct` comes out false when the timed path is broken underneath
(the harness's look for a card skipped, the rest of a run driven on the
CPU at smoke widths), once per fault each cell can have, and for the
control put in the program's place."""

import pytest

import _smoke  # noqa: F401
from _smoke import smoke_run
from port_bench import faults
from port_bench import run as runmod


def test_sound_runs_are_correct(tmp_path):
    for kind in ("train", "serve", "edit"):
        assert runmod.execute(smoke_run(kind, tmp_path), 0.0)["correct"], kind


@pytest.mark.parametrize("kind, fault", [("train", "unchanged"), ("train", "half_batch"),
                                         ("serve", "altered_answer"),
                                         ("edit", "altered_answer")])
def test_fault_is_caught(tmp_path, kind, fault):
    run = smoke_run(kind, tmp_path, wrap=faults.FAULTS[fault])
    line = runmod.execute(run, 0.0)
    assert line["correct"] is False
    assert any(v["value"] > v["limit"] for v in line["checks"].values())


@pytest.mark.parametrize("kind", ["train", "serve"])
def test_control_fails_a_limit(tmp_path, kind):
    """The reference in float8 (e4m3 forward, e5m2 backward) in the
    program's place reads past at least one of the cell's limits."""
    run = smoke_run(kind, tmp_path, control=True)
    line = runmod.execute(run, 0.0)
    limits = run.cell["limits"]
    assert any(line["control"][k] > limits[k] for k in limits), line["control"]
