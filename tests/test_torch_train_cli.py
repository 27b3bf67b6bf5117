"""The port's training CLI, two steps on the CPU at `configs/smoke.yaml`
widths (synthetic batches)."""

import math
import re

import pytest
import torch

from dwcgan_tpu_torch.cli import train

torch.set_num_threads(1)

CONFIG = "configs/smoke.yaml"


def test_two_steps_on_the_cpu(capsys):
    state, metrics = train.main(["--config", CONFIG, "--synthetic_data",
                                 "--max_steps", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    m = re.search(r"Iteration: 00000002/00000002 gen (\S+) dis (\S+) lr (\S+)", out)
    assert m, out
    assert all(math.isfinite(float(v)) for v in m.groups())
    assert "Finish training" in out
    assert state.step == 2 and metrics["lr"] == pytest.approx(1e-4)
    assert state.gen.training and state.dis.training


def test_n_critic_override_runs_the_non_shared_step(capsys):
    state, metrics = train.main(["--config", CONFIG, "--synthetic_data",
                                 "--max_steps", "1", "--n_critic", "2",
                                 "--device", "cpu"])
    assert float(metrics["loss_gen_total"]) == 0.0     # G waits for step 2
    assert float(metrics["grad_dis_norm"]) > 0.0


def test_real_data_is_not_ported_yet():
    with pytest.raises(SystemExit, match="synthetic_data"):
        train.main(["--config", CONFIG, "--device", "cpu"])


def test_help_names_what_is_not_ported(capsys):
    with pytest.raises(SystemExit):
        train.main(["--help"])
    assert "Not ported yet" in capsys.readouterr().out
