"""The port's training CLI on the CPU at `configs/smoke.yaml` widths: a few
steps on synthetic, procedural and CelebA-format data with the run's
artifacts (metric log, sample grid, gallery, checkpoint), two same-seed
runs logging the same rows, a stop and `--resume 1` bit-equal to the run
it interrupts, frozen pretrained embeddings, a warm start, a tripped NaN
guard, the profiler's trace, and `cli/translate.py --checkpoint` serving
what the run saved."""

import json
import math
import os
import pickle
import re

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from dwcgan_tpu_torch.cli import train, translate
from dwcgan_tpu_torch.models.generator import build_embedding_matrix
from dwcgan_tpu_torch.text.vocab import Vocab

torch.set_num_threads(1)

CONFIG = "configs/smoke.yaml"
RATES = {"time", "steps_per_sec", "images_per_sec"}


def write_config(path, **over):
    """smoke.yaml with `over`, under `path` (its stem names the run)."""
    with open(CONFIG) as f:
        cfg = yaml.safe_load(f)
    cfg.update(over)
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def run(cfg_path, out, *extra):
    return train.main(["--config", cfg_path, "--output_path", str(out),
                       "--device", "cpu", *extra])


def metric_rows(out, name):
    with open(os.path.join(out, "logs", name, "metrics.jsonl")) as f:
        return [json.loads(ln) for ln in f]


def checkpoint(out, name, step):
    return torch.load(os.path.join(out, "outputs", name, "checkpoints",
                                   f"ckpt_{step:08d}.pt"), weights_only=True)


def assert_same(a, b, path=""):
    """Two saved states equal to the bit, tensor by tensor."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif torch.is_tensor(a):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    else:
        assert a == b, (path, a, b)


def test_two_steps_on_the_cpu(capsys, tmp_path):
    state, metrics = train.main(["--config", CONFIG, "--synthetic_data",
                                 "--max_steps", "2", "--device", "cpu",
                                 "--output_path", str(tmp_path)])
    out = capsys.readouterr().out
    m = re.search(r"Iteration: 00000002/00000002 gen (\S+) dis (\S+) lr (\S+)", out)
    assert m, out
    assert all(math.isfinite(float(v)) for v in m.groups())
    assert "Finish training" in out
    assert state.step == 2 and metrics["lr"] == pytest.approx(1e-4)
    assert state.gen.training and state.dis.training


def test_n_critic_override_runs_the_non_shared_step(tmp_path):
    state, metrics = train.main(["--config", CONFIG, "--synthetic_data",
                                 "--max_steps", "1", "--n_critic", "2",
                                 "--device", "cpu", "--output_path", str(tmp_path)])
    assert float(metrics["loss_gen_total"]) == 0.0     # G waits for step 2
    assert float(metrics["grad_dis_norm"]) > 0.0


def test_procedural_data_writes_the_run_artifacts(tmp_path, capsys):
    """3 steps on procedural faces: the artifacts of the JAX CLI's smoke
    run (tests/test_sampler_checkpoint.py::test_cli_smoke) and the rest of
    its layout."""
    cfg = write_config(tmp_path / "cli_smoke.yaml", log_iter=1, image_display_iter=2,
                       image_save_iter=3, snapshot_save_iter=2, display_size=4)
    state, _ = run(cfg, tmp_path, "--procedural_data", "--procedural_size", "64",
                   "--max_steps", "3")
    out = tmp_path / "outputs" / "cli_smoke"
    for name in ("train_current.jpg", "test_00000003.jpg", "train_00000003.jpg"):
        grid = np.asarray(Image.open(out / "images" / name))
        assert grid.shape == (5 * 32, 4 * 32, 3), name   # 5 rows of 4 samples
    assert (out / "index.html").exists() and (out / "config.yaml").exists()
    assert sorted(os.listdir(out / "checkpoints")) == ["ckpt_00000002.pt",
                                                       "ckpt_00000003.pt"]
    rows = metric_rows(tmp_path, "cli_smoke")
    assert [r["step"] for r in rows] == [1, 2, 3] and state.step == 3
    assert all(math.isfinite(v) for r in rows for v in r.values())
    assert {"steps_per_sec", "images_per_sec", "loss_gen_total"} <= rows[0].keys()
    assert "Finish training" in capsys.readouterr().out


def test_help_names_what_is_still_missing(capsys):
    with pytest.raises(SystemExit):
        train.main(["--help"])
    out = capsys.readouterr().out
    flat = "".join(out.split())          # argparse wraps at spaces and hyphens
    assert "Notported" not in flat       # tensor parallelism was the last
    assert "dataandtensorparallel" in flat and "torch.distributed.run" in flat
    assert "--mesh_modelM" in flat
    assert "dwcgan_tpu_torch.cli.evaluate" in flat
    for flag in ("--procedural_data", "--resume", "--output_path", "--profile_dir",
                 "--use_pretrained_embed", "--mesh_model"):
        assert flag in out


def test_two_same_seed_runs_log_the_same_rows(tmp_path):
    """The port's tests/test_run_determinism.py: the threaded pipeline (2
    workers), the step, the optimizers and the EMA, run twice."""
    cfg = write_config(tmp_path / "det.yaml", log_iter=1, num_workers=2)
    for out in ("a", "b"):
        run(cfg, tmp_path / out, "--procedural_data", "--procedural_size", "48",
            "--max_steps", "4")
    rows_a, rows_b = metric_rows(tmp_path / "a", "det"), metric_rows(tmp_path / "b", "det")
    assert len(rows_a) == len(rows_b) == 4
    for ra, rb in zip(rows_a, rows_b):
        assert ra.keys() == rb.keys()
        assert {k: v for k, v in ra.items() if k not in RATES} == \
            {k: v for k, v in rb.items() if k not in RATES}


def _resume_bit_equal(tmp_path, capsys, cfg):
    data = ("--procedural_data", "--procedural_size", "48")
    straight, _ = run(cfg, tmp_path / "a", *data, "--max_steps", "4")
    run(cfg, tmp_path / "b", *data, "--max_steps", "2")
    resumed, _ = run(cfg, tmp_path / "b", *data, "--max_steps", "4", "--resume", "1")
    assert "Resume from iteration 2" in capsys.readouterr().out
    assert straight.step == resumed.step == 4
    assert_same(checkpoint(tmp_path / "a", "res", 4), checkpoint(tmp_path / "b", "res", 4))
    assert torch.equal(straight.rng.get_state(), resumed.rng.get_state())
    rows_a, rows_b = metric_rows(tmp_path / "a", "res"), metric_rows(tmp_path / "b", "res")
    assert [r["step"] for r in rows_b] == [1, 2, 3, 4]
    for ra, rb in zip(rows_a, rows_b):
        assert {k: v for k, v in ra.items() if k not in RATES} == \
            {k: v for k, v in rb.items() if k not in RATES}
    return straight


def test_resume_continues_the_run_bit_equal(tmp_path, capsys):
    """4 steps straight equal 2 steps, a stop, `--resume 1` and 2 more:
    every tensor of the final state, and the logged metrics."""
    cfg = write_config(tmp_path / "res.yaml", log_iter=1, snapshot_save_iter=100)
    _resume_bit_equal(tmp_path, capsys, cfg)


def test_resume_with_prelu_and_spectral_norm_is_bit_equal(tmp_path, capsys):
    """The same with `gen.activ: prelu` and `dis.norm: sn`: the PReLU slopes
    and the raw spectral-norm kernels go through Adam, EMA and the
    checkpoint like any other parameter."""
    with open(CONFIG) as f:
        base = yaml.safe_load(f)
    cfg = write_config(tmp_path / "res.yaml", log_iter=1, snapshot_save_iter=100,
                       gen={**base["gen"], "activ": "prelu"},
                       dis={**base["dis"], "norm": "sn"})
    state = _resume_bit_equal(tmp_path, capsys, cfg)
    slopes = [p for n, p in state.gen.named_parameters()
              if n.endswith("activation.weight")]
    assert slopes and all(float(p) != 0.25 for p in slopes)
    assert "cnns_feat.0.1.conv.weight" in state.dis.state_dict()


def test_pretrained_embeddings_load_and_stay_frozen(tmp_path, capsys):
    vocab = Vocab("CelebA")
    words = {w: np.full(12, i, np.float32) for i, w in enumerate(vocab.itos[5:15])}
    (tmp_path / "emb.pkl").write_bytes(pickle.dumps(words))
    cfg = write_config(tmp_path / "emb.yaml", pretrained_embed=str(tmp_path / "emb.pkl"))
    state, _ = run(cfg, tmp_path, "--synthetic_data", "--max_steps", "2")
    assert f"loaded pretrained embeddings for vocab of {vocab.size}" in capsys.readouterr().out
    table = torch.from_numpy(build_embedding_matrix(vocab, 12, words, seed=1234))
    emb = state.gen.enc_txt.embed_tokens.weight
    assert torch.equal(emb, table) and torch.equal(state.ema_gen.enc_txt.embed_tokens.weight, table)
    assert all(p is not emb for g in state.gen_opt.param_groups for p in g["params"])
    # and with --use_pretrained_embed 0 the table stays the random init
    state0, _ = run(cfg, tmp_path / "off", "--synthetic_data", "--max_steps", "1",
                    "--use_pretrained_embed", "0")
    assert not torch.equal(state0.gen.enc_txt.embed_tokens.weight, table)


def test_celeba_files_train_through_the_cli(tmp_path):
    """CelebA-format data (a generated attribute file and PNGs, 44 x 40,
    crop 40) through the CLI, and the missing-attribute-file fallback."""
    rng = np.random.default_rng(1)
    attrs = ("Black_Hair", "Blond_Hair", "Brown_Hair", "Male", "Smiling", "Young",
             "Eyeglasses", "No_Beard")
    lines = ["24", " ".join(attrs)]
    (tmp_path / "img").mkdir()
    for i in range(24):
        Image.fromarray(rng.integers(0, 256, (40, 44, 3), dtype=np.uint8)).save(
            tmp_path / "img" / f"{i}.png")
        lines.append(f"{i}.png " + " ".join(rng.choice(["1", "-1"], 8)))
    (tmp_path / "attrs.txt").write_text("\n".join(lines) + "\n")
    cfg = write_config(tmp_path / "celeb.yaml", data_root=str(tmp_path / "img"),
                       attr_path=str(tmp_path / "attrs.txt"), test_split=8)
    state, metrics = run(cfg, tmp_path, "--max_steps", "2")
    assert state.step == 2 and math.isfinite(float(metrics["loss_gen_total"]))
    assert (tmp_path / "outputs" / "celeb" / "images" / "train_current.jpg").exists()


def test_missing_attribute_file_falls_back_to_synthetic_data(tmp_path, capsys):
    cfg = write_config(tmp_path / "noattr.yaml", attr_path=str(tmp_path / "absent.txt"))
    run(cfg, tmp_path, "--max_steps", "1")
    assert "not found -> synthetic data" in capsys.readouterr().out


def test_translate_serves_the_saved_checkpoint(tmp_path):
    cfg = write_config(tmp_path / "srv.yaml", snapshot_save_iter=1)
    state, _ = run(cfg, tmp_path, "--synthetic_data", "--max_steps", "2")
    ckpt_dir = tmp_path / "outputs" / "srv" / "checkpoints"
    img = np.random.default_rng(0).integers(0, 256, (40, 40, 3), dtype=np.uint8)
    Image.fromarray(img).save(tmp_path / "a.png")
    (tmp_path / "edits.tsv").write_text("a.png\tmake her smile\na.png\tadd eyeglasses\n")
    args = ["--config", cfg, "--list", str(tmp_path / "edits.tsv"),
            "--image_dir", str(tmp_path), "--device", "cpu"]
    translate.main(args + ["--checkpoint", str(ckpt_dir), "--out_dir", str(tmp_path / "ema")])
    assert sorted(os.listdir(tmp_path / "ema")) == ["000000_a.png", "000001_a.png"]

    # the loader: the EMA generator by default, the raw one with use_ema 0,
    # a step of the directory or one file
    from dwcgan_tpu_torch.config import load_config
    from dwcgan_tpu_torch.models.generator import build_generator
    tcfg, vocab = load_config(cfg), Vocab("CelebA")
    gen = build_generator(tcfg, vocab.size, device="cpu")
    assert translate.load_checkpoint(gen, tcfg, vocab.size, str(ckpt_dir)) == 2
    assert_same(gen.state_dict(), state.ema_gen.state_dict())
    assert translate.load_checkpoint(gen, tcfg, vocab.size, str(ckpt_dir), step=1,
                                     use_ema=False) == 1
    assert translate.load_checkpoint(gen, tcfg, vocab.size,
                                     str(ckpt_dir / "ckpt_00000002.pt"), use_ema=False) == 2
    assert_same(gen.state_dict(), state.gen.state_dict())
    tcfg.compute_dtype = "bfloat16"
    with pytest.raises(ValueError, match="compute_dtype"):
        translate.load_checkpoint(gen, tcfg, vocab.size, str(ckpt_dir))
    with pytest.raises(SystemExit):   # --weights and --checkpoint exclude each other
        translate.main(args + ["--checkpoint", str(ckpt_dir), "--weights", "w.npz",
                               "--out_dir", str(tmp_path / "x")])


def test_a_tripped_guard_stops_the_run_without_a_snapshot(tmp_path, monkeypatch):
    """Non-finite losses from step 3 on: the guard (every step, patience
    2) raises at step 4, and the last snapshot stays step 2's."""
    from dwcgan_tpu_torch.utils.guard import NonFiniteLossError
    real = train.make_train_step

    def poisoned(*args, **kw):
        step = real(*args, **kw)

        def run_step(state, batch, **kw2):
            m = step(state, batch, **kw2)
            if state.step >= 3:
                m["loss_gen_total"] = torch.tensor(float("nan"))
            return m
        return run_step

    monkeypatch.setattr(train, "make_train_step", poisoned)
    cfg = write_config(tmp_path / "nan.yaml", guard_every=1, guard_patience=2,
                       snapshot_save_iter=2)
    with pytest.raises(NonFiniteLossError, match="step 4.*step 2"):
        run(cfg, tmp_path, "--synthetic_data", "--max_steps", "6")
    assert sorted(os.listdir(tmp_path / "outputs" / "nan" / "checkpoints")) == \
        ["ckpt_00000002.pt"]


def test_use_pretrain_warm_starts_from_another_run(tmp_path, capsys):
    donor_cfg = write_config(tmp_path / "donor.yaml")
    donor, _ = run(donor_cfg, tmp_path, "--synthetic_data", "--max_steps", "1")
    cfg = write_config(tmp_path / "warm.yaml", use_pretrain=True, gen_pretrain=str(
        tmp_path / "outputs" / "donor" / "checkpoints"))
    warm, _ = run(cfg, tmp_path, "--synthetic_data", "--max_steps", "0")
    assert "Initial model loaded..." in capsys.readouterr().out
    emb = "enc_txt.embed_tokens.weight"
    for name, p in warm.gen.named_parameters():
        assert torch.equal(p, donor.gen.state_dict()[name]) == (name != emb), name
    assert warm.step == 0 and not warm.gen_opt.state


def test_profile_dir_writes_a_trace_of_steps_10_to_20(tmp_path, capsys):
    run(CONFIG, tmp_path, "--synthetic_data", "--max_steps", "12",
        "--profile_dir", str(tmp_path / "prof"))
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    assert "profiler trace written to" in capsys.readouterr().out
