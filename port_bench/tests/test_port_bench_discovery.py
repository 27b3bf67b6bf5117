"""A configuration, a traffic mix, a cell and a per-layer metric are
added as new files only: the harness finds each by its name."""

import json
import shutil

import _smoke  # noqa: F401
from _smoke import SEED, smoke_config
from port_bench import core
from port_bench import run as runmod


def test_new_files_are_found(tmp_path):
    base = tmp_path / "bench"
    for d in ("configs", "traffic", "workloads", "metrics"):
        (base / d).mkdir(parents=True)
    shutil.copytree(core.BENCH_DIR / "drivers", base / "drivers")
    shutil.copy(core.BENCH_DIR / "metrics" / "serve_images_per_s.py", base / "metrics")
    (base / "configs" / "tiny-gan.json").write_text(json.dumps(
        {"name": "tiny-gan", "source": "test", "reduced": [], "config": smoke_config()}))
    (base / "traffic" / "tiny-mix.json").write_text(json.dumps(
        {"driver": "serve", "batch": 2, "pool_batches": 2, "warmup": 1,
         "check_batches": 1, "slice_units": 1}))
    (base / "workloads" / "tiny-gan.tiny-mix.json").write_text(json.dumps(
        {"config": "tiny-gan", "traffic": "tiny-mix", "chips": 1, "why": "test",
         "end_to_end": ["serve_images_per_s", "batches_served"], "per_layer": [],
         "limits": {"edit_rel_err": 0.05}}))
    (base / "metrics" / "batches_served.py").write_text(
        'UNIT = "batches"\n\n\ndef read(rec):\n    return rec["batches"]\n')
    cell, config = core.load_cell("tiny-gan.tiny-mix", base)
    assert cell["traffic"]["batch"] == 2 and cell["traffic_name"] == "tiny-mix"
    assert config["gen"]["dim"] == 8
    run = core.Run("tiny-gan.tiny-mix", cell, config, SEED, 0.3, False, device="cpu",
                   cache=tmp_path / "cache", base=base)
    line = runmod.execute(run, t_start=0.0)
    assert line["correct"]
    assert line["metrics"]["batches_served"]["unit"] == "batches"
    assert line["metrics"]["batches_served"]["value"] >= 1


def test_every_cell_of_the_benchmark_resolves():
    bench = json.loads((core.BENCH_DIR.parent / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell, config = core.load_cell(w["name"])
        assert cell["config"] == w["config"] and cell["traffic_name"] == w["traffic"]
        assert cell["chips"] == w["chips"] and cell["why"] == w["why"]
        core.load_driver(cell["traffic"]["driver"])
        for m in cell["end_to_end"] + cell["per_layer"]:
            core.load_metric(m)
