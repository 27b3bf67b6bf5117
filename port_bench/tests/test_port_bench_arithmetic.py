"""The yardstick's frozen arithmetic, pinned for both configurations: the
FLOPs per image behind `mfu.*` and the norm sites behind
`norm_roofline.*` (the least time per served batch of 32 and per step of
16, and the launches per kernel, which equal `chip_smoke.py`'s
`EXPECTED_LAUNCHES` and `EXPECTED_TRAIN_LAUNCHES`)."""

import json

import pytest

import _smoke  # noqa: F401
from port_bench import core
from port_bench.reference.vocab import Vocab
from port_bench.yardstick import flops, norm_sites, readers

CONFIGS = ("dwcgan-celeba128", "dwcgan-celeba128-sn")


@pytest.mark.parametrize("name", CONFIGS)
def test_flops_per_image(name):
    cfg = core.load_json("configs", name)["config"]
    assert flops.serve_flops_per_image(cfg, Vocab().size, 32) == 38959716352.0
    assert flops.train_flops_per_image(cfg, Vocab().size, 16) == 588543354368.0


@pytest.mark.parametrize("name", CONFIGS)
def test_norm_sites(name):
    cfg = core.load_json("configs", name)["config"]
    train, serve = norm_sites.train_sites(cfg, 16), norm_sites.serve_sites(cfg, 32)
    assert norm_sites.expected_launches(train) == {
        "norm_fwd_cluster_kernel": 40, "ln_fwd_cluster_kernel": 4,
        "norm_bwd_cluster_kernel": 39, "ln_bwd_cluster_kernel": 4}
    assert norm_sites.expected_launches(serve) == {
        "norm_fwd_cluster_kernel": 19, "ln_fwd_cluster_kernel": 2}
    least = lambda sites: sum(s.calls * norm_sites.bound_s(s, 2, cfg["norm_stats"])
                              for s in sites)
    assert least(train) == pytest.approx(1.6868779940298507e-3, rel=1e-12)
    assert least(serve) == pytest.approx(3.106606614925373e-4, rel=1e-12)


def _rec(kernels, units, cfg, batch):
    return {"config": cfg, "cell": {"traffic": {"batch": batch}},
            "trace": {"kernels": kernels, "units": units, "busy_s": 0.5, "wall_s": 2.0}}


def test_roofline_reader():
    cfg = core.load_json("configs", CONFIGS[0])["config"]
    names = {"void norm_fwd_cluster_kernel<bf16>(x)": (19 * 5, 1.0e-3),
             "void ln_fwd_cluster_kernel<bf16>(x)": (2 * 5, 1.0e-3)}
    rec = _rec(names, 5, cfg, 32)
    assert readers.norm_roofline(rec, "serve") == pytest.approx(
        100 * 5 * 3.106606614925373e-4 / 2.0e-3)
    # the trace's 0.1 s busy per batch against the window's 0.2 s a batch
    # (the profiled slice's own 2 s wall is not read)
    window = {**rec, "units": 40, "window_s": 8.0}
    assert readers.window_busy_s(window) == pytest.approx(4.0)
    assert readers.idle_share(window) == pytest.approx(50.0)
    assert readers.idle_share(rec) is None          # no window to hold it against
    busy_ms = core.load_metric("device_busy_ms.serve").read
    assert busy_ms(window) == pytest.approx(100.0)
    assert core.load_metric("device_busy_ms.train").read(window) == busy_ms(window)
    # saturated: the slice's 0.201 s and 0.2038 s busy per batch against the
    # window's 0.2 s (the profiler's own cost on the device, within
    # `SATURATED_UP_TO`): busy is the window, idle 0
    for per_batch in (0.201, 0.2038):
        saturated = {**window, "trace": {**rec["trace"], "busy_s": 5 * per_batch}}
        assert readers.window_busy_s(saturated) == saturated["window_s"]
        assert readers.idle_share(saturated) == 0.0
        assert busy_ms(saturated) == pytest.approx(1e3 * per_batch)   # the slice's own
    # past the tolerance (0.3 s and 0.4 s against 0.2 s: units or operations
    # miscounted): not capped, so busy exceeds the window
    for per_batch, idle in ((0.3, -50.0), (0.4, -100.0)):
        over = {**window, "trace": {**rec["trace"], "busy_s": 5 * per_batch}}
        assert readers.window_busy_s(over) == pytest.approx(40 * per_batch)
        assert readers.window_busy_s(over) > over["window_s"]
        assert readers.idle_share(over) == pytest.approx(idle)
    # nothing to read: no trace, no device operation; no window to hold it
    # against, which the slice's own time per unit does not need
    for bare in ({**window, "trace": None}, {**window, "trace": {**rec["trace"], "busy_s": 0.0}}):
        assert busy_ms(bare) is None and readers.window_busy_s(bare) is None
    for no_window in (rec, {**window, "units": 0}):
        assert readers.window_busy_s(no_window) is None
        assert busy_ms(no_window) == pytest.approx(100.0)
    # launched another number of times than the site list says: nothing
    names["void ln_fwd_cluster_kernel<bf16>(x)"] = (2 * 5 + 1, 1.0e-3)
    assert readers.norm_roofline(_rec(names, 5, cfg, 32), "serve") is None
    assert readers.norm_roofline({**rec, "trace": None}, "serve") is None


def test_mfu_reader():
    cfg = core.load_json("configs", CONFIGS[0])["config"]
    rec = {"config": cfg, "cell": {"traffic": {"batch": 32}}, "images": 989, "window_s": 1.0}
    assert readers.mfu(rec, "serve") == pytest.approx(100 * 38959716352.0 / 1e12)


def test_benchmark_file_matches_the_cells():
    bench = json.loads((core.BENCH_DIR.parent / "BENCHMARK.json").read_text())
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert core.load_metric(m["name"]).UNIT == m["unit"]
    for w in bench["workloads"]:
        cell, config = core.load_cell(w["name"])
        for m in cell["end_to_end"] + cell["per_layer"]:
            assert m in units
            entry = next(e for e in bench["end_to_end"] + bench["per_layer"] if e["name"] == m)
            assert w["name"] in entry.get("workloads", [w["name"]])
        if cell["traffic"]["driver"] == "train":
            assert cell["traffic"]["batch"] == config["batch_size"]
    for c in bench["configs"]:
        assert core.load_json("configs", c["name"])["reduced"] == c["reduced"]


@pytest.mark.parametrize("name, overrides", [("dwcgan-celeba128", {}),
                                             ("dwcgan-celeba128-sn", {"dis": {"norm": "sn"}})])
def test_configs_are_the_shipped_yaml(name, overrides):
    from dwcgan_tpu_torch.config import load_config

    f = core.load_json("configs", name)
    want = load_config(str(core.BENCH_DIR.parent / f["starts_from"])).to_dict()
    for k, v in overrides.items():
        want[k] = {**want[k], **v} if isinstance(v, dict) else v
    assert f["overrides"] == overrides and f["config"] == want
