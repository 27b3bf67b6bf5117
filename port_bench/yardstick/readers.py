"""The arithmetic the metric readers share: model FLOP utilisation, the
norm kernels' share of their roofline and the device's idle share, from a
run's records (`rec`: the driver's record, with `config` and `cell`)."""

from __future__ import annotations

import statistics
from typing import Optional

from port_bench.reference.vocab import Vocab
from port_bench.yardstick import flops, norm_sites
from port_bench.yardstick.peaks import BF16_FLOPS


def mean_of(rec: dict, key: str) -> Optional[float]:
    values = rec.get(key)
    return statistics.fmean(values) if values else None


def mfu(rec: dict, kind: str) -> Optional[float]:
    """% of the bf16 dense peak: FLOPs per image (the reference's count at
    the cell's batch, `flops.py`) times the images of the window, over its
    seconds."""
    if not rec.get("window_s"):
        return None
    cfg, batch = rec["config"], rec["cell"]["traffic"]["batch"]
    count = flops.train_flops_per_image if kind == "train" else flops.serve_flops_per_image
    per_image = count(cfg, Vocab(cfg["dataset"]).size, batch)
    return 100.0 * per_image * rec["images"] / rec["window_s"] / BF16_FLOPS


def norm_roofline(rec: dict, kind: str) -> Optional[float]:
    """% of their least time the norm kernels took in the profiled slice:
    the sites' least time (`norm_sites.py`) times the slice's batches or
    steps, over the device time of the four norm kernels.  Nothing when
    the slice launched them another number of times than the site list
    says (the list no longer describes the program)."""
    tr = rec.get("trace")
    if not tr:
        return None
    cfg, batch = rec["config"], rec["cell"]["traffic"]["batch"]
    sites = (norm_sites.train_sites if kind == "train" else norm_sites.serve_sites)(cfg, batch)
    want = norm_sites.expected_launches(sites)
    launches, seconds = {k: 0 for k in norm_sites.KERNELS}, 0.0
    for name, (n, s) in tr["kernels"].items():
        for k in norm_sites.KERNELS:
            if k in name:
                launches[k] += n
                seconds += s
    if seconds <= 0 or any(launches[k] != want.get(k, 0) * tr["units"] for k in launches):
        return None
    elem = 2 if cfg["compute_dtype"] == "bfloat16" else 4
    least = sum(s.calls * norm_sites.bound_s(s, elem, cfg["norm_stats"]) for s in sites)
    return 100.0 * least * tr["units"] / seconds


def window_busy_s(rec: dict) -> Optional[float]:
    """The device's busy seconds in the unprofiled window: the union of
    device-operation intervals per step or batch of the profiled slice
    (`trace.py`), times the window's steps or batches.  The slice's device
    work is what the window's is; its wall is not, since the profiler
    slows the host."""
    tr = rec.get("trace")
    if not tr or tr["busy_s"] <= 0 or not rec.get("units"):
        return None
    return tr["busy_s"] / tr["units"] * rec["units"]


def idle_share(rec: dict) -> Optional[float]:
    """% of the unprofiled window's wall in which no device operation ran:
    1 - the device's busy seconds per unit (from the trace) over the
    window's seconds per unit (host clock, profiler off)."""
    busy = window_busy_s(rec)
    if busy is None or not rec.get("window_s"):
        return None
    return 100.0 * (1.0 - busy / rec["window_s"])
