"""The arithmetic the metric readers share: model FLOP utilisation, the
norm kernels' share of their roofline, the device's busy time per unit and
its idle share, from a run's records (`rec`: the driver's record, with
`config` and `cell`)."""

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


# The slice's device time per unit over the window's period, up to which
# the excess is read as the profiler's own cost on a saturated device (the
# graphed training step's readings on the H100 are in PERF.md, section 3).
# Past it the product stands, and busy exceeds the window.
SATURATED_UP_TO = 1.02


def device_busy_per_unit_s(rec: dict) -> Optional[float]:
    """The device's busy seconds per step or batch in the profiled slice:
    the union of its device-operation intervals (`trace.py`) over its
    steps or batches, as the slice measured it (not capped).  Nothing
    where the slice saw no device operation."""
    tr = rec.get("trace")
    if not tr or tr["busy_s"] <= 0 or not tr["units"]:
        return None
    return tr["busy_s"] / tr["units"]


def window_busy_s(rec: dict) -> Optional[float]:
    """The device's busy seconds in the unprofiled window: the slice's busy
    time per step or batch times the window's steps or batches, capped at
    the window's seconds where it exceeds them by no more than
    `SATURATED_UP_TO`.

    The slice's device work per unit stands for the window's, whose wall
    it does not see: the profiler slows the host, and on the device it
    adds its own record of every kernel.  So where the slice's busy time
    per unit exceeds the window's period by a little, the device was
    saturated in the window and the excess is the profiler's cost, which
    the window did not pay: the result is then `window_s` exactly (the
    idle share 0).  Below the window it is the product, bit for bit.  Past
    the tolerance it is the product too, above `window_s`: the units or
    the operations are miscounted, and the run's `busy_s <= window_s`
    fails."""
    per_unit = device_busy_per_unit_s(rec)
    if per_unit is None or not rec.get("units") or not rec.get("window_s"):
        return None
    busy, window = per_unit * rec["units"], rec["window_s"]
    return window if window < busy <= window * SATURATED_UP_TO else busy


def idle_share(rec: dict) -> Optional[float]:
    """% of the unprofiled window's wall in which no device operation ran:
    1 - the device's busy seconds in it (`window_busy_s`) over its seconds
    (host clock, profiler off); 0 to 100 unless busy is past its
    tolerance."""
    busy = window_busy_s(rec)
    if busy is None:
        return None
    return 100.0 * (1.0 - busy / rec["window_s"])
