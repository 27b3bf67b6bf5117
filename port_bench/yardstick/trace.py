"""The reduction of a profiled slice to device numbers.

`profile_slice(fn, units)` runs `fn` `units` times under
`torch.profiler` (CPU and, with a card, CUDA activities) inside one annotation,
`port_bench.slice`, that ends in a device synchronize; the trace is
exported as Chrome JSON to a temporary file, read and deleted.
`reduce_trace` turns its events into:

- `wall_s`: the annotation's length (the host clock, profiler on: the
  profiler slows the host, so the idle share holds `busy_s` against the
  unprofiled window instead, `readers.idle_share`);
- `busy_s`: the union of the device operations' intervals (kernels,
  copies, sets) inside it, so overlapping kernels count once;
- `kernels`: {name: (launches, device seconds)};
- `device_ops`: the ten device operations with the most time;
- `idle_gaps`: idle device time inside the slice, summed by what the host
  was doing at each gap's midpoint (the innermost host event of the
  thread that ran the slice), the ten largest.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch

SLICE = "port_bench.slice"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10


def profile_slice(fn: Callable[[], None], units: int) -> dict:
    """Run `fn` `units` times under the profiler; `reduce_trace` of it."""
    from torch.profiler import ProfilerActivity, profile, record_function

    card = torch.cuda.is_available()
    sync = torch.cuda.synchronize if card else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    sync()
    with profile(activities=acts) as prof:
        with record_function(SLICE):
            for _ in range(units):
                fn()
            sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path, encoding="utf-8") as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    out = reduce_trace(events)
    out["units"] = units
    return out


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _host_at(host, starts, t: float, scan: int = 4096) -> str:
    """The innermost host event covering time t: one thread's events nest,
    so it is the latest-starting one that has not ended by t."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - scan, -1), -1):
        if host[j][1] >= t:
            return host[j][2]
    return "(no host event)"


def reduce_trace(events: List[dict]) -> dict:
    """The slice's numbers from Chrome trace events (times in us)."""
    slices = [e for e in events if e.get("name") == SLICE and e.get("cat") == "user_annotation"]
    if len(slices) != 1:
        raise ValueError(f"expected one {SLICE} annotation, found {len(slices)}")
    s = slices[0]
    t0, t1 = float(s["ts"]), float(s["ts"]) + float(s["dur"])
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e
           and t0 <= float(e["ts"]) < t1]
    per_name: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    spans = []
    for e in dev:
        a = float(e["ts"])
        b = min(a + float(e["dur"]), t1)
        spans.append((a, b))
        per_name[e["name"]][0] += 1
        per_name[e["name"]][1] += float(e["dur"]) * 1e-6
    busy = _union(spans)
    # by start, and at one start the longer (outer) event first
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                   for e in events if e.get("cat") in HOST_CATS and "dur" in e
                   and e.get("tid") == s.get("tid") and e.get("pid") == s.get("pid")),
                  key=lambda h: (h[0], -h[1]))
    starts = [h[0] for h in host]
    gaps: Dict[str, float] = defaultdict(float)
    edge = t0
    for a, b in busy + [(t1, t1)]:
        if a > edge:
            gaps[_host_at(host, starts, 0.5 * (edge + a))] += (a - edge) * 1e-6
        edge = max(edge, b)
    ops = sorted(per_name.items(), key=lambda kv: -kv[1][1])
    return {
        "wall_s": (t1 - t0) * 1e-6,
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "kernels": {k: (v[0], v[1]) for k, v in per_name.items()},
        "device_ops": [[k, v[1]] for k, v in ops[:TOP]],
        "idle_gaps": [[k, v] for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]],
    }
