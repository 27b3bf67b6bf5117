"""The 95th percentile of every request's latency in the window (host
clock, call to edited image on the host)."""

import numpy as np

UNIT = "ms"


def read(rec):
    return float(np.percentile(rec["latencies"], 95)) * 1e3
