"""The norm kernels' least time over their device time in the profiled
batches (yardstick/readers.py)."""

from port_bench.yardstick.readers import norm_roofline

UNIT = "%"


def read(rec):
    return norm_roofline(rec, "serve")
