"""The share of the unprofiled window's wall with no device operation
running: the trace's busy time per unit against the window's time per unit
(yardstick/readers.py)."""

from port_bench.yardstick.readers import idle_share

UNIT = "%"


def read(rec):
    return idle_share(rec)
