"""The share of the unprofiled window's wall with no device operation
running: the trace's busy time per unit times the window's units, capped
at the window where a saturated device's profiler pushed it a little past
(yardstick/readers.py::window_busy_s), against the window's seconds."""

from port_bench.yardstick.readers import idle_share

UNIT = "%"


def read(rec):
    return idle_share(rec)
