"""The device's own milliseconds per step: the union of device-operation
intervals in the profiled slice over its steps, as the trace measured it
and not capped at the window's period (yardstick/readers.py)."""

from port_bench.yardstick.readers import device_busy_per_unit_s

UNIT = "ms"


def read(rec):
    per_unit = device_busy_per_unit_s(rec)
    return None if per_unit is None else 1e3 * per_unit
