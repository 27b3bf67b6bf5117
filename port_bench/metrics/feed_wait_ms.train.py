"""Host ms per step of the loop's next() on the DataPipeline plus
to_device, the benchmark's own span, mean over the window's steps."""

from port_bench.yardstick.readers import mean_of

UNIT = "ms"


def read(rec):
    return mean_of(rec, "feed_wait_ms")
