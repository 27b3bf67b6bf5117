"""Host ms of a synchronised gen.encode_txt on each of the cell's pool
batches after the window, mean."""

from port_bench.yardstick.readers import mean_of

UNIT = "ms"


def read(rec):
    return mean_of(rec, "encode_txt_ms")
