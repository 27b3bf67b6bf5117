"""The training window's model FLOP/s as a share of the card's bf16 dense
peak: the FLOPs counted per image (yardstick/flops.py) times the window's
images, over its host-clock seconds and the data sheet's 989 TFLOP/s
(yardstick/readers.py, yardstick/peaks.py)."""

from port_bench.yardstick.readers import mfu

UNIT = "%"


def read(rec):
    return mfu(rec, "train")
