"""Set-up: process start to the first timed step or request (host clock;
the first run in a checkout also builds the kernels, the data files and
the VGG weights)."""

UNIT = "s"


def read(rec):
    return rec["setup_s"]
