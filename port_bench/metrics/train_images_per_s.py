"""Images trained in the window over its seconds (host clock; the window
ends in a device synchronize)."""

UNIT = "images/s"


def read(rec):
    return rec["images"] / rec["window_s"]
