"""Images edited in the window, host arrays in to edited images on the
host, over its seconds (host clock)."""

UNIT = "images/s"


def read(rec):
    return rec["images"] / rec["window_s"]
