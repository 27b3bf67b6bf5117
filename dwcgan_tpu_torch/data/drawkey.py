"""Counter-based RNG keys for deterministic, order-independent data draws
(the port's own copy of `dwcgan_tpu/data/drawkey.py`).

A torch DataLoader is reproducible: it keeps index order across workers and
seeds each worker deterministically.  A shared `random.Random` raced by
prefetch threads is not.  So every augmentation draw is keyed by (dataset
seed, per-host salt, epoch, index): item content is independent of which
worker thread renders it and of arrival order, and each epoch still draws
afresh.
"""


def draw_key(*vals: int) -> int:
    """Mix integers into a 64-bit key (SplitMix64 finalizer per value).

    Deterministic across processes and Python versions (pure integer
    arithmetic — unlike `hash()`, which PYTHONHASHSEED perturbs for many
    types).  Suitable as a `random.Random` seed.
    """
    h = 0
    for v in vals:
        h = (h ^ (int(v) + 0x9E3779B97F4A7C15)) & 0xFFFFFFFFFFFFFFFF
        h = (h * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
        h ^= h >> 31
    return h
