"""Label utilities (the port's own copy of `all_domains`,
`dwcgan_tpu/data/labels.py:68-72`)."""

from __future__ import annotations

import numpy as np


def all_domains(num_attr: int) -> np.ndarray:
    """All 2^num_attr binary label combinations (celeba_data.py:75-86)."""
    n = 1 << num_attr
    bits = (np.arange(n)[:, None] >> np.arange(num_attr - 1, -1, -1)) & 1
    return bits.astype(np.int64)
