"""Wall-clock timing (the port's counterpart of `dwcgan_tpu/utils/timer.py`).

`StepTimer.lap(sync)` first fetches `sync` (a device tensor of the last
step) to the host, so a lap includes the device's work, not only the
host's enqueueing of it.
"""

from __future__ import annotations

import time
from typing import Optional

import torch


class StepTimer:
    """Seconds between laps, with the device synchronized at each."""

    def __init__(self):
        self._last = None

    def lap(self, sync: Optional[torch.Tensor] = None) -> float:
        if sync is not None:
            sync.cpu()
        now = time.perf_counter()
        dt = 0.0 if self._last is None else now - self._last
        self._last = now
        return dt
