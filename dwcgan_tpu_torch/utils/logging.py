"""Metric logging (the port's counterpart of `dwcgan_tpu/utils/logging.py`).

The step returns a dict of metrics (0-d device tensors and Python floats);
the writer appends one JSON line per call to `<log_dir>/metrics.jsonl`
(always) and TensorBoard scalars when `torch.utils.tensorboard` imports
(without the `tensorboard` package only the JSON lines are written).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricWriter:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a",
                           buffering=1)
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:   # no tensorboard package: JSON lines only
            return
        self._tb = SummaryWriter(log_dir)

    def write(self, step: int, metrics: Dict[str, float]):
        """One row; `float` of a device tensor waits for the device."""
        scalars = {k: float(v) for k, v in metrics.items()}
        self._jsonl.write(json.dumps({"step": int(step), "time": time.time(),
                                      **scalars}) + "\n")
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, step)

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
