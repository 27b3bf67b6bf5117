"""Failure detection (the port's own copy of `dwcgan_tpu/utils/guard.py`).

- `FiniteGuard`: a NaN/Inf tripwire over the step's metrics that raises,
  so a long unattended run fails loudly instead of training on garbage.
  The corrupted state is not checkpointed: the last healthy snapshot stays
  the latest, so `--resume 1` restarts cleanly.  Reading a metric (`float`
  of a 0-d device tensor) waits for the device, so the guard reads them
  only every `every` steps.
- `StallWatchdog`: a daemon thread that prints to stderr when the training
  loop stops making progress (a wedged device stream sleeps forever with
  no error), naming the last completed step.
"""

from __future__ import annotations

import math
import sys
import threading
import time
from typing import Dict


class NonFiniteLossError(RuntimeError):
    pass


class FiniteGuard:
    """Check metric dicts every `every` steps; trip after `patience`
    consecutive non-finite observations (transient inf in GAN losses at low
    batch sizes is survivable; persistent NaN is not)."""

    def __init__(self, every: int = 100, patience: int = 2,
                 keys=("loss_gen_total", "loss_dis_all",
                       "grad_gen_norm", "grad_dis_norm")):
        # both loss totals and both gradient norms: a NaN can show in a
        # gradient one window before it reaches the losses.  Each check
        # fetches len(keys) device scalars, so the worst case is
        # every * patience steps of poisoned training (config.py
        # guard_every, guard_patience).
        self.every = every
        self.patience = patience
        self.keys = keys
        self._strikes = 0

    def check(self, step: int, metrics: Dict[str, float],
              checkpoint=None, state=None) -> bool:
        """Returns True if healthy; raises NonFiniteLossError when tripped.

        The NaN state is never saved (it would become the newest checkpoint
        and poison --resume); the message names the last healthy snapshot.
        """
        if step % self.every != 0:
            return True
        bad = [k for k in self.keys
               if k in metrics and not math.isfinite(float(metrics[k]))]
        if not bad:
            self._strikes = 0
            return True
        self._strikes += 1
        if self._strikes >= self.patience:
            last_good = None
            if checkpoint is not None:
                try:
                    last_good = checkpoint.latest_step()
                except Exception:
                    pass
            raise NonFiniteLossError(
                f"non-finite {bad} at step {step} "
                f"({self._strikes} consecutive checks); resume from the last "
                f"healthy checkpoint (step {last_good})")
        return False


class StallWatchdog:
    """Warn when no training progress is observed for `timeout_s` seconds.

    Usage: call `beat(step)` after each completed iteration; `stop()` on
    clean shutdown.  Warnings repeat every `timeout_s` while stalled and
    include the stall duration and last completed step.  Thread-safe; the
    watchdog thread is a daemon so it never blocks interpreter exit.
    """

    def __init__(self, timeout_s: float = 300.0, out=None):
        self.timeout_s = timeout_s
        self._out = out if out is not None else sys.stderr
        self._last_beat = time.monotonic()
        self._last_step = None
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self.stall_warnings = 0
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="stall-watchdog")
        self._thread.start()

    def beat(self, step: int) -> None:
        with self._lock:
            self._last_beat = time.monotonic()
            self._last_step = step

    def stop(self) -> None:
        self._stop.set()

    def _run(self) -> None:
        poll = min(5.0, self.timeout_s / 4)
        while not self._stop.wait(poll):
            with self._lock:
                idle = time.monotonic() - self._last_beat
                step = self._last_step
            if idle >= self.timeout_s:
                self.stall_warnings += 1
                print(f"[stall-watchdog] NO PROGRESS for {idle:.0f}s "
                      f"(last completed step: {step}); the device stream may "
                      f"be wedged: kill this process and rerun with "
                      f"--resume 1 to continue from the last checkpoint",
                      file=self._out, flush=True)
                with self._lock:
                    # re-arm so the warning repeats once per timeout window
                    self._last_beat = time.monotonic()
