"""Learning-rate schedules as closed-form functions of the global step
(the counterpart of `dwcgan_tpu/train/schedules.py:17-52`; reference
utils.py:220-231, stepped once per iteration)."""

from __future__ import annotations

import math
from typing import Callable

from dwcgan_tpu_torch.config import Config


def lr_schedule(cfg: Config) -> Callable[[int], float]:
    """f(step) -> lr for the const, step and cosa (cosine with warm
    restarts, period times t_mult after each) policies."""
    base, policy = cfg.lr, cfg.lr_policy
    if policy == "const":
        return lambda step: base
    if policy == "step":
        return lambda step: base * cfg.gamma ** (step // cfg.step_size)
    if policy == "cosa":
        eta_min, t0, m = cfg.eta_min, float(cfg.step_size), float(cfg.t_mult)

        def cosa(step):
            if m == 1.0:
                t, period = math.fmod(step, t0), t0
            else:
                i = math.floor(math.log(step * (m - 1.0) / t0 + 1.0) / math.log(m))
                t = step - t0 * (m ** i - 1.0) / (m - 1.0)
                period = t0 * m ** i
            return eta_min + (base - eta_min) * 0.5 * (1.0 + math.cos(math.pi * t / period))

        return cosa
    raise ValueError(f"unsupported lr_policy {policy}")
