"""Latent interpolation helpers, numpy (the port's own copy of
`dwcgan_tpu/utils/interp.py`; reference utils.py:139-165)."""

from __future__ import annotations

import numpy as np


def slerp(val: float, low: np.ndarray, high: np.ndarray) -> np.ndarray:
    """Spherical linear interpolation between two latents (float64); a
    straight line when they are colinear."""
    low = np.asarray(low, dtype=np.float64)
    high = np.asarray(high, dtype=np.float64)
    omega = np.arccos(np.clip(
        np.dot(low / np.linalg.norm(low), high / np.linalg.norm(high)), -1, 1))
    so = np.sin(omega)
    if so < 1e-8:
        return (1.0 - val) * low + val * high
    return (np.sin((1.0 - val) * omega) / so * low
            + np.sin(val * omega) / so * high)


def get_slerp_interp(nb_latents: int, nb_interp: int, z_dim: int,
                     seed: int = 0) -> np.ndarray:
    """[nb_latents * nb_interp, z_dim, 1, 1] float32 slerp chains between
    pairs of N(0, 1) latents drawn from `default_rng(seed)`."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(nb_latents):
        low = rng.standard_normal(z_dim)
        high = rng.standard_normal(z_dim)
        for v in np.linspace(0.0, 1.0, nb_interp):
            out.append(slerp(float(v), low, high))
    arr = np.asarray(out, dtype=np.float32)
    return arr[:, :, np.newaxis, np.newaxis]
