"""Image-grid assembly and saving (the port's own copy of
`dwcgan_tpu/utils/images.py`; reference `utils.py:69-83`).

Rows of [N, H, W, 3] float arrays in [-1, 1] are tiled into one grid image
(row per output kind, column per sample) and min-max normalized like
torchvision's make_grid(normalize=True).
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np


def make_grid(rows: Sequence[np.ndarray], num_cols: int) -> np.ndarray:
    """rows: list of [N, H, W, 3] arrays -> [R*H, num_cols*W, 3] uint8."""
    tiles = [np.asarray(r, dtype=np.float32)[:num_cols] for r in rows]
    grid = np.concatenate([np.concatenate(list(t), axis=1) for t in tiles], axis=0)
    lo, hi = grid.min(), grid.max()
    grid = (grid - lo) / max(hi - lo, 1e-5)
    return (grid * 255.0 + 0.5).clip(0, 255).astype(np.uint8)


def save_image_grid(rows: Sequence[np.ndarray], num_cols: int, path: str):
    grid = make_grid(rows, num_cols)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    try:
        from PIL import Image
        Image.fromarray(grid).save(path)
    except ImportError:  # grid still inspectable as .npy
        np.save(path + ".npy", grid)
