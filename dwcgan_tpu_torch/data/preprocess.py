"""Host-side image preprocessing: center crop + optional horizontal flip +
half-pixel bilinear resize + [-1, 1] normalisation.

A copy of the NumPy branch of `dwcgan_tpu/native/__init__.py`
(`_preprocess_one_numpy`, `preprocess_batch`): the plain version of the
port's C++ kernel (`dwcgan_tpu_torch/native/`, `csrc/image_ops.cpp`), which
the tests hold that kernel against, within 1e-4 (it floors and blends in
float64 and divides by 127.5, where the kernel truncates, blends as
v00 + (v01 - v00) * fx in float32 and multiplies by 1 / 127.5f).  Reached
only through `native.preprocess_batch(..., force_fallback=True)`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def preprocess_one(img: np.ndarray, crop: int, out_size: int) -> np.ndarray:
    """One uint8 HWC image -> [out_size, out_size, 3] in [0, 255].  Source
    coordinates are computed in the crop window but clamped to the full
    image (so upscaling blends pixels just outside the crop, as the C++
    kernel does)."""
    h, w, _ = img.shape
    top, left = (h - crop) // 2, (w - crop) // 2
    scale = crop / out_size
    sy = (np.arange(out_size) + 0.5) * scale - 0.5 + top
    sx = (np.arange(out_size) + 0.5) * scale - 0.5 + left
    y0 = np.clip(np.floor(sy).astype(np.int64), 0, h - 1)
    x0 = np.clip(np.floor(sx).astype(np.int64), 0, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    fy = np.clip(sy - y0, 0.0, 1.0)[:, None, None]
    fx = np.clip(sx - x0, 0.0, 1.0)[None, :, None]
    img = img.astype(np.float32)
    top_v = img[y0][:, x0] * (1 - fx) + img[y0][:, x1] * fx
    bot_v = img[y1][:, x0] * (1 - fx) + img[y1][:, x1] * fx
    return top_v * (1 - fy) + bot_v * fy


def preprocess_batch(images: np.ndarray, crop: int, out_size: int,
                     hflips: Optional[np.ndarray] = None) -> np.ndarray:
    """images: [N, H, W, 3] uint8 (same size); hflips: [N] 0/1.  Returns
    [N, out_size, out_size, 3] float32 in [-1, 1].  A flip mirrors the
    source image, which equals the kernel's mirrored output when (w - crop)
    is even (a centred window)."""
    images = np.ascontiguousarray(images, dtype=np.uint8)
    n, _, _, c = images.shape
    if c != 3:
        raise ValueError(f"expected [N, H, W, 3] images, got {images.shape}")
    out = np.empty((n, out_size, out_size, 3), dtype=np.float32)
    for i in range(n):
        img = images[i]
        if hflips is not None and hflips[i]:
            img = np.ascontiguousarray(img[:, ::-1])
        out[i] = preprocess_one(img, crop, out_size)
    return out / 127.5 - 1.0
