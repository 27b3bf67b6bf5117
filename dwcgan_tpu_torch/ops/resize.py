"""Spatial resizing (NCHW; the counterpart of `dwcgan_tpu/ops/resize.py`)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x upsample (half-pixel centres, align_corners=False),
    computed in fp32 and cast back, as `jax.image.resize` is used there."""
    y = F.interpolate(x.float(), scale_factor=2, mode="bilinear",
                      align_corners=False)
    return y.to(x.dtype)


def downsample2x(x: torch.Tensor) -> torch.Tensor:
    """2x2 mean with stride 2 (bilinear 0.5x for even sizes, the
    discriminator's scale pyramid), in fp32 and cast back, as
    `dwcgan_tpu/ops/resize.py:23-28` computes it."""
    return F.avg_pool2d(x.float(), 2).to(x.dtype)
