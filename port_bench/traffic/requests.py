"""Serve traffic: a pool of seeded requests, each an image and a command
(a copy of the port's `cli/translate.py::synthetic_requests`, over the
frozen template engine of `synthesis.py`).

Images are smooth random fields in [-1, 1] (a low-resolution uniform
field, bilinearly upsampled, plus 0.1 Gaussian noise), NHWC float32;
commands are synthesized from random (source, target) label pairs, so
their lengths vary as real commands do.  The pool is cut into batches of
the cell's size; the client cycles through them.
"""

from __future__ import annotations

import random
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.traffic.synthesis import TextSynthesizer


def synthetic_requests(n: int, size: int, seed: int):
    """n seeded images in [-1, 1] and n commands."""
    rng = np.random.default_rng(seed)
    low = rng.uniform(-1, 1, (n, 3, size // 8, size // 8)).astype(np.float32)
    imgs = F.interpolate(torch.from_numpy(low), size=(size, size),
                         mode="bilinear", align_corners=False)
    imgs = (imgs + 0.1 * torch.from_numpy(
        rng.standard_normal((n, 3, size, size)).astype(np.float32))).clamp(-1, 1)
    synth = TextSynthesizer(random.Random(seed))
    cmds = [synth(rng.integers(0, 2, 8), rng.integers(0, 2, 8)) for _ in range(n)]
    return imgs.permute(0, 2, 3, 1).contiguous().numpy(), cmds


def request_pool(traffic: dict, size: int, seed: int) -> List[Tuple[np.ndarray, list]]:
    """`traffic["pool_batches"]` batches of `traffic["batch"]` requests."""
    b, k = traffic["batch"], traffic["pool_batches"]
    imgs, cmds = synthetic_requests(b * k, size, seed)
    return [(imgs[i * b:(i + 1) * b], cmds[i * b:(i + 1) * b]) for i in range(k)]
