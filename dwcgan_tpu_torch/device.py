"""Device selection for the port's entry points."""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU.  Under a process group (data-parallel training, one card
    a rank) "cuda" is `cuda:LOCAL_RANK`.  Asking for CUDA without a card
    raises; nothing drifts to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    if dev.type == "cuda" and dev.index is None and dist.is_available() \
            and dist.is_initialized():
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return dev
