"""Shared set-up of the benchmark's CPU tests: the repository on the path,
and cells at `configs/smoke.yaml` widths driven on the CPU (a tiny
CelebA-format data set, a few pool batches), held to the flagship cells'
limits."""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from port_bench import core  # noqa: E402

SEED = 2 ** 31 + 12345      # past 32 signed bits, as the driver's are


def smoke_config() -> dict:
    from dwcgan_tpu_torch.config import load_config

    cfg = load_config(str(ROOT / "configs" / "smoke.yaml")).to_dict()
    cfg["vgg_w"] = 0.1          # the recipe's VGG term, as the flagship has it
    cfg["test_split"] = 16
    return cfg


def smoke_cell(kind: str) -> dict:
    """A cell of the flagship's traffic kind at smoke sizes, with the
    flagship cell's metrics and limits."""
    name = {"train": "celeba128.train-b16", "serve": "celeba128.serve-b32",
            "edit": "celeba128.edit-b1"}[kind]
    cell, _ = core.load_cell(name)
    traffic = {"train": {"driver": "train", "batch": 8, "images": 96, "data_seed": 5,
                         "vgg_seed": 7, "slice_units": 1},
               "serve": {"driver": "serve", "batch": 4, "pool_batches": 3, "warmup": 3,
                         "check_batches": 2, "slice_units": 2},
               "edit": {"driver": "serve", "batch": 1, "pool_batches": 6, "warmup": 2,
                        "check_batches": 4, "slice_units": 2}}[kind]
    return {**cell, "traffic": traffic}


def smoke_run(kind: str, cache: Path, trace: bool = False, seconds: float = 0.5,
              seed: int = SEED, **kw) -> core.Run:
    torch.set_num_threads(4)
    return core.Run(f"smoke-{kind}", smoke_cell(kind), smoke_config(), seed, seconds,
                    trace, device="cpu", cache=Path(cache), **kw)
