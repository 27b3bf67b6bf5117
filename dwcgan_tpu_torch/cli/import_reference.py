"""Import a trained reference (torch) DWC-GAN checkpoint into a checkpoint
of the port (the counterpart of `dwcgan_tpu/cli/import_reference.py`).

    python -m dwcgan_tpu_torch.cli.import_reference \
        --config configs/celeba_faces.yaml \
        --gen_pt gen_00200000.pt --dis_pt dis_00200000.pt \
        --out OUT/outputs/celeba_faces/checkpoints --step 200000

Writes `ckpt_<step>.pt` (`train/checkpoint.py`) under `--out`: the
imported generator and discriminator (`interop/reference.py`), their EMA
copies set to the imported weights, fresh optimizer state, as the
reference's own resume re-copies its EMA from the live nets (train.py:87).
Without `--dis_pt` the discriminator keeps the config seed's random
weights.  The file serves through `cli/translate.py --checkpoint` and
`cli/evaluate.py --checkpoint`, and `cli/train.py --resume 1` continues
from it when `--out` is the run's `outputs/<config name>/checkpoints`.
Runs on the card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import os

import torch

from dwcgan_tpu_torch.config import load_config
from dwcgan_tpu_torch.device import resolve_device
from dwcgan_tpu_torch.interop.reference import (load_reference_discriminator,
                                                load_reference_generator)
from dwcgan_tpu_torch.text.vocab import Vocab
from dwcgan_tpu_torch.train.checkpoint import CheckpointManager, checkpoint_header
from dwcgan_tpu_torch.train.state import create_train_state


def main(argv=None) -> str:
    """Import as the module docstring says; returns the written file."""
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="configs/celeba_faces.yaml")
    p.add_argument("--gen_pt", required=True)
    p.add_argument("--dis_pt", default=None)
    p.add_argument("--out", required=True, help="checkpoint directory")
    p.add_argument("--step", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = load_config(args.config)
    vocab = Vocab(cfg.dataset)
    state = create_train_state(cfg, vocab.size, device=dev)

    load_reference_generator(state.gen, torch.load(args.gen_pt, map_location="cpu",
                                                   weights_only=True))
    state.ema_gen.load_state_dict(state.gen.state_dict())
    if args.dis_pt:
        load_reference_discriminator(state.dis, torch.load(
            args.dis_pt, map_location="cpu", weights_only=True))
        state.ema_dis.load_state_dict(state.dis.state_dict())
    state.step = args.step

    name = os.path.splitext(os.path.basename(args.config))[0]
    path = CheckpointManager(args.out, header=checkpoint_header(
        cfg, vocab.size, name)).save(state)
    print(f"imported checkpoint written to {path}")
    return path


if __name__ == "__main__":
    main()
