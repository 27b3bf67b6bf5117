"""Batch inference CLI: apply text commands to images, on the card.

    python -m dwcgan_tpu_torch.cli.translate --config configs/celeba_faces.yaml \
        --checkpoint OUT/outputs/celeba_faces/checkpoints \
        --list edits.tsv --image_dir ./images --out_dir ./edited

The counterpart of `dwcgan_tpu/cli/translate.py`, with the same flags.
The weights come from exactly one of:

- `--checkpoint`: a checkpoint directory of the port's training CLI, or
  one of its files; `--step` picks a step (default: the latest), and
  `--use_ema 1` (the default) serves the EMA generator;
- `--weights`: a `.npz` of a JAX generator's parameters, flattened with
  "/" (e.g. `enc_style/Conv2dBlock_0/Conv_0/kernel`): export the set to
  serve from a JAX run with `np.savez(path, **flat_params)` (reading
  Orbax needs JAX).

`edits.tsv`: one "image<TAB>command" per line.  One output per line, named
`{line_index:06d}_{basename}`.  Runs on the card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import os
import random
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from dwcgan_tpu_torch.config import load_config
from dwcgan_tpu_torch.data.celeba import _center_crop_resize
from dwcgan_tpu_torch.device import resolve_device
from dwcgan_tpu_torch.eval.harness import read_src2trg
from dwcgan_tpu_torch.interop.jax_params import load_jax_params
from dwcgan_tpu_torch.models.generator import build_generator
from dwcgan_tpu_torch.text.synthesis import TextSynthesizer
from dwcgan_tpu_torch.text.vocab import Vocab, encode_commands
from dwcgan_tpu_torch.train.checkpoint import (checkpoint_file,
                                               checkpoint_header,
                                               read_checkpoint)
from dwcgan_tpu_torch.train.sampler import make_infer_fn


def translate_batch(infer, images: np.ndarray, commands: Sequence[str],
                    vocab: Vocab, max_len: int,
                    device: torch.device) -> torch.Tensor:
    """One served batch: images [N, H, W, 3] float32 in [-1, 1] (host) and N
    commands -> edited images [N, H, W, 3] float32 on `device`."""
    ids, lens = encode_commands(commands, vocab, max_len)
    x = torch.from_numpy(np.ascontiguousarray(images, np.float32)).to(device)
    # token ids go to the card; the lengths stay on the host, where the
    # LSTM reads how many steps to run
    return infer(x, torch.from_numpy(ids).to(device), torch.from_numpy(lens))


def synthetic_requests(n: int, size: int, seed: int):
    """n seeded images in [-1, 1] (smooth random fields, NHWC float32) and
    n commands synthesized from random label pairs."""
    rng = np.random.default_rng(seed)
    low = rng.uniform(-1, 1, (n, 3, size // 8, size // 8)).astype(np.float32)
    imgs = F.interpolate(torch.from_numpy(low), size=(size, size),
                         mode="bilinear", align_corners=False)
    imgs = (imgs + 0.1 * torch.from_numpy(
        rng.standard_normal((n, 3, size, size)).astype(np.float32))).clamp(-1, 1)
    synth = TextSynthesizer(random.Random(seed))
    cmds = [synth(rng.integers(0, 2, 8), rng.integers(0, 2, 8)) for _ in range(n)]
    return imgs.permute(0, 2, 3, 1).contiguous().numpy(), cmds


def load_weights(gen, path: str) -> None:
    with np.load(path) as z:
        load_jax_params(gen, {k: z[k] for k in z.files})


def load_checkpoint(gen, cfg, vocab_size: int, path: str,
                    step: Optional[int] = None, use_ema: bool = True) -> int:
    """Load the generator (the EMA copy with `use_ema`) of a training
    checkpoint (directory or file; `step` default the latest) into `gen`,
    on its device; returns the checkpoint's step.  Refuses a checkpoint of
    another vocabulary or compute dtype."""
    dev = next(gen.parameters()).device
    ckpt = read_checkpoint(checkpoint_file(path, step), map_location=dev,
                           header=checkpoint_header(cfg, vocab_size))
    gen.load_state_dict(ckpt["ema_gen" if use_ema else "gen"])
    return ckpt["step"]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="configs/celeba_faces.yaml")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--checkpoint",
                     help="checkpoint directory of the port's training CLI, "
                          "or one checkpoint file")
    src.add_argument("--weights",
                     help=".npz of a JAX generator's parameters, keys "
                          "flattened with '/'")
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step to load (default: the latest)")
    p.add_argument("--use_ema", type=int, default=1,
                   help="1: serve the checkpoint's EMA generator")
    p.add_argument("--list", required=True, help="TSV: image<TAB>command")
    p.add_argument("--image_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from PIL import Image

    device = resolve_device(args.device)
    cfg = load_config(args.config)
    vocab = Vocab(cfg.dataset)
    gen = build_generator(cfg, vocab.size, device=device)
    if args.checkpoint:
        step = load_checkpoint(gen, cfg, vocab.size, args.checkpoint,
                               args.step, bool(args.use_ema))
        print(f"loaded checkpoint step {step} from {args.checkpoint}", flush=True)
    else:
        load_weights(gen, args.weights)
        print(f"loaded weights from {args.weights}", flush=True)
    infer = make_infer_fn(cfg, gen)

    pairs = read_src2trg(args.list)
    os.makedirs(args.out_dir, exist_ok=True)
    # pad the tail chunk to a full batch so every batch has one shape
    bs = args.batch_size
    for i in range(0, len(pairs), bs):
        chunk = pairs[i: i + bs]
        imgs = []
        for name, _ in chunk:
            with Image.open(os.path.join(args.image_dir, name)) as im:
                imgs.append(_center_crop_resize(im, cfg.crop_size,
                                                cfg.image_size))
        pad = bs - len(chunk)
        batch = np.stack(imgs + [imgs[-1]] * pad)
        cmds = [c for _, c in chunk] + ["do nothing"] * pad
        out = translate_batch(infer, batch, cmds, vocab, cfg.max_text_len,
                              device)
        out = out[: len(chunk)].cpu().numpy()
        for j, ((name, _), img) in enumerate(zip(chunk, out)):
            u8 = ((np.clip(img, -1, 1) + 1) * 127.5 + 0.5).astype(np.uint8)
            Image.fromarray(u8).save(os.path.join(
                args.out_dir, f"{i + j:06d}_{os.path.basename(name)}"))
        print(f"{min(i + bs, len(pairs))}/{len(pairs)}")
    print(f"wrote {len(pairs)} images to {args.out_dir}")


if __name__ == "__main__":
    main()
