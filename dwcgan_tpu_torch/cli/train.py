"""Training CLI of the port (the counterpart of `dwcgan_tpu/cli/train.py`).

    python -m dwcgan_tpu_torch.cli.train --config configs/celeba_faces.yaml \
        --synthetic_data --max_steps 20 [--device cuda]

Builds the generator and discriminator of `--config` in train mode with
random weights from the config's seed, both Adam optimizers, the EMA copies
and the VGG16 perceptual loss (weights from `vgg_model_path` when that
`.npz` exists, else random-init under `vgg_random_fallback`), then runs
`--max_steps` training steps on the device (the card unless `--device cpu`)
and prints the JAX CLI's `Iteration: ... gen ... dis ... lr ...` line every
`log_iter` steps.

Not ported yet (a later training slice): checkpoints and resume, the
CelebA and procedural datasets, the threaded data pipeline, pretrained word
embeddings, sample grids and the HTML gallery, the metric log, FiniteGuard
and StallWatchdog.  So `--synthetic_data` is required: it cycles a pool of
seeded synthetic batches (random images, commands synthesized from random
label pairs) kept on the device.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from dwcgan_tpu_torch.config import Config, load_config
from dwcgan_tpu_torch.data.pipeline import synthetic_batch, to_device
from dwcgan_tpu_torch.device import resolve_device
from dwcgan_tpu_torch.models.vgg import (Vgg16Features, init_random_vgg,
                                         load_vgg_npz, make_vgg_loss_fn)
from dwcgan_tpu_torch.text.vocab import Vocab
from dwcgan_tpu_torch.train.state import create_train_state
from dwcgan_tpu_torch.train.step import make_train_step

BATCH_POOL = 8


def build_vgg_loss(cfg: Config, device):
    """The perceptual loss of the recipe, or None when vgg_w is 0 or no
    weights exist and the random fallback is off."""
    if cfg.vgg_w <= 0:
        return None
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    vgg = Vgg16Features(dtype)
    if cfg.vgg_model_path and os.path.exists(cfg.vgg_model_path):
        load_vgg_npz(vgg, cfg.vgg_model_path)
        print(f"perceptual loss on (weights: {cfg.vgg_model_path})")
    elif cfg.vgg_random_fallback:
        init_random_vgg(vgg, cfg.seed)
        print(f"vgg_w={cfg.vgg_w} and no VGG weights: random-init VGG "
              "features (vgg_random_fallback)")
    else:
        print(f"vgg_w={cfg.vgg_w} but no VGG weights; perceptual loss off")
        return None
    return make_vgg_loss_fn(vgg.to(device), stats=cfg.norm_stats)


def build_trainer(cfg: Config, device="cuda", seed=None):
    """(state, step_fn, vocab): everything one training iteration needs."""
    dev = resolve_device(device)
    torch.manual_seed(cfg.seed if seed is None else seed)  # anything not given state.rng
    vocab = Vocab(cfg.dataset)
    state = create_train_state(cfg, vocab.size, device=dev, seed=seed)
    step_fn = make_train_step(cfg, state.gen, state.dis, state.gen_opt,
                              state.dis_opt, vgg_loss_fn=build_vgg_loss(cfg, dev))
    return state, step_fn, vocab


def synthetic_batches(cfg: Config, device, n: int = BATCH_POOL, seed: int = 0):
    """`n` seeded synthetic batches of `cfg.batch_size`, on `device`."""
    return [to_device(synthetic_batch(cfg.batch_size, cfg.image_size,
                                      cfg.gen.num_cls, cfg.max_text_len,
                                      seed=seed + i, dataset=cfg.dataset), device)
            for i in range(n)]


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="DWC-GAN training on one card (PyTorch/CUDA port). "
        "Not ported yet: checkpoints and resume, CelebA and procedural data, "
        "the threaded pipeline, pretrained embeddings, sample grids, the "
        "metric log, FiniteGuard and StallWatchdog.")
    p.add_argument("--config", default="configs/celeba_faces.yaml")
    p.add_argument("--synthetic_data", action="store_true",
                   help="train on seeded synthetic batches (required: the "
                        "datasets are not ported yet)")
    p.add_argument("--max_steps", type=int, default=None,
                   help="override config max_iter")
    p.add_argument("--n_critic", type=int, default=None,
                   help="override config n_critic")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = load_config(args.config)
    if args.n_critic is not None:
        cfg.n_critic = max(1, args.n_critic)
    if args.max_steps is not None:
        cfg.max_iter = args.max_steps
    dev = resolve_device(args.device)
    if not args.synthetic_data:
        raise SystemExit("only --synthetic_data is ported so far")
    state, step_fn, _ = build_trainer(cfg, dev)
    n_gen = sum(p.numel() for p in state.gen.parameters())
    n_dis = sum(p.numel() for p in state.dis.parameters())
    print(f"device {dev}; The number of parameters in G: {n_gen}")
    print(f"The number of parameters in D: {n_dis}")
    batches = synthetic_batches(cfg, dev, seed=cfg.seed)
    t0 = time.perf_counter()
    metrics = {}
    while state.step < cfg.max_iter:
        metrics = step_fn(state, batches[state.step % len(batches)])
        if state.step % cfg.log_iter == 0 or state.step == cfg.max_iter:
            gen_loss = float(metrics["loss_gen_total"])   # syncs the device
            dis_loss = float(metrics["loss_dis_all"])
            dt = time.perf_counter() - t0
            t0 = time.perf_counter()
            done = (state.step - 1) % cfg.log_iter + 1
            print(f"Iteration: {state.step:08d}/{cfg.max_iter:08d} "
                  f"gen {gen_loss:.4f} dis {dis_loss:.4f} "
                  f"lr {metrics['lr']:.6g} {done / dt:.2f} it/s", flush=True)
    print("Finish training")
    return state, metrics


if __name__ == "__main__":
    main()
