"""Where the time of a served batch, or of a training step, goes, on the
card.

    python -m dwcgan_tpu_torch.cli.profile_serve \
        [--config configs/celeba_faces.yaml] [--batch 32] [--batches 5] \
        [--out profile_serve.json]
    python -m dwcgan_tpu_torch.cli.profile_serve --train \
        [--config configs/celeba_faces.yaml] [--batches 5] [--out ...]
    python -m dwcgan_tpu_torch.cli.profile_serve --stem_pallas [--train] ...

Builds the generator of `--config` with random weights from `--seed`, makes
`--batch` seeded requests (smooth random images, commands synthesized from
random label pairs), warms up, then serves `--batches` batches through
`translate_batch` under `torch.profiler` (CPU and CUDA activities).  Prints
and writes (JSON, `--out`):

- the wall time of the window (host clock, ends in a synchronize) and the
  device time summed over the kernels run in it; their ratio gives the
  device's idle share;
- device time per kernel group (this port's norm kernels, convolutions,
  matrix products, the LSTM, everything else), the top kernels by name, and
  every kernel of this port by name;
- the card's name and power limit.

With `--train` it profiles `--batches` training steps of the config's batch
size (`cli/train.py`'s trainer, synthetic batches, after 3 warm-up steps)
instead, and reports per step.  `--stem_pallas` switches the config's
`stem_pallas` on: both encoders' 7x7 stems run the fused stem kernels.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import defaultdict

import torch

from dwcgan_tpu_torch.cli.train import build_trainer, synthetic_batches
from dwcgan_tpu_torch.cli.translate import synthetic_requests, translate_batch
from dwcgan_tpu_torch.config import load_config
from dwcgan_tpu_torch.device import resolve_device
from dwcgan_tpu_torch.models.generator import build_generator
from dwcgan_tpu_torch.text.vocab import Vocab
from dwcgan_tpu_torch.train.sampler import make_infer_fn

# kernel-name substrings -> group (first match wins; lower case)
GROUPS = (
    ("stem kernels (this port)", ("stem_",)),
    ("norm backward kernels (this port)", ("norm_bwd_cluster_kernel",
                                           "ln_bwd_cluster_kernel")),
    ("norm kernels (this port)", ("norm_fwd_cluster_kernel", "ln_fwd_cluster_kernel")),
    ("lstm", ("lstm", "rnn", "persist")),
    ("convolution", ("conv", "xmma", "implicit", "nchw", "nhwc", "winograd",
                     "fft")),
    ("matrix product", ("gemm", "gemv", "cutlass", "splitk")),
)


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def _device_us(avg) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(avg, attr):
            return float(getattr(avg, attr))
    raise AttributeError("profiler event has no device time")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="configs/celeba_faces.yaml")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--batches", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None)
    p.add_argument("--train", action="store_true",
                   help="profile training steps instead of served batches")
    p.add_argument("--stem_pallas", action="store_true",
                   help="run the encoders' 7x7 stems as the fused stem kernels")
    args = p.parse_args(argv)

    dev = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    cfg = load_config(args.config)
    cfg.stem_pallas = cfg.stem_pallas or args.stem_pallas
    if args.train:
        state, step, _ = build_trainer(cfg, dev, seed=args.seed)
        batches = synthetic_batches(cfg, dev, seed=args.seed + 9)
        serve = lambda: step(state, batches[state.step % len(batches)])
        args.batch = cfg.batch_size
    else:
        vocab = Vocab(cfg.dataset)
        gen = build_generator(cfg, vocab.size, device=dev, seed=args.seed)
        infer = make_infer_fn(cfg, gen)
        imgs, cmds = synthetic_requests(args.batch, cfg.image_size, args.seed + 2)
        serve = lambda: translate_batch(infer, imgs, cmds, vocab,
                                        cfg.max_text_len, dev)
    for _ in range(3):
        serve()
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.batches):
            serve()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    per_kernel = defaultdict(float)
    for avg in prof.key_averages():
        if avg.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[avg.key] += _device_us(avg) / 1e3
    if not per_kernel:
        raise RuntimeError("the profiler recorded no device time")
    groups = defaultdict(float)
    for name, ms in per_kernel.items():
        groups[_group(name)] += ms
    busy_ms = sum(per_kernel.values())
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1])
    top = ranked[:25]
    # every kernel of this port by name, however small: the split of a
    # kernel row (e.g. the stem backward's recompute, dW and dX launches)
    ours = [(k, ms) for k, ms in ranked if "(this port)" in _group(k)]
    n = args.batches
    result = {
        "card": card, "config": args.config, "batch": args.batch,
        "per": "training step" if args.train else "served batch",
        "compute_dtype": cfg.compute_dtype, "norm_stats": cfg.norm_stats,
        "stem_pallas": bool(cfg.stem_pallas),
        "batches": n, "wall_ms_per_batch": wall_ms / n,
        "device_ms_per_batch": busy_ms / n,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "groups_ms_per_batch": {g: ms / n for g, ms in
                                sorted(groups.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms_per_batch": [[k, ms / n] for k, ms in top],
        "port_kernels_ms_per_batch": [[k, ms / n] for k, ms in ours],
    }
    print(f"card {card}; {cfg.compute_dtype}, stem_pallas "
          f"{result['stem_pallas']}, batch {args.batch}, "
          f"{n} {result['per']}s profiled (ms below are per {result['per']})")
    print(f"wall {result['wall_ms_per_batch']:.3f} ms/batch, device "
          f"{result['device_ms_per_batch']:.3f} ms/batch, idle share "
          f"{result['device_idle_share']:.3f}")
    for g, ms in result["groups_ms_per_batch"].items():
        print(f"  {g:28s} {ms:9.3f} ms/batch")
    for k, ms in result["top_kernels_ms_per_batch"]:
        print(f"  {ms:9.3f}  {k[:140]}")
    print("this port's kernels:")
    for k, ms in result["port_kernels_ms_per_batch"]:
        print(f"  {ms:9.3f}  {k[:140]}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
