"""Quality evidence over a training run's checkpoints, on the card (the
counterpart of `tools/quality_eval.py`, with its flags and `--device`).

    python -m dwcgan_tpu_torch.cli.quality_eval --run_dir RUN \
        --config configs/celeba_quality.yaml [--n_eval 1024] [--batch 32] \
        [--out quality_artifacts] [--steps 1000,2000] [--device cuda]

`RUN` holds `checkpoints/` (the port's `OUT/outputs/<config name>`), or is
the `--output_path` of `cli/train.py`, under which that directory is
looked for.  For every checkpoint (or those of `--steps`) the EMA
generator translates a held-out procedural test set (`held_out_set`: the
test split that `cli/train.py --procedural_data` displays, each face
paired with another face's labels as its command's target) and
`evaluate` reports:

- `fid_rel`, `is_mean`: FID of the translations against the real renders,
  and IS, through an InceptionV3 with random weights
  (`init_random_inception(0)`), the same network for every checkpoint.
  The port draws it from a `torch.Generator`, so it is not the JAX tool's
  network: `fid_rel` is a trend inside the port, comparable across its
  checkpoints and not with the JAX tool's numbers;
- `attr_transfer_acc`, `attr_acc_per_bit`: the analytic probe of
  `data/procedural.py` reads the 8 attribute bits off each translation
  and scores them against the commanded target labels (comparable with
  the JAX tool's: no network is involved);
- `nochange_recon_l1`: mean |output - input| of the first batch under the
  commands that ask for no change.

Writes `grid_<step:08d>.jpg` (real / translated rows of 8) per checkpoint
and `quality_trend.json` (the rows and the run's provenance) to `--out`,
and prints one JSON row per checkpoint.  Runs on the card unless
`--device cpu`.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from dwcgan_tpu_torch.cli.translate import load_checkpoint
from dwcgan_tpu_torch.config import Config, load_config
from dwcgan_tpu_torch.data.procedural import ProceduralFaceDataset, attribute_accuracy
from dwcgan_tpu_torch.device import resolve_device
from dwcgan_tpu_torch.eval.harness import compute_fid_is
from dwcgan_tpu_torch.eval.inception import init_random_inception
from dwcgan_tpu_torch.models.generator import build_generator
from dwcgan_tpu_torch.text.vocab import Vocab, tokens_to_ids
from dwcgan_tpu_torch.train.checkpoint import checkpoint_steps
from dwcgan_tpu_torch.train.sampler import make_infer_fn
from dwcgan_tpu_torch.utils.images import save_image_grid

INCEPTION = "random-weights seed 0 (the port's torch.Generator draw)"


class HeldOut(NamedTuple):
    """The held-out set: real renders [n, H, W, 3] in [-1, 1], their labels
    and the commanded target labels [n, 8], the commands' token ids and
    lengths, and the no-change commands of the first `batch` faces."""
    reals: np.ndarray
    srcs: np.ndarray
    trgs: np.ndarray
    txt: np.ndarray
    lens: np.ndarray
    txt_id: np.ndarray
    lens_id: np.ndarray
    batch: int


def held_out_set(cfg: Config, n_eval: int, batch: int) -> HeldOut:
    """The JAX tool's held-out set (tools/quality_eval.py:66-92): the test
    split of `seed + 777`, face i commanded to the labels of face
    perm[i] (`default_rng(123)`), commands drawn from the dataset's own
    synthesizer in the tool's order."""
    ds = ProceduralFaceDataset(n_samples=max(n_eval, 512), image_size=cfg.image_size,
                               seed=cfg.seed + 777, mode="test",
                               max_text_len=cfg.max_text_len)
    n = min(n_eval, len(ds))
    perm = np.random.default_rng(123).permutation(len(ds))[:n]
    reals, srcs, trgs, cmds = [], [], [], []
    for i in range(n):
        reals.append(ds.render(i))
        srcs.append(ds.labels[i])
        trgs.append(ds.labels[perm[i]])
        cmds.append(ds.synth.labels2text(ds.labels[i], trgs[-1]).split())
    txt, lens = tokens_to_ids(cmds, ds.vocab, max_len=cfg.max_text_len)
    txt_id, lens_id = tokens_to_ids(
        [ds.synth.labels2text(s, s).split() for s in srcs[:batch]],
        ds.vocab, max_len=cfg.max_text_len)
    return HeldOut(np.stack(reals), np.stack(srcs), np.stack(trgs), txt, lens,
                   txt_id, lens_id, batch)


def _infer(infer, images, txt, lens, device) -> np.ndarray:
    # token ids on the device, the lengths on the host, as translate_batch
    out = infer(torch.from_numpy(np.ascontiguousarray(images)).to(device),
                torch.from_numpy(txt).to(device), torch.from_numpy(lens))
    return out.float().cpu().numpy()


def translate_set(infer, held: HeldOut, device) -> np.ndarray:
    """Every held-out face through its command, `held.batch` at a time ->
    [n, H, W, 3] float32 on the host."""
    b = held.batch
    return np.concatenate([
        _infer(infer, held.reals[i:i + b], held.txt[i:i + b], held.lens[i:i + b], device)
        for i in range(0, len(held.reals), b)])


def evaluate(infer, inception, held: HeldOut, rounded: bool = True) -> dict:
    """One checkpoint's row (tools/quality_eval.py:121-146): `infer` from
    `make_infer_fn` on the generator to score, `inception` an InceptionV3
    on the generator's device.  `rounded`: as the JAX tool rounds them;
    else the unrounded floats."""
    dev = next(inception.parameters()).device
    fakes = translate_set(infer, held, dev)
    acc = attribute_accuracy(fakes, held.trgs)
    b, n = held.batch, len(held.reals)
    fid = compute_fid_is((held.reals[i:i + b] for i in range(0, n, b)),
                         (fakes[i:i + b] for i in range(0, n, b)), inception)
    rec = _infer(infer, held.reals[:b], held.txt_id, held.lens_id, dev)
    rec_l1 = float(np.abs(rec - held.reals[:b]).mean())
    r = round if rounded else (lambda v, d: v)
    return {"fid_rel": r(float(fid["fid"]), 3),
            "is_mean": r(float(fid["is_mean"]), 3),
            "attr_transfer_acc": r(float(acc.mean()), 4),
            "attr_acc_per_bit": [r(float(a), 3) for a in acc],
            "nochange_recon_l1": r(rec_l1, 4)}


def checkpoint_dir(run_dir: str, config: str) -> str:
    """`RUN/checkpoints`, or the training CLI's
    `RUN/outputs/<config name>/checkpoints`."""
    direct = os.path.join(run_dir, "checkpoints")
    if os.path.isdir(direct):
        return direct
    name = os.path.splitext(os.path.basename(config))[0]
    return os.path.join(run_dir, "outputs", name, "checkpoints")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--run_dir", required=True,
                   help="run output dir containing checkpoints/ (or the "
                        "training CLI's --output_path)")
    p.add_argument("--config", default="configs/celeba_quality.yaml")
    p.add_argument("--n_eval", type=int, default=1024)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--out", default="quality_artifacts")
    p.add_argument("--steps", type=str, default="",
                   help="comma-separated checkpoint steps (default: all)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> list:
    """Evaluate as the module docstring says; returns the rows."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = load_config(args.config)
    ckpt_dir = os.path.abspath(checkpoint_dir(args.run_dir, args.config))
    steps = checkpoint_steps(ckpt_dir)
    if args.steps:
        want = {int(s) for s in args.steps.split(",")}
        steps = [s for s in steps if s in want]
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    print(f"checkpoints: {steps}", flush=True)
    os.makedirs(args.out, exist_ok=True)

    held = held_out_set(cfg, args.n_eval, args.batch)
    n = len(held.reals)
    print(f"rendered {n} real/test images + commands", flush=True)
    vocab = Vocab(cfg.dataset)
    gen = build_generator(cfg, vocab.size, device=dev)
    infer = make_infer_fn(cfg, gen)
    inception = init_random_inception(0, device=dev)

    results = []
    for step in steps:
        t0 = time.perf_counter()
        load_checkpoint(gen, cfg, vocab.size, ckpt_dir, step, use_ema=True)
        row = {"step": int(step), **evaluate(infer, inception, held)}
        grid = _infer(infer, held.reals[:held.batch], held.txt[:held.batch],
                      held.lens[:held.batch], dev)
        save_image_grid([held.reals[:8], grid[:8]], 8,
                        os.path.join(args.out, f"grid_{step:08d}.jpg"))
        results.append(row)
        print(json.dumps(row), flush=True)
        print(f"step {step}: {time.perf_counter() - t0:.3f} s on the host", flush=True)

    with open(args.config, "rb") as f:
        cfg_sha = hashlib.sha256(f.read()).hexdigest()[:16]
    with open(os.path.join(args.out, "quality_trend.json"), "w") as f:
        json.dump({"n_eval": n, "inception": INCEPTION,
                   "config": os.path.relpath(args.config),
                   "config_sha256_16": cfg_sha,
                   "run_dir": os.path.relpath(args.run_dir),
                   "norm_stats": cfg.norm_stats, "seed": cfg.seed,
                   "results": results}, f, indent=1)
        f.write("\n")
    print(f"wrote {args.out}/quality_trend.json", flush=True)
    return results


if __name__ == "__main__":
    main()
