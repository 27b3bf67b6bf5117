"""Evaluation CLI: FID/IS over the reference protocol lists, on the card
(the counterpart of `dwcgan_tpu/cli/evaluate.py`, with its flags and
`--device`).

    python -m dwcgan_tpu_torch.cli.evaluate --config configs/celeba_faces.yaml \
        --checkpoint OUT/outputs/celeba_faces/checkpoints \
        --real_list valid/FID-IS/trg_celeba-1e4.lst \
        --src2trg_list valid/FID-IS/src2trg_celeba-1e4-overall.lst \
        --inception iv3.npz

The generator is a checkpoint of the port (`cli/train.py` or
`cli/import_reference.py`; the EMA copy unless `--use_ema 0`).  The
sources of `--src2trg_list` are translated by their commands, and the
images of `--real_list` read, from the config's `data_root` (PIL decodes,
then the centre crop and resize of the JAX CLI); InceptionV3 (weights from
`cli/convert_inception.py`, else random: relative comparisons only) takes
both sets.  Prints one JSON line: `fid`, `is_mean`, `is_std`, `n_real`,
`n_fake`.  Runs on the card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import json

from dwcgan_tpu_torch.cli.convert_inception import load_converted
from dwcgan_tpu_torch.cli.translate import load_checkpoint
from dwcgan_tpu_torch.config import load_config
from dwcgan_tpu_torch.device import resolve_device
from dwcgan_tpu_torch.eval.harness import (compute_fid_is, generate_fakes,
                                           load_images, read_list, read_src2trg)
from dwcgan_tpu_torch.eval.inception import InceptionV3, init_random_inception
from dwcgan_tpu_torch.models.generator import build_generator
from dwcgan_tpu_torch.text.vocab import Vocab
from dwcgan_tpu_torch.train.sampler import make_infer_fn


def load_generator(cfg, vocab_size: int, checkpoint: str, use_ema: bool = True,
                   device="cuda"):
    """(generator, step): the generator of `cfg` with the latest weights of
    a port checkpoint (the EMA copy with `use_ema`), on `device`, for
    serving."""
    gen = build_generator(cfg, vocab_size, device=device)
    return gen, load_checkpoint(gen, cfg, vocab_size, checkpoint, use_ema=use_ema)


def main(argv=None) -> dict:
    """Evaluate as the module docstring says; returns the printed dict."""
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="configs/celeba_faces.yaml")
    p.add_argument("--checkpoint", required=True,
                   help="checkpoint directory of the port, or one checkpoint file")
    p.add_argument("--real_list", required=True)
    p.add_argument("--src2trg_list", required=True)
    p.add_argument("--inception", default=None,
                   help=".npz from cli.convert_inception; omit for random "
                        "features (relative comparisons only)")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--limit", type=int, default=None,
                   help="evaluate only the first N list entries")
    p.add_argument("--use_ema", type=int, default=1)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = load_config(args.config)
    vocab = Vocab(cfg.dataset)
    gen, _ = load_generator(cfg, vocab.size, args.checkpoint, bool(args.use_ema), dev)
    infer = make_infer_fn(cfg, gen)
    if args.inception:
        iv3 = load_converted(args.inception, InceptionV3().to(dev))
    else:
        print("WARNING: no inception weights; FID uses a random-init "
              "extractor (valid only for relative comparisons)")
        iv3 = init_random_inception(device=dev)

    reals = read_list(args.real_list)[: args.limit]
    pairs = read_src2trg(args.src2trg_list)[: args.limit]
    bs = args.batch_size
    real_batches = (load_images(cfg.data_root, reals[i: i + bs], cfg.crop_size,
                                cfg.image_size) for i in range(0, len(reals), bs))
    fakes = generate_fakes(infer, cfg.data_root, pairs, vocab, cfg.image_size,
                           cfg.crop_size, bs, cfg.max_text_len, dev)
    results = compute_fid_is(real_batches, fakes, iv3)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
