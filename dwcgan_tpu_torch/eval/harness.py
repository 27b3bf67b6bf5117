"""FID/IS evaluation over the reference protocol lists (the counterpart of
`dwcgan_tpu/eval/harness.py`).

Protocol (reference `valid/FID-IS/`):
- `trg_celeba-1e4.lst`: 10k real CelebA image names (the FID reference set);
- `src2trg_celeba-1e4-overall.lst`: 10k lines "image<TAB>command"; each
  source image is translated by its command, and the results are the fake
  set.

Generation and feature extraction run on the model's device (the card in
the CLI), batch by batch; the statistics are float64 NumPy on the host
(`eval/metrics.py`).
"""

from __future__ import annotations

import os
from typing import Iterable, List, Sequence, Tuple

import numpy as np
import torch

from dwcgan_tpu_torch.eval.inception import fp32_precision, preprocess_for_inception
from dwcgan_tpu_torch.eval.metrics import feature_stats, fid_from_stats, inception_score


def read_list(path: str) -> List[str]:
    """The non-blank lines of a list file, without their newline."""
    with open(path, "r") as f:
        return [ln.rstrip("\n") for ln in f if ln.strip()]


def read_src2trg(path: str) -> List[Tuple[str, str]]:
    """Lines of 'image<TAB>command' -> [(image, command)]."""
    out = []
    for ln in read_list(path):
        name, _, cmd = ln.partition("\t")
        out.append((name, cmd))
    return out


class FeatureExtractor:
    """InceptionV3 pool3 features and logits, batch by batch on `device`
    (default: the model's), in fp32 with TF32 off."""

    def __init__(self, model, device=None):
        self.model = model.eval()
        self.device = torch.device(device) if device is not None else \
            next(model.parameters()).device

    def run(self, images: Iterable) -> Tuple[np.ndarray, np.ndarray]:
        """images: iterable of [B, H, W, 3] in [-1, 1] (host arrays or
        tensors) -> (features [N, 2048], logits [N, classes]) on the host."""
        feats, logits = [], []
        with torch.inference_mode(), fp32_precision():
            for batch in images:
                x = torch.as_tensor(batch).to(self.device)
                f, l = self.model(preprocess_for_inception(x))
                feats.append(f.cpu().numpy())
                logits.append(l.cpu().numpy())
        return np.concatenate(feats), np.concatenate(logits)


def compute_fid_is(real_batches: Iterable, fake_batches: Iterable, model) -> dict:
    """FID(real, fake) + IS(fake) with one extractor (`model`, an
    `InceptionV3` on its device)."""
    ex = FeatureExtractor(model)
    real_f, _ = ex.run(real_batches)
    fake_f, fake_logits = ex.run(fake_batches)
    mu_r, s_r = feature_stats(real_f)
    mu_f, s_f = feature_stats(fake_f)
    is_mean, is_std = inception_score(fake_logits)
    return {
        "fid": fid_from_stats(mu_r, s_r, mu_f, s_f),
        "is_mean": is_mean,
        "is_std": is_std,
        "n_real": len(real_f),
        "n_fake": len(fake_f),
    }


def fake_batch(infer, images: np.ndarray, commands: Sequence[str], vocab,
               max_text_len: int, device) -> np.ndarray:
    """One batch of the fake set: source images [N, H, W, 3] in [-1, 1] and
    their commands through `translate_batch`, copied to the host once."""
    from dwcgan_tpu_torch.cli.translate import translate_batch
    return translate_batch(infer, images, commands, vocab, max_text_len,
                           device).cpu().numpy()


def load_images(image_dir: str, names: Sequence[str], crop_size: int,
                image_size: int) -> np.ndarray:
    """The named images decoded by PIL, centre-cropped and resized as the
    JAX CLI does (`_center_crop_resize`: the native bilinear) -> [N, H, W, 3]
    float32 in [-1, 1]."""
    from PIL import Image

    from dwcgan_tpu_torch.cli.translate import _center_crop_resize
    imgs = []
    for name in names:
        with Image.open(os.path.join(image_dir, name)) as im:
            imgs.append(_center_crop_resize(im, crop_size, image_size))
    return np.stack(imgs)


def generate_fakes(infer, dataset_dir: str, pairs: List[Tuple[str, str]], vocab,
                   image_size: int = 128, crop_size: int = 178,
                   batch_size: int = 32, max_text_len: int = 80, device="cuda"):
    """Yield batches of translated images [B, H, W, 3] (host float32)
    following the src2trg pairs; the last batch may be short."""
    for i in range(0, len(pairs), batch_size):
        chunk = pairs[i: i + batch_size]
        imgs = load_images(dataset_dir, [n for n, _ in chunk], crop_size, image_size)
        yield fake_batch(infer, imgs, [c for _, c in chunk], vocab, max_text_len,
                         device)
