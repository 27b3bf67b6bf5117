"""The reference's own training batches, decoded from the data set's files:
the rules of the port's CelebA feed written out again in plain Python,
PIL and NumPy, so that the reference takes nothing the program's feed
made.

- the attribute file: CelebA's 8 attributes selected, the rows shuffled
  by `random.Random(seed)`, the first `test_split` the test set, the rest
  the training set;
- the order: batch k of epoch 0 is rows k*B ... k*B + B - 1 of
  `np.random.default_rng(seed).permutation(n)`;
- each item draws from `random.Random(key(seed, 0, epoch, index))` (a
  SplitMix64 mix of the four numbers): the target row's label, the
  command (the frozen template engine, `traffic/synthesis.py`), then a
  horizontal flip of the source with probability one half;
- the image: PIL's decode to RGB, the centre crop, a bilinear resize with
  half-pixel centres, and [-1, 1]: y = v / 127.5 - 1.
"""

from __future__ import annotations

import os
import random
from typing import List, Tuple

import numpy as np

from port_bench.reference.vocab import Vocab, tokens_to_ids
from port_bench.traffic.synthesis import CELEBA_ATTRS, TextSynthesizer

MASK = 0xFFFFFFFFFFFFFFFF


def draw_key(*vals: int) -> int:
    """SplitMix64's finalizer over each value in turn: a 64-bit seed."""
    h = 0
    for v in vals:
        h = (h ^ (int(v) + 0x9E3779B97F4A7C15)) & MASK
        h = (h * 0xBF58476D1CE4E5B9) & MASK
        h ^= h >> 31
    return h


def train_rows(attr_path: str, seed: int, test_split: int) -> List[Tuple[str, List[int]]]:
    """(file name, 8 labels) of the training rows, in the feed's order."""
    with open(attr_path, encoding="utf-8") as f:
        lines = [ln.rstrip() for ln in f]
    column = {a: i for i, a in enumerate(lines[1].split())}
    cols = [column[a] for a in CELEBA_ATTRS]
    rows = lines[2:]
    random.Random(seed).shuffle(rows)
    out = []
    for row in rows[test_split:]:
        parts = row.split()
        out.append((parts[0], [int(parts[1 + c] == "1") for c in cols]))
    return out


def crop_resize(img: np.ndarray, crop: int, size: int) -> np.ndarray:
    """[H, W, 3] uint8 -> [size, size, 3] float32 in [-1, 1]: the centre
    `crop` square, sampled bilinearly at half-pixel centres, in float32."""
    h, w, _ = img.shape
    top, left = (h - crop) // 2, (w - crop) // 2
    f = np.float32
    scale = f(crop) / f(size)
    centres = (np.arange(size, dtype=f) + f(0.5)) * scale - f(0.5)
    y, x = centres + f(top), centres + f(left)
    y0 = np.clip(y.astype(np.int64), 0, h - 1)
    x0 = np.clip(x.astype(np.int64), 0, w - 1)
    y1, x1 = np.minimum(y0 + 1, h - 1), np.minimum(x0 + 1, w - 1)
    fy = np.clip(y - y0.astype(f), f(0), f(1))[:, None, None]
    fx = np.clip(x - x0.astype(f), f(0), f(1))[None, :, None]
    v = img.astype(f)
    v00, v01 = v[y0][:, x0], v[y0][:, x1]
    v10, v11 = v[y1][:, x0], v[y1][:, x1]
    upper = v00 + (v01 - v00) * fx
    lower = v10 + (v11 - v10) * fx
    return np.ascontiguousarray((upper + (lower - upper) * fy) * f(1.0 / 127.5) - f(1.0))


def first_batches(image_dir: str, attr_path: str, seed: int, test_split: int, batch: int,
                  count: int, crop: int, size: int, max_text_len: int):
    """The feed's first `count` batches of epoch 0: a list of (image
    [B, size, size, 3] float32, src_label, trg_label [B, 8] float32, txt
    [B, max_text_len + 2] int32, txt_len [B] int32)."""
    from PIL import Image

    rows = train_rows(attr_path, seed, test_split)
    order = np.random.default_rng(seed).permutation(len(rows))
    vocab = Vocab("CelebA")
    out = []
    for k in range(count):
        items = []
        for index in order[k * batch:(k + 1) * batch]:
            index = int(index)
            rng = random.Random(draw_key(seed, 0, 0, index))
            name, src = rows[index]
            _, trg = rng.choice(rows)
            command = TextSynthesizer(rng).labels2text(np.array(src), np.array(trg))
            ids, lens = tokens_to_ids([command.split()], vocab, max_text_len)
            with Image.open(os.path.join(image_dir, name)) as im:
                pixels = np.asarray(im.convert("RGB"), dtype=np.uint8)
            if rng.random() < 0.5:
                pixels = pixels[:, ::-1]
            items.append((crop_resize(pixels, crop, size), np.float32(src), np.float32(trg),
                          ids[0], lens[0]))
        out.append(tuple(np.stack([it[j] for it in items]) for j in range(5)))
    return out
