"""CelebA dataset: attribute parsing, split, pairing, text synthesis (the
port's counterpart of `dwcgan_tpu/data/celeba.py:57-159`).

- parse `list_attr_celeba.txt`, select the 8 attributes;
- seed-1234 shuffle; the first `test_split` rows are the test set, the
  rest the training set;
- each sample pairs with a random other sample's label;
- the command is synthesized on the fly and tokenized to a fixed width;
- the image is decoded by PIL (optional: without it an item raises, as in
  the JAX package), then centre-cropped, resized and, in training, flipped
  at random by `data/preprocess.py` (the NumPy mirror of the JAX package's
  native kernel, which its CLI runs by default).  The flip mirrors the
  source before the crop, JAX's order.
"""

from __future__ import annotations

import os
import random
from typing import List, Tuple

import numpy as np

from dwcgan_tpu_torch.data.drawkey import draw_key
from dwcgan_tpu_torch.data.preprocess import preprocess_batch
from dwcgan_tpu_torch.text.synthesis import CELEBA_ATTRS, TextSynthesizer
from dwcgan_tpu_torch.text.vocab import Vocab, tokens_to_ids

try:  # Pillow is optional: the synthetic and procedural data never need it
    from PIL import Image
except ImportError:  # pragma: no cover
    Image = None


class CelebADataset:
    """CelebA images + attribute labels + synthesized commands.  Items are
    (image [H, W, 3] float32 in [-1, 1], src_label, trg_label, txt_ids,
    txt_len), numpy."""

    def __init__(self, image_dir: str, attr_path: str,
                 selected_attrs: Tuple[str, ...] = CELEBA_ATTRS,
                 mode: str = "train", crop_size: int = 178,
                 image_size: int = 128, max_text_len: int = 80,
                 seed: int = 1234, test_split: int = 1999):
        self.image_dir = image_dir
        self.mode = mode
        self.crop_size = crop_size
        self.image_size = image_size
        self.max_text_len = max_text_len
        self.vocab = Vocab("CelebA")
        self.seed = seed
        self.rng = random.Random(seed)
        self.synth = TextSynthesizer(self.rng)
        self._rng_salt = 0
        self.samples = self._parse(attr_path, selected_attrs, seed, test_split)

    def reseed_augmentation(self, salt: int) -> None:
        """Decorrelate the per-item draws (target pairing, flip, text)
        across data-parallel hosts; the split stays the same on every host."""
        self._rng_salt = salt
        self.rng = random.Random(self.seed * 1_000_003 + 7919 * (salt + 1))
        self.synth = TextSynthesizer(self.rng)

    def _parse(self, attr_path, selected_attrs, seed,
               test_split) -> List[Tuple[str, List[int]]]:
        with open(attr_path, "r") as f:
            lines = [ln.rstrip() for ln in f]
        attr2idx = {a: i for i, a in enumerate(lines[1].split())}
        cols = [attr2idx[a] for a in selected_attrs]
        rows = lines[2:]
        random.Random(seed).shuffle(rows)
        out = []
        for i, row in enumerate(rows):
            parts = row.split()
            label = [int(parts[1 + c] == "1") for c in cols]
            if (self.mode == "test") == (i < test_split):
                out.append((parts[0], label))
        return out

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, index: int):
        return self._make_item(index, self.rng, self.synth)

    def item(self, index: int, epoch: int):
        """`__getitem__` with its draws keyed by (seed, host salt, epoch,
        index) instead of the shared generator: the content does not depend
        on which worker thread builds it (data/drawkey.py)."""
        rng = random.Random(draw_key(self.seed, self._rng_salt, epoch, index))
        return self._make_item(index, rng, TextSynthesizer(rng))

    def _make_item(self, index: int, rng: random.Random,
                   synth: TextSynthesizer):
        fname, src_label = self.samples[index]
        _, trg_label = rng.choice(self.samples)
        command = synth.labels2text(np.array(src_label), np.array(trg_label))
        ids, lens = tokens_to_ids([command.split()], self.vocab, self.max_text_len)
        if Image is None:
            raise RuntimeError("Pillow not available; use the synthetic pipeline")
        with Image.open(os.path.join(self.image_dir, fname)) as im:
            arr = np.asarray(im.convert("RGB"), dtype=np.uint8)
        flip = self.mode == "train" and rng.random() < 0.5
        image = preprocess_batch(arr[None], self.crop_size, self.image_size,
                                 hflips=np.array([flip]))[0]
        return (image, np.asarray(src_label, dtype=np.float32),
                np.asarray(trg_label, dtype=np.float32), ids[0], lens[0])
