"""CelebA dataset: attribute parsing, split, pairing, text synthesis (the
port's counterpart of `dwcgan_tpu/data/celeba.py:57-159`).

- parse `list_attr_celeba.txt`, select the 8 attributes;
- seed-1234 shuffle; the first `test_split` rows are the test set, the
  rest the training set;
- each sample pairs with a random other sample's label;
- the command is synthesized on the fly and tokenized to a fixed width;
- the image is decoded by PIL (optional: without it an item raises, as in
  the JAX package), flipped at random in training (the source, before the
  crop: JAX's order), then centre-cropped and resized by
  `_center_crop_resize`, with JAX's backends: `auto` and `native` the
  port's C++ kernel (`dwcgan_tpu_torch/native/`, bit-equal to the JAX
  package's, which its `auto` takes wherever it builds; the port's raises
  where it does not), `pil` PIL's antialiased bilinear.
"""

from __future__ import annotations

import os
import random
from typing import List, Tuple

import numpy as np

from dwcgan_tpu_torch import native
from dwcgan_tpu_torch.data.drawkey import draw_key
from dwcgan_tpu_torch.text.synthesis import CELEBA_ATTRS, TextSynthesizer
from dwcgan_tpu_torch.text.vocab import Vocab, tokens_to_ids

try:  # Pillow is optional: the synthetic and procedural data never need it
    from PIL import Image
except ImportError:  # pragma: no cover
    Image = None


RESIZE_BACKENDS = ("auto", "native", "pil")


def _center_crop_resize(img, crop: int, size: int,
                        backend: str = "auto") -> np.ndarray:
    """CenterCrop(crop) -> Resize(size) -> [-1, 1] of a PIL image, HWC
    float32, as `dwcgan_tpu/data/celeba.py::_center_crop_resize`: `auto`
    and `native` the C++ kernel's half-pixel bilinear
    (`native.preprocess_batch`), `pil` PIL's antialiased bilinear (the
    reference's torchvision path)."""
    if backend not in RESIZE_BACKENDS:
        raise ValueError(f"backend must be one of {RESIZE_BACKENDS}, got {backend!r}")
    img = img.convert("RGB")
    if backend != "pil":
        return native.preprocess_batch(np.asarray(img, dtype=np.uint8)[None], crop,
                                       size)[0]
    w, h = img.size
    left, top = (w - crop) // 2, (h - crop) // 2
    img = img.crop((left, top, left + crop, top + crop))
    img = img.resize((size, size), Image.BILINEAR)
    return np.asarray(img, dtype=np.float32) / 127.5 - 1.0


class CelebADataset:
    """CelebA images + attribute labels + synthesized commands.  Items are
    (image [H, W, 3] float32 in [-1, 1], src_label, trg_label, txt_ids,
    txt_len), numpy."""

    def __init__(self, image_dir: str, attr_path: str,
                 selected_attrs: Tuple[str, ...] = CELEBA_ATTRS,
                 mode: str = "train", crop_size: int = 178,
                 image_size: int = 128, max_text_len: int = 80,
                 seed: int = 1234, test_split: int = 1999,
                 resize_backend: str = "auto"):
        self.image_dir = image_dir
        self.mode = mode
        self.crop_size = crop_size
        self.image_size = image_size
        self.max_text_len = max_text_len
        self.resize_backend = resize_backend
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
            img = im.convert("RGB")
        if self.mode == "train" and rng.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        image = _center_crop_resize(img, self.crop_size, self.image_size,
                                    self.resize_backend)
        return (image, np.asarray(src_label, dtype=np.float32),
                np.asarray(trg_label, dtype=np.float32), ids[0], lens[0])
