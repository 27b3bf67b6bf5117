"""Training batches (the port's own copies of `Batch` and
`synthetic_batch`, `dwcgan_tpu/data/pipeline.py:28-64`), and `to_device`.

`synthetic_batch` gives the same numpy arrays as the JAX package's for the
same arguments: random images and commands synthesized from random label
pairs.  The threaded prefetch pipeline and the CelebA and procedural
datasets are not ported yet.
"""

from __future__ import annotations

import random
from typing import NamedTuple

import numpy as np
import torch

from dwcgan_tpu_torch.data.labels import all_domains
from dwcgan_tpu_torch.text.synthesis import TextSynthesizer
from dwcgan_tpu_torch.text.vocab import Vocab, tokens_to_ids


class Batch(NamedTuple):
    """One training batch; everything fixed-shape.

    image:     [B, H, W, 3] float32 in [-1, 1]
    src_label: [B, num_cls] float32 in {0, 1}
    trg_label: [B, num_cls] float32 in {0, 1}
    txt:       [B, max_len + 2] int token ids (BOS ... EOS PAD*)
    txt_len:   [B] int (BOS + words + EOS)
    """

    image: object
    src_label: object
    trg_label: object
    txt: object
    txt_len: object


def synthetic_batch(batch_size: int, image_size: int = 128, num_cls: int = 8,
                    max_text_len: int = 80, seed: int = 0,
                    dataset: str = "CelebA") -> Batch:
    """Random images + genuinely synthesized commands from random label
    pairs (numpy arrays)."""
    rng = random.Random(seed)
    nprng = np.random.default_rng(seed)
    synth = TextSynthesizer(rng)
    vocab = Vocab(dataset)
    domains = all_domains(num_cls)
    src = domains[nprng.integers(0, len(domains), batch_size)]
    trg = domains[nprng.integers(0, len(domains), batch_size)]
    cmds = [synth.labels2text(s, t).split() for s, t in zip(src, trg)]
    txt, lens = tokens_to_ids(cmds, vocab, max_len=max_text_len)
    image = nprng.uniform(-1.0, 1.0, (batch_size, image_size, image_size, 3)).astype(np.float32)
    return Batch(image, src.astype(np.float32), trg.astype(np.float32), txt, lens)


def to_device(batch: Batch, device) -> Batch:
    """numpy batch -> torch tensors on `device`; `txt_len` stays on the
    host, where the LSTM reads how many steps to run (no device sync)."""
    dev = torch.device(device)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32)).to(dev, non_blocking=True)
    return Batch(f32(batch.image), f32(batch.src_label), f32(batch.trg_label),
                 torch.as_tensor(np.asarray(batch.txt, np.int64)).to(dev),
                 torch.as_tensor(np.asarray(batch.txt_len, np.int64)))
