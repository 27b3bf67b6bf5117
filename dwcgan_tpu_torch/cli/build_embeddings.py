"""Offline tool: build the pretrained-embedding pickle from fastText
vectors (the counterpart of `dwcgan_tpu/cli/build_embeddings.py`;
reference `tools/build_embeddings.py`): fastText wiki.en 300-d vectors for
every vocabulary word, pickled as {word: float32[300]}.

No network, so the user supplies `wiki.en.vec` (text: "word v1 ... v300"
per line).

    python -m dwcgan_tpu_torch.cli.build_embeddings --vectors wiki.en.vec \
        --dataset CelebA --out datasets/embeddings.npy

The training CLI reads the file through the config's `pretrained_embed`.
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

from dwcgan_tpu_torch.text.vocab import Vocab


def build(vectors_path: str, dataset: str, out: str, dim: int = 300):
    vocab = Vocab(dataset)
    wanted = set(vocab.itos)
    found = {}
    with open(vectors_path, "r", encoding="utf-8", errors="ignore") as f:
        for line in f:
            parts = line.rstrip().split(" ")
            if len(parts) != dim + 1:
                continue  # header or malformed line
            word = parts[0]
            if word in wanted and word not in found:
                found[word] = np.asarray(parts[1:], dtype=np.float32)
                if len(found) == len(wanted):
                    break
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "wb") as f:
        pickle.dump(found, f)
    missing = sorted(wanted - set(found))
    print(f"wrote {out}: {len(found)}/{len(wanted)} vocab words found"
          + (f"; missing (will use N(0,0.6) rows): {missing}" if missing else ""))


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--vectors", required=True, help="fastText .vec text file")
    p.add_argument("--dataset", default="CelebA", choices=["CelebA", "CUB200"])
    p.add_argument("--out", required=True)
    p.add_argument("--dim", type=int, default=300)
    a = p.parse_args()
    build(a.vectors, a.dataset, a.out, a.dim)
