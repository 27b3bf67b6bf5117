"""Label utilities, host-side numpy (the port's own copy of
`dwcgan_tpu/data/labels.py`; reference tools.py:1-47, celeba_data.py:75-86).

Binary attribute labels map to GMM component means at +/-1; test-time
target labels flip one attribute at a time, with CelebA's hair colours
mutually exclusive."""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

_HAIR_ATTRS = ("Black_Hair", "Blond_Hair", "Brown_Hair", "Gray_Hair")


def label2onehot(labels: np.ndarray, dim: int) -> np.ndarray:
    """Index labels [N] -> one-hot [N, dim] float32 (tools.py:6-11)."""
    labels = np.asarray(labels).astype(np.int64)
    out = np.zeros((labels.shape[0], dim), dtype=np.float32)
    out[np.arange(labels.shape[0]), labels] = 1.0
    return out


def assign_label(label: np.ndarray, c_dim: Optional[int] = None,
                 mode: str = "CelebA", normalize: bool = True) -> np.ndarray:
    """Binary labels -> component means at +/-1 (tools.py:40-47); the
    categorical datasets' indices go one-hot first."""
    label = np.asarray(label, dtype=np.float32)
    if mode not in ("CelebA", "CUB200"):
        label = label2onehot(label, c_dim)
    if normalize:
        label = label * 2.0 - 1.0
    return label


def create_labels(c_org: np.ndarray, c_dim: int = 5, dataset: str = "CelebA",
                  selected_attrs: Optional[Sequence[str]] = None
                  ) -> List[np.ndarray]:
    """One [N, c_dim] target-label array per attribute (tools.py:13-37):
    CelebA toggles the attribute, and setting a hair colour clears the
    others; a categorical dataset gets each class one-hot."""
    c_org = np.asarray(c_org, dtype=np.float32)
    hair_idx = []
    if dataset == "CelebA":
        hair_idx = [i for i, a in enumerate(selected_attrs or ())
                    if a in _HAIR_ATTRS]
    out = []
    for i in range(c_dim):
        if dataset == "CelebA":
            c_trg = c_org.copy()
            if i in hair_idx:
                c_trg[:, i] = 1.0
                for j in hair_idx:
                    if j != i:
                        c_trg[:, j] = 0.0
            else:
                c_trg[:, i] = 1.0 - c_trg[:, i]
        else:
            c_trg = label2onehot(np.full((c_org.shape[0],), i), c_dim)
        out.append(c_trg)
    return out


def all_domains(num_attr: int) -> np.ndarray:
    """All 2^num_attr binary label combinations (celeba_data.py:75-86)."""
    n = 1 << num_attr
    bits = (np.arange(n)[:, None] >> np.arange(num_attr - 1, -1, -1)) & 1
    return bits.astype(np.int64)
