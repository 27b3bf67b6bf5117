"""FID and Inception Score (pure NumPy statistics in float64).

A copy of `dwcgan_tpu/eval/metrics.py`: the same operations in the same
order, so the port's scores are the JAX package's bit for bit on the same
features and logits.  The trace of sqrt(S1 S2) is taken through the
symmetric form S1^1/2 S2 S1^1/2 with `eigh`, not `scipy.linalg.sqrtm`.
The protocol is the reference's (README.md:48-50): 10k real images
against 10k translated ones (`valid/FID-IS/`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def feature_stats(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(mu, sigma) of an [N, D] feature matrix."""
    f = np.asarray(features, dtype=np.float64)
    mu = f.mean(axis=0)
    sigma = np.cov(f, rowvar=False)
    return mu, sigma


def _sqrtm_psd(mat: np.ndarray) -> np.ndarray:
    """Matrix square root of a symmetric PSD matrix via eigendecomposition."""
    vals, vecs = np.linalg.eigh((mat + mat.T) / 2.0)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def fid_from_stats(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """Frechet distance ||mu1-mu2||^2 + Tr(S1 + S2 - 2 sqrt(S1 S2)), the
    trace of the root as tr(sqrtm(S1^1/2 S2 S1^1/2))."""
    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    s1 = np.asarray(sigma1, np.float64) + eps * np.eye(len(mu1))
    s2 = np.asarray(sigma2, np.float64) + eps * np.eye(len(mu2))
    diff = mu1 - mu2
    s1_half = _sqrtm_psd(s1)
    covmean_tr = np.trace(_sqrtm_psd(s1_half @ s2 @ s1_half))
    return float(diff @ diff + np.trace(s1) + np.trace(s2) - 2.0 * covmean_tr)


def inception_score(logits: np.ndarray, splits: int = 10) -> Tuple[float, float]:
    """IS = exp(E_x KL(p(y|x) || p(y))) over `splits` chunks -> (mean, std)."""
    logits = np.asarray(logits, dtype=np.float64)
    logits = logits - logits.max(axis=1, keepdims=True)
    probs = np.exp(logits)
    probs /= probs.sum(axis=1, keepdims=True)
    scores = []
    for chunk in np.array_split(probs, splits):
        if len(chunk) == 0:
            continue
        py = chunk.mean(axis=0, keepdims=True)
        kl = (chunk * (np.log(chunk + 1e-16) - np.log(py + 1e-16))).sum(axis=1)
        scores.append(np.exp(kl.mean()))
    return float(np.mean(scores)), float(np.std(scores))
