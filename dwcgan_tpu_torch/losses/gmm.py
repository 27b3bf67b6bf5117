"""GMM latent-space distances (the counterpart of
`dwcgan_tpu/losses/gmm.py:15-36`).  Styles are [N, K, C] (K attributes,
C dims each); component means [N, K] in {-1, +1}."""

from __future__ import annotations

import math

import torch


def gmm_kl(pred_mu, pred_logvar, comp_means, sigma_sq: float) -> torch.Tensor:
    """KL(N(mu, exp(logvar)) || N(comp_mean, sigma_sq)): summed over C,
    averaged over N, summed over K (gmm_kl_distance_sp, gmm.py:13-22)."""
    mu, logvar = pred_mu.float(), pred_logvar.float()
    m = comp_means.float()[:, :, None]
    kl = 0.5 * (math.log(sigma_sq) - logvar
                + (logvar.exp() + (mu - m).square()) / sigma_sq - 1.0)
    return kl.sum(dim=2).mean(dim=0).sum()


def gmm_emd(pred_mu, comp_means) -> torch.Tensor:
    """Earth-mover (L1 to the component mean) variant (gmm.py:33-41)."""
    m = comp_means.float()[:, :, None]
    return (pred_mu.float() - m).abs().sum(dim=2).mean(dim=0).sum()
