"""GMM latent-space distances (the counterpart of
`dwcgan_tpu/losses/gmm.py`).  Styles are [N, K, C] (K attributes, C dims
each); component means [N, K] in {-1, +1}.  The v1 forms (`*_flat`) take
flat [N, D] styles."""

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


def gmm_kl_flat(pred_mu, pred_var, mus, sigma_sq: float) -> torch.Tensor:
    """The v1 KL over flat [N, D] styles (gmm.py:39-46, reference
    gmm.py:4-10): it takes the *variance*, not the log-variance; summed
    over D, averaged over N."""
    mu, var, m = pred_mu.float(), pred_var.float(), mus.float()
    kl = 0.5 * (torch.log(sigma_sq / var) + (var + (mu - m).square()) / sigma_sq
                - 1.0)
    return kl.sum(dim=1).mean()


def gmm_emd_flat(pred_mu, mus) -> torch.Tensor:
    """The v1 earth-mover distance over flat [N, D] styles (gmm.py:49-53)."""
    return (pred_mu.float() - mus.float()).abs().sum(dim=1).mean()
