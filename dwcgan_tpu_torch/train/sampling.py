"""Style sampling, attention blending and style replacement (the
counterparts of `dwcgan_tpu/train/sampling.py`)."""

from __future__ import annotations

from typing import Optional

import torch

from dwcgan_tpu_torch.parallel.mesh import draw


def sample_style(comp_means: torch.Tensor, c_dim: int, stddev: float,
                 eps: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 rows=None) -> torch.Tensor:
    """One style per sample from the attribute GMM: each attribute's c_dim
    block is N(mean_k, stddev), attribute-major -> [N, K * c_dim] fp32.

    The standard-normal draws are `eps` ([N, K, c_dim]) when given (tests
    inject the numbers JAX drew), else they come from `generator` (on the
    device of `comp_means`; `rows`: this rank's rows of the draw at the
    global batch, `parallel.mesh.Rows`)."""
    n, k = comp_means.shape
    if eps is None:
        eps = draw(torch.randn, (n, k, c_dim), generator, comp_means.device, rows)
    z = comp_means.float()[:, :, None] + stddev * eps.float()
    return z.reshape(n, k * c_dim)


def sample_style_flat(mu: torch.Tensor, v_dim: int = 1, stddev: float = 0.5,
                      generator: Optional[torch.Generator] = None,
                      eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The v1 sampler (sampling.py:29-41, reference tools.py:49-55):
    `v_dim` draws of N(mu, stddev) per element of the flat means mu
    [N, M], element-major -> [N, M * v_dim] fp32.  The standard-normal
    draws are `eps` ([N, M, v_dim]) when given, else they come from
    `generator` (on mu's device)."""
    n, m = mu.shape
    if eps is None:
        eps = torch.randn((n, m, v_dim), generator=generator, device=mu.device)
    z = mu.float()[:, :, None] + stddev * eps.float()
    return z.reshape(n, m * v_dim)


def blend_attention(img, att, x_real, att_on: bool = True):
    """Attention-masked edit: img*att + x_real*(1-att) (solver.py:158-170)
    when the model has an attention head and `att_on` (the training step's
    warm-up gate); the raw decode otherwise.  Returns fp32."""
    if att is None or not att_on:
        return img.float()
    att = att.float()
    return img.float() * att + x_real.float() * (1.0 - att)


def style_replace(c_src: torch.Tensor, c_trg: torch.Tensor,
                  z_src: torch.Tensor, z_trg: torch.Tensor,
                  c_dim: int) -> torch.Tensor:
    """Keep the source style for attributes the command leaves unchanged:
    where c_src[n, k] == c_trg[n, k], z_trg's k-th c_dim block becomes
    z_src's (solver.py:134-140).  z_*: [N, K * c_dim] flat styles."""
    n = c_src.shape[0]
    keep = (c_src == c_trg)[:, :, None]
    zs = z_src.reshape(n, -1, c_dim)
    zt = z_trg.reshape(n, -1, c_dim)
    return torch.where(keep, zs, zt).reshape(z_trg.shape)
