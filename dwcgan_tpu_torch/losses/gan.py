"""Adversarial, classification, reconstruction, diversity and penalty
losses (the counterpart of `dwcgan_tpu/losses/gan.py:22-157`), with the
v1 leftovers `focal_loss`, `isometry_constraint` and
`mode_seeking_constraint`, which no training path calls.

Pure functions over discriminator outputs: per scale `(src, cls)` as
`MsImageDis` returns them.  Every reduction is fp32.  The penalties
differentiate the discriminator's scale-0 output with respect to the image
with `torch.autograd.grad(create_graph=True)`, so their gradient reaches
the discriminator's parameters.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import torch
import torch.nn.functional as F

DisOuts = List[Tuple[torch.Tensor, torch.Tensor]]  # per scale: (src, cls)
MULTI_LABEL = ("CelebA", "CUB200")


def _bce_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy with logits, stable form."""
    return F.binary_cross_entropy_with_logits(logits.float(), targets.float())


def focal_loss(inputs, targets, alpha: float = 1.0, gamma: float = 2.0,
               logits: bool = True, use_reduce: bool = True) -> torch.Tensor:
    """Focal loss (gan.py:31-48, reference networks.py:18-37): alpha * (1 -
    exp(-bce)) ** gamma * bce elementwise, bce from logits (stable form) or
    from probabilities (eps 1e-12 inside the logs); the mean when
    `use_reduce`."""
    x, t = inputs.float(), targets.float()
    if logits:
        bce = torch.clamp(x, min=0) - x * t + torch.log1p(torch.exp(-x.abs()))
    else:
        eps = 1e-12
        bce = -(t * torch.log(x + eps) + (1.0 - t) * torch.log(1.0 - x + eps))
    out = alpha * (1.0 - torch.exp(-bce)) ** gamma * bce
    return out.mean() if use_reduce else out


def adversarial_d_loss(src_fake, src_real, gan_type: str) -> torch.Tensor:
    """Per-scale D adversarial term (networks.py:129-140)."""
    f, r = src_fake.float(), src_real.float()
    if gan_type == "lsgan":
        return f.square().mean() + (r - 1.0).square().mean()
    if gan_type == "nsgan":
        return _bce_logits(f, torch.zeros_like(f)) + _bce_logits(r, torch.ones_like(r))
    if gan_type == "wgan":
        return f.mean() - r.mean()
    raise ValueError(f"unsupported gan_type {gan_type}")


def adversarial_g_loss(src_fake, gan_type: str) -> torch.Tensor:
    """Per-scale G adversarial term (networks.py:157-165)."""
    f = src_fake.float()
    if gan_type == "lsgan":
        return (f - 1.0).square().mean()
    if gan_type == "nsgan":
        return _bce_logits(f, torch.ones_like(f))
    if gan_type == "wgan":
        return -f.mean()
    raise ValueError(f"unsupported gan_type {gan_type}")


def classification_loss(logits, target, dataset: str = "CelebA") -> torch.Tensor:
    """BCE for the multi-label datasets (CelebA, CUB200), softmax CE over
    class indices otherwise (networks.py:78-85)."""
    if dataset in MULTI_LABEL:
        return _bce_logits(logits, target)
    return F.cross_entropy(logits.float(), target.long())


def dis_loss(outs_fake: DisOuts, outs_real: DisOuts, real_cls, gan_type: str,
             dataset: str, gan_w: float = 1.0, cls_w: float = 1.0):
    """D loss over scales: adversarial + attribute classification on the
    reals (calc_dis_loss, networks.py:116-146)."""
    loss = 0.0
    for (src_f, _), (src_r, cls_r) in zip(outs_fake, outs_real):
        loss = loss + adversarial_d_loss(src_f, src_r, gan_type) * gan_w
        loss = loss + classification_loss(cls_r, real_cls, dataset) * cls_w
    return loss


def gen_adv_loss(outs_fake: DisOuts, target_cls, gan_type: str, dataset: str,
                 gan_w: float = 1.0, cls_w: float = 1.0):
    """G adversarial loss over scales: fool D and be classified as the
    target attributes (calc_gen_loss, networks.py:148-170)."""
    loss = 0.0
    for src_f, cls_f in outs_fake:
        loss = loss + adversarial_g_loss(src_f, gan_type) * gan_w
        loss = loss + classification_loss(cls_f, target_cls, dataset) * cls_w
    return loss


def recon_l1(x, y) -> torch.Tensor:
    """Mean absolute error (solver.py:113-114)."""
    return (x.float() - y.float()).abs().mean()


def diversity_loss(x1, x2) -> torch.Tensor:
    """Mode-seeking term |x1 - detach(x2)| (solver.py:181); the step
    subtracts it with a decaying weight."""
    return (x1.float() - x2.detach().float()).abs().mean()


def _input_grad(dis_apply: Callable, x) -> torch.Tensor:
    x = x.detach().requires_grad_(True)
    out = dis_apply(x).float().sum()
    (grad,) = torch.autograd.grad(out, x, create_graph=True)
    return grad.reshape(grad.shape[0], -1).float()


def r1_penalty(dis_apply: Callable, x_real) -> torch.Tensor:
    """R1-style penalty on reals (solver.py:305-315): the mean of the
    squared per-sample squared gradient norm, as the reference has it."""
    g2 = _input_grad(dis_apply, x_real).square().sum(dim=1)
    return g2.square().mean()


def gradient_penalty(dis_apply: Callable, x_hat) -> torch.Tensor:
    """WGAN-GP on interpolates: (||d out / d x|| - 1)^2 (solver.py:291-303)."""
    norm = torch.sqrt(_input_grad(dis_apply, x_hat).square().sum(dim=1) + 1e-12)
    return (norm - 1.0).square().mean()


def isometry_constraint(z1, z2, rec_z1, rec_z2) -> torch.Tensor:
    """|d(z1, z2) - d(rec_z1, rec_z2)|, d the batch mean of the per-sample
    L1 distance (gan.py:122-129, solver.py:116-121)."""
    def dist(a, b):
        return (a.float() - b.float()).abs().sum(dim=1).mean()
    return (dist(z1, z2) - dist(rec_z1, rec_z2)).abs()


def mode_seeking_constraint(im1, im2, z1, z2, eps: float = 1e-5) -> torch.Tensor:
    """1 / (mean|im1 - im2| / mean|z1 - z2| + eps) (gan.py:131-136,
    solver.py:123-125)."""
    ratio = (im1 - im2).abs().mean() / (z1 - z2).abs().mean()
    return 1.0 / (ratio + eps)
