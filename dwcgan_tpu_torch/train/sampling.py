"""Attention blending (the counterpart of `blend_attention`,
`dwcgan_tpu/train/sampling.py:44-57`)."""

from __future__ import annotations


def blend_attention(img, att, x_real):
    """Attention-masked edit: img*att + x_real*(1-att) (solver.py:158-170);
    the raw decode when the model has no attention head.  Returns fp32.
    (Serving always blends; the training step's warm-up gate, `att_on`,
    comes with the training slice.)"""
    if att is None:
        return img.float()
    att = att.float()
    return img.float() * att + x_real.float() * (1.0 - att)
