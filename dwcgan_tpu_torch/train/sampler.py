"""Inference and the monitoring grid (the counterparts of
`dwcgan_tpu/train/sampler.py:23-81`).

- `make_infer_fn`: text-guided translation (reference `Solver.forward`,
  solver.py:142-149);
- `make_sample_fn`: the grid's rows: real, reconstruction, text-guided,
  sampled style, and the attention map (reference `Solver.sample`,
  solver.py:249-289), the whole batch in one call.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from dwcgan_tpu_torch.config import Config
from dwcgan_tpu_torch.train.sampling import (blend_attention, sample_style,
                                             style_replace)


def _serving_mode(cfg: Config, gen) -> None:
    gen.set_norm_stats(cfg.norm_stats)
    gen.set_norm_compute(cfg.norm_compute)
    gen.eval()


def make_infer_fn(cfg: Config, gen):
    """Returns infer(x_real, txt, txt_len) -> edited images.

    x_real: [N, H, W, 3] in [-1, 1]; txt: [N, T] token ids; txt_len: [N];
    all on the generator's device.  Output: fp32 NHWC.  The norms form their
    variance as `cfg.norm_stats` says and normalise in the arithmetic of
    `cfg.norm_compute`; everything runs in eval mode under
    `torch.inference_mode()`.
    """
    _serving_mode(cfg, gen)

    def infer(x_real, txt, txt_len):
        with torch.inference_mode():
            content, mu, _ = gen.encode(x_real)
            n = mu.shape[0]
            style_real = mu.reshape(n, -1)
            mu_txt, _ = gen.encode_txt(style_real, txt, txt_len)
            img, att = gen.decode(content, mu_txt.reshape(n, -1))
            return blend_attention(img, att, x_real)

    return infer


def make_sample_fn(cfg: Config, gen):
    """Returns sample(x_real, txt, txt_len, att_on, eps=None, generator=None)
    -> the grid's rows, each [N, H, W, 3] fp32 in [-1, 1] on the generator's
    device: real, reconstruction, text-guided, sampled style, and (with an
    attention head) the text-guided attention map mapped to [-1, 1].

    The sampled style is drawn around the text's +-1 component ids (the
    sign of each attribute block's mean), keeping the source style where
    the command leaves an attribute unchanged.  Its standard-normal draws
    are `eps` ([N, K, c_dim]) when given, else from `generator` (the
    training loop seeds one from the step, as the JAX loop keys its draw
    with `PRNGKey(step)`).  `att_on` is the attention warm-up gate.  Runs
    `gen` (the EMA generator at the call site) in eval mode under
    `torch.inference_mode()`.
    """
    _serving_mode(cfg, gen)
    C = cfg.c_dim

    def sample(x_real, txt, txt_len, att_on: bool,
               eps: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> List[torch.Tensor]:
        with torch.inference_mode():
            n = x_real.shape[0]
            content, mu, _ = gen.encode(x_real)
            style_real = mu.reshape(n, -1)
            mu_txt, _ = gen.encode_txt(style_real, txt, txt_len)
            style_txt = mu_txt.reshape(n, -1)
            x_rec, att_rec = gen.decode(content, style_real)
            x_trg, att_trg = gen.decode(content, style_txt)
            sign = lambda m: torch.where(m.float().mean(dim=2) < 0.0, -1.0, 1.0)
            mus_real, mus_txt = sign(mu), sign(mu_txt)
            z = sample_style(mus_txt, C, cfg.stddev, eps, generator)
            z = style_replace(mus_real, mus_txt, style_real.float(), z, C)
            x_sam, att_sam = gen.decode(content, z)
            rows = [x_real.float(),
                    blend_attention(x_rec, att_rec, x_real, att_on),
                    blend_attention(x_trg, att_trg, x_real, att_on),
                    blend_attention(x_sam, att_sam, x_real, att_on)]
            if att_trg is not None:
                rows.append((att_trg.float().repeat(1, 1, 1, 3) - 0.5) / 0.5)
            return rows

    return sample
