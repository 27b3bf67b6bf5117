"""Text-guided translation (the counterpart of `make_infer_fn`,
`dwcgan_tpu/train/sampler.py:23-38`; reference `Solver.forward`,
solver.py:142-149)."""

from __future__ import annotations

import torch

from dwcgan_tpu_torch.config import Config
from dwcgan_tpu_torch.train.sampling import blend_attention


def make_infer_fn(cfg: Config, gen):
    """Returns infer(x_real, txt, txt_len) -> edited images.

    x_real: [N, H, W, 3] in [-1, 1]; txt: [N, T] token ids; txt_len: [N];
    all on the generator's device.  Output: fp32 NHWC.  The norms form their
    variance as `cfg.norm_stats` says; everything runs in eval mode under
    `torch.inference_mode()`.
    """
    if cfg.norm_compute != "fp32":
        raise NotImplementedError(
            f"norm_compute {cfg.norm_compute!r}: only 'fp32' is ported so far")
    gen.set_norm_stats(cfg.norm_stats)
    gen.eval()

    def infer(x_real, txt, txt_len):
        with torch.inference_mode():
            content, mu, _ = gen.encode(x_real)
            n = mu.shape[0]
            style_real = mu.reshape(n, -1)
            mu_txt, _ = gen.encode_txt(style_real, txt, txt_len)
            img, att = gen.decode(content, mu_txt.reshape(n, -1))
            return blend_attention(img, att, x_real)

    return infer
