"""Multi-scale PatchGAN discriminator with an attribute classifier (the
counterpart of `dwcgan_tpu/models/discriminator.py:26-81`; reference
`MsImageDis`, networks.py:43-114).

`num_scales` independent towers of `n_layer` 4x4 stride-2 Conv2dBlocks
(width doubling up to 512); each ends in a 1x1 real/fake head and a
full-receptive-field attribute head without bias.  The input is halved
(2x2 mean) between scales in its own dtype and cast to the compute dtype
per tower, as the JAX module does.  Images come in NHWC, like the JAX module; the
outputs are per scale `(src [N, h, w, 1] NHWC, cls [N, num_cls])`.
Parameter names are the reference's (`cnns_feat.{s}.{j}.conv`,
`cnns_src.{s}`, `cnns_cls.{s}`), so `dwcgan_tpu/interop/torch_import.py`
reads a port `state_dict()` directly (norms none, in and ln, and no PReLU:
the JAX importer takes no other leaf).  Every norm the config accepts
builds (none, in, ln, bn, sn; the first block of a tower has none), and
every activation, PReLU included.  With `sn` the spectral norm is
recomputed on every call, as in JAX.
"""

from __future__ import annotations

import torch
from torch import nn

from dwcgan_tpu_torch.config import Config, DisConfig
from dwcgan_tpu_torch.device import resolve_device
from dwcgan_tpu_torch.ops.blocks import (CONV_NORMS, Conv2dBlock, channels_last,
                                         conv2d, fixed_init_params, set_norm_modes,
                                         weights_init)
from dwcgan_tpu_torch.ops.resize import downsample2x


class MsImageDis(nn.Module):

    def __init__(self, cfg: DisConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.norm not in CONV_NORMS:
            raise ValueError(f"Unsupported normalization: {cfg.norm}")
        self.cfg, self.dtype = cfg, dtype
        feats, srcs, clss = [], [], []
        for s in range(cfg.num_scales):
            d = cfg.dim
            tower = [Conv2dBlock(3, d, 4, 2, 1, "none", cfg.activ, cfg.pad_type)]
            for _ in range(cfg.n_layer - 1):
                nd = min(d * 2, 512)
                tower.append(Conv2dBlock(d, nd, 4, 2, 1, cfg.norm, cfg.activ,
                                         cfg.pad_type))
                d = nd
            feats.append(nn.ModuleList(tower))
            srcs.append(nn.Conv2d(d, 1, 1))
            k = (cfg.image_size // 2 ** s) // 2 ** cfg.n_layer
            clss.append(nn.Conv2d(d, cfg.num_cls, k, bias=False))
        self.cnns_feat = nn.ModuleList(feats)
        self.cnns_src = nn.ModuleList(srcs)
        self.cnns_cls = nn.ModuleList(clss)

    def set_norm_stats(self, stats: str) -> None:
        set_norm_modes(self, stats=stats)

    def set_norm_compute(self, arith: str) -> None:
        """The `in` blocks' normalise arithmetic ("fp32" or "bf16")."""
        set_norm_modes(self, arith=arith)

    def forward(self, images, multiscale: bool = True):
        """images: [N, H, W, 3] -> per scale (src [N, h, w, 1], cls [N, K])."""
        x = channels_last(images.permute(0, 3, 1, 2))
        n = self.cfg.num_scales if multiscale else 1
        outs = []
        for s in range(n):
            h = x.to(self.dtype)
            for blk in self.cnns_feat[s]:
                h = blk(h)
            src, cls = self.cnns_src[s], self.cnns_cls[s]
            o_src = conv2d(h, src.weight, src.bias)
            o_cls = conv2d(h, cls.weight)
            outs.append((o_src.permute(0, 2, 3, 1),
                         o_cls.reshape(o_cls.shape[0], -1)))
            if s + 1 < n:
                x = downsample2x(x)
        return outs


@torch.no_grad()
def init_dis_weights(dis: MsImageDis, seed: int) -> None:
    """Random weights from `seed`: every kernel gaussian(0, 0.02) (the
    reference re-inits D so, solver.py:74; spectral-norm kernels too),
    zero biases, LayerNorm gamma U(0, 1) and beta 0, batch-norm gamma 1
    and beta 0, PReLU slopes 0.25."""
    g = torch.Generator().manual_seed(seed)
    fixed = fixed_init_params(dis)
    for name, p in dis.named_parameters():
        if name in fixed:
            p.fill_(fixed[name])
        elif name.endswith(".gamma"):
            torch.nn.init.uniform_(p, 0.0, 1.0, generator=g)
        elif name.endswith("weight"):
            weights_init(p, "gaussian", g)
        else:
            p.zero_()


def build_discriminator(cfg: Config, device="cuda", seed: int = 0
                        ) -> MsImageDis:
    """The discriminator of `cfg` with gaussian(0.02) weights from `seed`,
    on `device` (the card unless the caller asks for the CPU), compute
    dtype `cfg.compute_dtype`, variance form `cfg.norm_stats`, normalise
    arithmetic `cfg.norm_compute`."""
    dev = resolve_device(device)
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    dis = MsImageDis(cfg.dis, dtype)
    dis.set_norm_stats(cfg.norm_stats)
    dis.set_norm_compute(cfg.norm_compute)
    init_dis_weights(dis, seed)
    return dis.to(dev)
