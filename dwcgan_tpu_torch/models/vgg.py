"""VGG16 perceptual loss (the counterpart of `dwcgan_tpu/models/vgg.py`;
reference networks.py:639-688, solver.py:242-247).

VGG16's conv trunk to relu5_3, built by hand (no torchvision).  The loss is
the mean squared difference of the instance-normed relu5_3 features of the
two images, after `vgg_preprocess`; the instance norm is the port's (the
CUDA kernel on the card, at [16, 512, 16, 16] for a batch of 16 at 128 px:
the trunk pools three times).
The network is frozen: no parameter requires grad, so the pass on an input
that needs no gradient (the real batch) records no graph.

Weights: random from a seed (flax's default init of the JAX version,
truncated-normal `lecun_normal` kernels and zero biases — the
`vgg_random_fallback` of the recipe, since no weights can be fetched), or
the `.npz` that `cli/convert_vgg.py` writes (as `dwcgan_tpu/cli/convert_vgg.py`)
(`{name}_kernel` HWIO, `{name}_bias`).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dwcgan_tpu_torch.ops.blocks import channels_last, conv2d
from dwcgan_tpu_torch.ops.norms import instance_norm

# (name, out_channels, followed_by_pool)
LAYERS = (
    ("conv1_1", 64, False), ("conv1_2", 64, True),
    ("conv2_1", 128, False), ("conv2_2", 128, True),
    ("conv3_1", 256, False), ("conv3_2", 256, False), ("conv3_3", 256, True),
    ("conv4_1", 512, False), ("conv4_2", 512, False), ("conv4_3", 512, False),
    ("conv5_1", 512, False), ("conv5_2", 512, False), ("conv5_3", 512, False),
)
BGR_MEAN = (103.939, 116.779, 123.680)


class Vgg16Features(nn.Module):
    """VGG16 conv trunk; NCHW (channels_last) in, relu5_3 features out."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        c = 3
        for name, ch, _ in LAYERS:
            setattr(self, name, nn.Conv2d(c, ch, 3, padding=1))
            c = ch
        self.requires_grad_(False)

    def forward(self, x):
        x = channels_last(x.to(self.dtype))
        for name, _, pool in LAYERS:
            x = self.layer(name, x)
            if pool:
                x = F.max_pool2d(x, 2)
        return channels_last(x)

    def layer(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """One 3x3 conv layer and its ReLU, in x's dtype."""
        conv = getattr(self, name)
        return F.relu(conv2d(x, conv.weight, conv.bias, padding=1))


def vgg_preprocess(images: torch.Tensor) -> torch.Tensor:
    """[-1, 1] RGB NHWC -> BGR in [0, 255] minus the ImageNet means, NCHW
    fp32 (utils.py:207-217)."""
    bgr = images.float().flip(-1)
    bgr = (bgr + 1.0) * 255.0 * 0.5
    bgr = bgr - torch.tensor(BGR_MEAN, device=images.device)
    return bgr.permute(0, 3, 1, 2)


@torch.no_grad()
def init_random_vgg(vgg: Vgg16Features, seed: int) -> None:
    """flax's default Conv init: kernels lecun_normal (truncated normal,
    variance 1/fan_in), biases 0."""
    g = torch.Generator().manual_seed(seed)
    for name, _, _ in LAYERS:
        conv = getattr(vgg, name)
        fan_in = conv.weight[0].numel()
        # variance_scaling's truncated normal: stddev / .87962566 cut at 2 sd
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        nn.init.trunc_normal_(conv.weight, 0.0, std, -2 * std, 2 * std,
                              generator=g)
        conv.bias.zero_()


def load_vgg_npz(vgg: Vgg16Features, path: str) -> None:
    """Weights from the `.npz` of `cli/convert_vgg.py`."""
    data = np.load(path)
    sd = {}
    for name, _, _ in LAYERS:
        sd[f"{name}.weight"] = torch.from_numpy(
            np.ascontiguousarray(data[f"{name}_kernel"].transpose(3, 2, 0, 1)))
        sd[f"{name}.bias"] = torch.from_numpy(np.asarray(data[f"{name}_bias"]))
    vgg.load_state_dict(sd, strict=True)


def make_vgg_loss_fn(vgg: Vgg16Features, stats: str = "2pass",
                     arith: str = "fp32"):
    """(x, y) NHWC images -> mean squared difference of the instance-normed
    relu5_3 features (solver.py:242-247); the instance norm's variance form
    `stats` and normalise arithmetic `arith` (`norm_compute`, which the JAX
    loss's `instance_norm` follows too)."""

    def loss_fn(x, y):
        fx = instance_norm(vgg(vgg_preprocess(x)), stats=stats, arith=arith)
        fy = instance_norm(vgg(vgg_preprocess(y)), stats=stats, arith=arith)
        return (fx.float() - fy.float()).square().mean()

    return loss_fn
