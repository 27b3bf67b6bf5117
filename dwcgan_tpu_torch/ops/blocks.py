"""Building blocks of the port (NCHW, channels_last memory, fp32 params).

The counterparts of `dwcgan_tpu/ops/blocks.py`.  Parameters stay fp32 and
are cast to the activation dtype where they are used, as the JAX package
casts to its compute dtype.  Module attribute names follow the reference
torch model (`conv`, `norm.gamma`, `fc`, `model.{i}`), so a port
`state_dict()` has the reference's names.

Norms none, in, ln and adain, and every activation but prelu, forward and
backward (the norms are `torch.autograd.Function`s, `ops/norms.py`).
Spectral norm, bn and PReLU come with a later slice and raise here.
`weights_init` draws the reference's initial weights for the generator and
the discriminator alike; `dropout` draws its mask from a given
`torch.Generator`.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from dwcgan_tpu_torch.ops.norms import (adain, adain_residual, instance_norm,
                                        layer_norm_ref)
from dwcgan_tpu_torch.ops.stem import (stem_applicable, stem_conv7,
                                       stem_fits_vmem)

# LeakyReLU slopes differ between conv and linear blocks in the reference
# (networks.py:559 vs :614).
CONV_LRELU_SLOPE = 0.1
LINEAR_LRELU_SLOPE = 0.2

CONV_NORMS = ("none", "in", "ln", "adain")


class _Sigmoid(torch.autograd.Function):
    """`jax.nn.sigmoid` as XLA computes it: 1 / (1 + exp(-x)), each op
    rounded to x's dtype, and its gradient by JAX's rule g * (s * (1 - s))
    (`lax.logistic`), each op rounded too.  (`torch.sigmoid` rounds once, and
    autograd through the expansion takes another path than JAX's rule.)"""

    @staticmethod
    def forward(ctx, x):
        s = _logistic(x)
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        s, = ctx.saved_tensors
        return g * (s * (1 - s))


def _logistic(x: torch.Tensor) -> torch.Tensor:
    return torch.reciprocal(1 + torch.exp(-x))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    # without a gradient to take, the same forward without the Function's
    # host cost (the text encoder's loop calls it per step)
    if x.requires_grad and torch.is_grad_enabled():
        return _Sigmoid.apply(x)
    return _logistic(x)


def leaky_relu(x: torch.Tensor, slope: float) -> torch.Tensor:
    """`jax.nn.leaky_relu`: where(x >= 0, x, slope * x), the slope a scalar
    that takes x's dtype first (0.1 is 0.10009765625 in bf16), as JAX's
    weak-typed scalar does.  (`F.leaky_relu` multiplies by the fp32 slope.)"""
    return torch.where(x >= 0, x, x * torch.tensor(slope, dtype=x.dtype).item())


def activation(name: str, *, linear_block: bool = False) -> Callable:
    slope = LINEAR_LRELU_SLOPE if linear_block else CONV_LRELU_SLOPE
    table = {
        "relu": F.relu,
        "lrelu": lambda x: leaky_relu(x, slope),
        "selu": F.selu,
        "tanh": torch.tanh,
        "sigmoid": sigmoid,
        "none": lambda x: x,
    }
    if name not in table:
        raise NotImplementedError(f"activation {name!r} is not in this slice "
                                  f"of the port ({sorted(table)})")
    return table[name]


def weights_init(w: torch.Tensor, init_type: str, g: torch.Generator) -> None:
    """Draw a conv or linear weight in place as the reference's
    `weights_init` does (utils.py:234-254): gaussian(0, 0.02), xavier (gain
    sqrt 2), kaiming (fan_in), orthogonal (gain sqrt 2) or the default
    (fan_in, unit gain)."""
    fan_in = w[0].numel()
    if init_type == "gaussian":
        nn.init.normal_(w, 0.0, 0.02, generator=g)
    elif init_type == "xavier":
        nn.init.xavier_normal_(w, gain=math.sqrt(2.0), generator=g)
    elif init_type == "kaiming":
        nn.init.normal_(w, 0.0, math.sqrt(2.0 / fan_in), generator=g)
    elif init_type == "orthogonal":
        nn.init.orthogonal_(w, gain=math.sqrt(2.0), generator=g)
    elif init_type == "default":
        nn.init.normal_(w, 0.0, math.sqrt(1.0 / fan_in), generator=g)
    else:
        raise ValueError(f"unsupported init: {init_type}")


def dropout(x: torch.Tensor, p: float, training: bool,
            rng: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout whose keep mask is drawn from `rng` (a generator on
    x's device; torch's default generator when None)."""
    if not training or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=rng, device=x.device) >= p
    return x * keep.to(x.dtype) / (1.0 - p)


def pad2d(x: torch.Tensor, padding: int, pad_type: str) -> torch.Tensor:
    """Spatial padding of an NCHW tensor (reflect / replicate / zero)."""
    if padding == 0:
        return x
    mode = {"reflect": "reflect", "replicate": "replicate",
            "zero": "constant"}[pad_type]
    return F.pad(x, (padding,) * 4, mode=mode)


def channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous(memory_format=torch.channels_last)


class LayerNormRef(nn.Module):
    """Per-channel affine of the reference LayerNorm (`gamma`, `beta`)."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(dim).uniform_())
        self.beta = nn.Parameter(torch.zeros(dim))


class Conv2dBlock(nn.Module):
    """pad -> conv -> norm -> activation (networks.py:524-585).

    A ReLU after in/adain is fused into the norm kernel.  With `stem` set, a
    block that `stem_applicable` accepts (a 7x7 stride-1 pad-3 conv from 3
    channels, norm in or none, activation relu or none) runs as one fused
    `stem_conv7` call on every image for which `stem_fits_vmem` holds, as
    the JAX block does with `stem_pallas` (dwcgan_tpu/ops/blocks.py:155-168),
    with the same parameters.  Its statistics are 1pass whatever `stats`
    says: the JAX stem has no other mode.  On other images (smaller than 8
    px, or larger than 128 px at 64 channels) the block runs its normal
    conv, norm and activation, as the JAX block runs its jnp path there:
    that path normalises the conv output rounded to the compute dtype, the
    stem the fp32 one."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, norm: str = "none",
                 activ: str = "relu", pad_type: str = "zero",
                 stem: bool = False):
        super().__init__()
        if norm not in CONV_NORMS:
            raise NotImplementedError(f"norm {norm!r} is not in this slice of "
                                      f"the port ({CONV_NORMS})")
        self.padding, self.pad_type, self.stride = padding, pad_type, stride
        self.norm_type, self.activ = norm, activ
        self.stem = stem and stem_applicable(kernel_size, stride, padding,
                                             in_dim, norm, activ)
        # how the norm forms its variance; `Generator.set_norm_stats` sets it
        self.stats = "2pass"
        self.act = activation(activ)
        self.conv = nn.Conv2d(in_dim, out_dim, kernel_size, stride, bias=True)
        if norm == "ln":
            self.norm = LayerNormRef(out_dim)

    def conv_raw(self, x: torch.Tensor) -> torch.Tensor:
        """pad + conv in the activation dtype, channels_last out."""
        x = channels_last(pad2d(x, self.padding, self.pad_type))
        y = F.conv2d(x, self.conv.weight.to(x.dtype),
                     self.conv.bias.to(x.dtype), stride=self.stride)
        return channels_last(y)

    def forward(self, x, adain_scale=None, adain_bias=None):
        if self.stem and stem_fits_vmem(x.shape[2], x.shape[3],
                                        self.conv.out_channels):
            y = stem_conv7(x.permute(0, 2, 3, 1), self.conv.weight,
                           self.conv.bias, self.norm_type, self.activ,
                           self.pad_type, "1pass")
            return y.permute(0, 3, 1, 2)
        y = self.conv_raw(x)
        fuse_relu = self.activ == "relu"
        if self.norm_type == "in":
            y = instance_norm(y, relu=fuse_relu, stats=self.stats)
        elif self.norm_type == "adain":
            if adain_scale is None or adain_bias is None:
                raise ValueError("adain norm requires style-derived scale/bias")
            y = adain(y, adain_scale, adain_bias, relu=fuse_relu,
                      stats=self.stats)
        else:
            fuse_relu = False
            if self.norm_type == "ln":
                y = layer_norm_ref(y, self.norm.gamma, self.norm.beta,
                                   stats=self.stats)
        return y if fuse_relu else self.act(y)


class LinearBlock(nn.Module):
    """fc -> activation (networks.py:587-634); norm none only in this slice."""

    def __init__(self, in_dim: int, out_dim: int, norm: str = "none",
                 activ: str = "relu"):
        super().__init__()
        if norm != "none":
            raise NotImplementedError(f"LinearBlock norm {norm!r} is not in "
                                      "this slice of the port")
        self.fc = nn.Linear(in_dim, out_dim)
        self.act = activation(activ, linear_block=True)

    def forward(self, x):
        return self.act(F.linear(x, self.fc.weight.to(x.dtype),
                                 self.fc.bias.to(x.dtype)))


class ResBlock(nn.Module):
    """conv3x3(norm, act) -> conv3x3(norm, none) + skip (networks.py:509-522)."""

    def __init__(self, dim: int, norm: str = "in", activ: str = "relu",
                 pad_type: str = "zero"):
        super().__init__()
        self.model = nn.ModuleList([
            Conv2dBlock(dim, dim, 3, 1, 1, norm, activ, pad_type),
            Conv2dBlock(dim, dim, 3, 1, 1, norm, "none", pad_type)])

    def forward(self, x):
        return x + self.model[1](self.model[0](x))


class ResBlocks(nn.Module):
    """Stack of ResBlock (networks.py:480-489)."""

    def __init__(self, num_blocks: int, dim: int, norm: str = "in",
                 activ: str = "relu", pad_type: str = "zero"):
        super().__init__()
        self.model = nn.ModuleList([ResBlock(dim, norm, activ, pad_type)
                                    for _ in range(num_blocks)])

    def forward(self, x):
        for blk in self.model:
            x = blk(x)
        return x


class AdaINResBlocks(nn.Module):
    """AdaIN residual stack with the style parameters passed in.

    `style_params` is [N, num_blocks, 2, 2, dim]: per block, per conv,
    (0 = bias, 1 = scale) (blocks.py:377-378, 384-385).  The first conv's
    AdaIN (+ ReLU) and the second conv's `x + AdaIN(y)` are one norm call
    each."""

    def __init__(self, num_blocks: int, dim: int, activ: str = "relu",
                 pad_type: str = "zero"):
        super().__init__()
        self.num_blocks, self.dim = num_blocks, dim
        self.model = nn.ModuleList([ResBlock(dim, "adain", activ, pad_type)
                                    for _ in range(num_blocks)])

    def forward(self, x, style_params):
        if tuple(style_params.shape[1:]) != (self.num_blocks, 2, 2, self.dim):
            raise ValueError(f"bad style_params shape {tuple(style_params.shape)}")
        for b, blk in enumerate(self.model):
            first, second = blk.model
            y = first(x, adain_scale=style_params[:, b, 0, 1],
                      adain_bias=style_params[:, b, 0, 0])
            y = second.conv_raw(y)
            x = adain_residual(x, y, style_params[:, b, 1, 1],
                               style_params[:, b, 1, 0], stats=second.stats)
        return x


class MLP(nn.Module):
    """LinearBlock stack; the last has no norm/activation (networks.py:491-503)."""

    def __init__(self, in_dim: int, out_dim: int, dim: int, n_blk: int,
                 norm: str = "none", activ: str = "relu"):
        super().__init__()
        blocks = [LinearBlock(in_dim, dim, norm, activ)]
        blocks += [LinearBlock(dim, dim, norm, activ) for _ in range(n_blk - 2)]
        blocks.append(LinearBlock(dim, out_dim, "none", "none"))
        self.model = nn.ModuleList(blocks)

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        for blk in self.model:
            x = blk(x)
        return x
