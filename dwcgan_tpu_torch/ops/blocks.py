"""Building blocks of the port (NCHW, channels_last memory, fp32 params).

The counterparts of `dwcgan_tpu/ops/blocks.py`.  Parameters stay fp32 and
are cast to the activation dtype where they are used, as the JAX package
casts to its compute dtype.  Module attribute names follow the reference
torch model (`conv`, `norm.gamma`, `fc`, `model.{i}`), so a port
`state_dict()` has the reference's names.

Every norm (none, in, ln, adain, bn, sn) and every activation of the
config schema, forward and backward.  in, ln and adain are
`torch.autograd.Function`s over the norm kernels (`ops/norms.py`); batch
norm, spectral norm and PReLU are plain PyTorch, as JAX computes them
outside Pallas.  With PReLU the norm kernels run without their fused ReLU
and the PReLU follows.  `weights_init` draws the reference's initial
weights for the generator and the discriminator alike; `dropout` draws its
mask from a given `torch.Generator`.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from dwcgan_tpu_torch.ops.norms import (EPS, adain, adain_residual,
                                        batch_norm_stats_free, check_arith,
                                        check_stats, instance_norm,
                                        layer_norm_ref)
from dwcgan_tpu_torch.ops.prng import jax_normal_key0
from dwcgan_tpu_torch.parallel.mesh import draw
from dwcgan_tpu_torch.parallel.tensor import (copy, gather, module_group,
                                              module_shard, reduce, split)
from dwcgan_tpu_torch.ops.stem import (stem_applicable, stem_conv7,
                                       stem_fits_vmem)

# LeakyReLU slopes differ between conv and linear blocks in the reference
# (networks.py:559 vs :614).
CONV_LRELU_SLOPE = 0.1
LINEAR_LRELU_SLOPE = 0.2

CONV_NORMS = ("none", "in", "ln", "adain", "bn", "sn")
PRELU_INIT = 0.25
SN_ITERS = 30


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


class PReLU(nn.Module):
    """Parametric ReLU with one learnable slope (torch's default
    `nn.PReLU()`: `weight` of shape [1], 0.25 at first), fp32, computed as
    `dwcgan_tpu/ops/blocks.py:50-58` does: where(x >= 0, x, a * x) with the
    slope cast to x's dtype.  (`F.prelu` takes the slope branch at x == 0
    and reduces its weight gradient in another order.)"""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), PRELU_INIT))

    def forward(self, x):
        return torch.where(x >= 0, x, self.weight.to(x.dtype) * x)


class _Stateless(nn.Module):

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


def make_activation(name: str, *, linear_block: bool = False) -> nn.Module:
    """A block's activation as a module: `PReLU` for "prelu" (its slope is
    then `activation.weight`, the reference's name), else the function
    `activation` gives."""
    if name == "prelu":
        return PReLU()
    return _Stateless(activation(name, linear_block=linear_block))


def activation(name: str, *, linear_block: bool = False) -> Callable:
    """A stateless activation by name; "prelu" has a parameter and raises
    here, as in JAX (a block makes it with `make_activation`)."""
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
        raise ValueError(f"unsupported activation: {name}")
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


def fixed_init_params(module: nn.Module) -> dict:
    """{name: value} of the parameters whose JAX init is a constant: PReLU
    slopes 0.25, batch-norm gamma 1 and beta 0."""
    fixed = {}
    for prefix, m in module.named_modules():
        if isinstance(m, PReLU):
            fixed[f"{prefix}.weight"] = PRELU_INIT
        elif isinstance(m, BatchNormAffine):
            fixed[f"{prefix}.weight"], fixed[f"{prefix}.bias"] = 1.0, 0.0
    return fixed


def dropout(x: torch.Tensor, p: float, training: bool,
            rng: Optional[torch.Generator] = None, rows=None,
            length: Optional[int] = None) -> torch.Tensor:
    """Inverted dropout whose keep mask is drawn from `rng` (a generator on
    x's device; torch's default generator when None).  `rows`
    (`parallel.mesh.Rows`): the mask is this rank's rows of the draw at the
    global batch.  `length`: x [N, T, D] is the first T steps of a sequence
    of `length`, and the mask is drawn at that length and cut, so that it
    does not depend on how long the batch's longest sequence is."""
    if not training or p == 0.0:
        return x
    shape = tuple(x.shape) if length is None else (x.shape[0], length) + tuple(x.shape[2:])
    u = draw(torch.rand, shape, rng, x.device, rows)
    if length is not None:
        u = u[:, :x.shape[1]]
    keep = u >= p
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


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None, **kw) -> torch.Tensor:
    """`F.conv2d` in x's dtype, the bias added as flax's `conv(x) + b`:
    below fp32 the convolution rounds to x's dtype and its sum with the
    bias, cast to that dtype, rounds again (flax `nn.Conv(dtype=...)`,
    dwcgan_tpu/ops/blocks.py:216, and the decoder's heads,
    dwcgan_tpu/models/generator.py:295-300).  fp32 keeps the bias in the
    convolution, where the two forms differ only by fp32 rounding."""
    w = weight.to(x.dtype)
    if bias is None or x.dtype in (torch.float32, torch.float64):
        return F.conv2d(x, w, None if bias is None else bias.to(x.dtype), **kw)
    return F.conv2d(x, w, **kw) + bias.to(x.dtype)[:, None, None]


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`F.linear` in x's dtype, the bias added as flax's `Dense` adds it:
    below fp32 the product rounds to x's dtype and its sum with the bias,
    cast to that dtype, rounds again (flax `nn.Dense(dtype=...)`,
    dwcgan_tpu/ops/blocks.py:271-272, dwcgan_tpu/models/generator.py:125-136).
    fp32 keeps the bias in the product, as `conv2d` does."""
    w = weight.to(x.dtype)
    if bias is None or x.dtype in (torch.float32, torch.float64):
        return F.linear(x, w, None if bias is None else bias.to(x.dtype))
    return F.linear(x, w) + bias.to(x.dtype)


_SN_START: dict = {}


def _sn_start(n: int, device: torch.device) -> torch.Tensor:
    """JAX's start vector `normal(PRNGKey(0), (n,))`, normalised as the
    JAX power iteration does, on `device` (kept per size and device)."""
    key = (n, str(device))
    if key not in _SN_START:
        u = torch.from_numpy(jax_normal_key0(n).copy()).to(device)
        _SN_START[key] = u / (torch.linalg.vector_norm(u) + 1e-12)
    return _SN_START[key]


def spectral_sigma(w_mat: torch.Tensor, n_iter: int = SN_ITERS) -> torch.Tensor:
    """The largest singular value of `w_mat` ([fan_in, out], one column
    per output channel) as `_spectral_normalize` estimates it
    (dwcgan_tpu/ops/blocks.py:86-113): `n_iter` power iterations in fp32
    from JAX's fixed start vector, each normalisation adding 1e-12 to the
    norm, u and v without gradient, then sigma = v . (W u) with gradient
    in W.  The order of the fan-in rows changes only the summation order."""
    w_mat = w_mat.float()
    with torch.no_grad():
        w = w_mat.detach()
        u = _sn_start(w.shape[1], w.device)
        for _ in range(n_iter):
            v = w @ u
            v = v / (torch.linalg.vector_norm(v) + 1e-12)
            u = w.T @ v
            u = u / (torch.linalg.vector_norm(u) + 1e-12)
    return v @ (w_mat @ u)


def spectral_normalize(w_mat: torch.Tensor, n_iter: int = SN_ITERS) -> torch.Tensor:
    """w_mat / sigma (`spectral_sigma`), fp32."""
    return w_mat.float() / spectral_sigma(w_mat, n_iter)


def sn_conv_weight(weight: torch.Tensor) -> torch.Tensor:
    """An OIHW conv kernel over its spectral norm, the matrix taken in
    JAX's HWIO order ([kh * kw * in, out])."""
    out = weight.shape[0]
    return weight / spectral_sigma(weight.permute(2, 3, 1, 0).reshape(-1, out))


class LayerNormRef(nn.Module):
    """Per-channel affine of the reference LayerNorm (`gamma`, `beta`)."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(dim).uniform_())
        self.beta = nn.Parameter(torch.zeros(dim))


class BatchNormAffine(nn.Module):
    """Per-channel affine of the stats-free batch norm, named as torch's
    `BatchNorm` (`weight` 1, `bias` 0; no running buffers: both packages
    normalise with the batch's own statistics)."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))


def set_norm_modes(module: nn.Module, stats: Optional[str] = None,
                   arith: Optional[str] = None) -> None:
    """How every `Conv2dBlock` under `module` forms its variance (`stats`,
    "2pass" or "1pass") and in which dtype its in / adain norm normalises
    (`arith`, "fp32" or "bf16": `cfg.norm_compute`); None leaves one as it
    is."""
    if stats is not None:
        check_stats(stats)
    if arith is not None:
        check_arith(arith)
    for m in module.modules():
        if isinstance(m, Conv2dBlock):
            m.stats = m.stats if stats is None else stats
            m.arith = m.arith if arith is None else arith


def _check_norm(norm: str, known) -> None:
    if norm not in known:
        raise ValueError(f"Unsupported normalization: {norm}")


class Conv2dBlock(nn.Module):
    """pad -> conv -> norm -> activation (networks.py:524-585).

    A ReLU after in/adain is fused into the norm kernel; any other
    activation follows the norm, which then runs without one.  `bn` is the
    stats-free batch norm after the raw conv; `sn` convolves with the
    kernel over its spectral norm (`sn_conv_weight`, recomputed on every
    call as in JAX), `conv.weight` and `conv.bias` holding the raw kernel
    and bias as JAX's `sn_kernel` and `sn_bias` do.  With `stem` set, a
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
        _check_norm(norm, CONV_NORMS)
        self.padding, self.pad_type, self.stride = padding, pad_type, stride
        self.norm_type, self.activ = norm, activ
        self.stem = stem and stem_applicable(kernel_size, stride, padding,
                                             in_dim, norm, activ)
        # how the norm forms its variance and in which dtype it normalises
        # (in and adain); `Generator.set_norm_stats` and `set_norm_compute`
        # set them
        self.stats = "2pass"
        self.arith = "fp32"
        self.conv = nn.Conv2d(in_dim, out_dim, kernel_size, stride, bias=True)
        if norm == "ln":
            self.norm = LayerNormRef(out_dim)
        elif norm == "bn":
            self.norm = BatchNormAffine(out_dim)
        self.activation = make_activation(activ)

    def conv_raw(self, x: torch.Tensor) -> torch.Tensor:
        """pad + conv in the activation dtype, channels_last out.  Under a
        model axis (`conv.weight` this rank's output channels) the
        channels are gathered, then the bias is added as `conv2d` adds it
        below fp32."""
        x = channels_last(pad2d(x, self.padding, self.pad_type))
        w = self.conv.weight
        if self.norm_type == "sn":
            w = sn_conv_weight(w)
        mg = module_group(self.conv)
        if mg is None:
            y = conv2d(x, w, self.conv.bias, stride=self.stride)
        else:
            y = gather(conv2d(copy(x, mg), w, stride=self.stride), 1, mg)
            y = y + self.conv.bias.to(y.dtype)[:, None, None]
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
            y = instance_norm(y, relu=fuse_relu, stats=self.stats,
                              arith=self.arith)
        elif self.norm_type == "adain":
            if adain_scale is None or adain_bias is None:
                raise ValueError("adain norm requires style-derived scale/bias")
            y = adain(y, adain_scale, adain_bias, relu=fuse_relu,
                      stats=self.stats, arith=self.arith)
        else:
            fuse_relu = False
            if self.norm_type == "ln":
                y = layer_norm_ref(y, self.norm.gamma, self.norm.beta,
                                   stats=self.stats)
            elif self.norm_type == "bn":
                y = batch_norm_stats_free(y, self.norm.weight, self.norm.bias)
        return y if fuse_relu else self.activation(y)


class LinearBlock(nn.Module):
    """fc -> norm -> activation (networks.py:587-634, the JAX block at
    dwcgan_tpu/ops/blocks.py:253-301).

    `ln` normalises each row over its features with the unbiased std and
    eps added to the std (`norm.gamma` U(0, 1), `norm.beta` 0); `bn` each
    feature over the batch, biased variance, eps inside the root
    (`norm.weight` 1, `norm.bias` 0); `sn` is x @ (w / sigma) + b, `fc`
    holding the raw weight.  Statistics fp32, the result in x's dtype."""

    NORMS = ("none", "ln", "bn", "sn", "in")

    def __init__(self, in_dim: int, out_dim: int, norm: str = "none",
                 activ: str = "relu"):
        super().__init__()
        _check_norm(norm, self.NORMS)
        if norm == "in":
            raise NotImplementedError(
                "LinearBlock norm='in' (InstanceNorm1d on 2-D input) is "
                "ill-defined in the reference; use bn/ln/none")
        self.norm_type = norm
        self.fc = nn.Linear(in_dim, out_dim)
        if norm == "ln":
            self.norm = LayerNormRef(out_dim)
        elif norm == "bn":
            self.norm = BatchNormAffine(out_dim)
        self.activation = make_activation(activ, linear_block=True)

    @property
    def emits_slice(self) -> bool:
        """Column-parallel (`fc.weight` this rank's output features) with
        no norm and a stateless activation: the output stays this rank's
        slice of the features."""
        s = module_shard(self.fc)
        return s is not None and s.dim == 0 and self.norm_type == "none" \
            and not isinstance(self.activation, PReLU)

    def forward(self, x, part: bool = False):
        """`part`: x is this rank's slice of the features (the output of a
        column-parallel block that `emits_slice`).

        Under a model axis, column-parallel (the output dim sharded): the
        product of x with this rank's rows and its slice of the bias, then
        gathered unless the block `emits_slice`; row-parallel (the input
        dim sharded): the product of this rank's slice of x, all-reduced,
        then the bias.  A norm mixes the features, and a PReLU's slope
        would take a partial gradient: both run on gathered features."""
        w = self.fc.weight
        if self.norm_type == "sn":
            w = spectral_normalize(w.T).T
        s = module_shard(self.fc)
        if s is None:
            y = linear(x, w, self.fc.bias)
        elif s.dim == 0:
            y = linear(copy(x, s.mg), w, split(self.fc.bias, 0, s.mg))
            if not self.emits_slice:
                y = gather(y, -1, s.mg)
        else:
            y = reduce(linear(x if part else split(x, -1, s.mg), w), s.mg)
            y = y + self.fc.bias.to(y.dtype)
        if self.norm_type in ("ln", "bn"):
            y32 = y.float()
            if self.norm_type == "ln":
                mean = y32.mean(dim=-1, keepdim=True)
                n = y32.shape[-1]
                var = (y32 - mean).square().sum(-1, keepdim=True) / max(n - 1, 1)
                y32 = (y32 - mean) / (torch.sqrt(var) + EPS)
                gamma, beta = self.norm.gamma, self.norm.beta
            else:
                mean = y32.mean(dim=0, keepdim=True)
                var = (y32 - mean).square().mean(dim=0, keepdim=True)
                y32 = (y32 - mean) / torch.sqrt(var + EPS)
                gamma, beta = self.norm.weight, self.norm.bias
            y = (y32 * gamma + beta).to(y.dtype)
        return self.activation(y)


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
                               style_params[:, b, 1, 0], stats=second.stats,
                               arith=second.arith)
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
        """Under a model axis a column-parallel block hands its slice of
        the features to the row-parallel block after it (the rules shard
        the two together: JAX's one all-reduce at the AdaIN head,
        dwcgan_tpu/parallel/mesh.py:37-39)."""
        x = x.reshape(x.shape[0], -1)
        part = False
        for blk in self.model:
            x = blk(x, part)
            part = blk.emits_slice
        return x
