"""InceptionV3 for FID/IS, by hand in torch (the counterpart of
`dwcgan_tpu/eval/inception.py`).

The trunk returns the 2048-d pool3 features (FID) and the 1000-way logits
(IS) of [-1, 1] RGB images at 299 px, NCHW.  Module and tensor names are
torchvision's (`Conv2d_1a_3x3.conv.weight`, `Mixed_5b.branch1x1.bn.
running_mean`, `fc.weight`), so a torchvision `state_dict` maps name for
name; torchvision itself is not needed.  As in the JAX model:

- `BasicConv2d` is a conv without bias, the frozen BatchNorm written out
  as (x - mean) / sqrt(var + 1e-3) * gamma + beta (not folded into the
  conv), then ReLU;
- the max pools take no padding (3x3, stride 2), the branch pools' 3x3
  average counts the padded zeros;
- branches concatenate on the channels in the JAX order, InceptionE's
  split branches too;
- the features are the mean over H and W; no `transform_input`.

Weights: `cli/convert_inception.py` (the `.npz` both packages read), or
`init_random_inception(seed)` for relative comparisons only.  Features run
in fp32 with TF32 off (`fp32_precision`), as the JAX extractor does.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3
SIZE = 299


class FrozenBatchNorm(nn.Module):
    """BatchNorm in eval mode, as the JAX model writes it: buffers
    `weight`, `bias`, `running_mean`, `running_var` (torchvision's names)."""

    def __init__(self, channels: int):
        super().__init__()
        self.register_buffer("weight", torch.ones(channels))
        self.register_buffer("bias", torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        c = lambda t: t[:, None, None]
        return ((x - c(self.running_mean)) / torch.sqrt(c(self.running_var) + BN_EPS)
                * c(self.weight) + c(self.bias))


class BasicConv2d(nn.Module):
    """conv (no bias) + frozen BatchNorm (eps 1e-3) + ReLU."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1,
                 padding=(0, 0)):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding,
                              bias=False)
        self.bn = FrozenBatchNorm(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _branch_pool(x):
    # torchvision's F.avg_pool2d(padding=1) counts the padded zeros
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)


def _max_pool(x):
    return F.max_pool2d(x, 3, stride=2)          # no padding (VALID)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=(2, 2))
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=(1, 1))
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=(1, 1))
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_branch_pool(x))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=(1, 1))
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, _max_pool(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for i in range(2, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_branch_pool(x))
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for i in range(2, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, _max_pool(x)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=(1, 1))
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        bp = self.branch_pool(_branch_pool(x))
        return torch.cat([b1, b3, bd, bp], dim=1)


class InceptionV3(nn.Module):
    """x [N, 3, 299, 299] in [-1, 1] -> (pool3 features [N, 2048], logits
    [N, num_classes]).  Frozen: nothing requires grad."""

    def __init__(self, num_classes: int = 1000):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=(1, 1))
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)
        self.fc = nn.Linear(2048, num_classes)
        self.requires_grad_(False)
        self.eval()

    def forward(self, x):
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _max_pool(x)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = _max_pool(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b",
                     "Mixed_6c", "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b",
                     "Mixed_7c"):
            x = getattr(self, name)(x)
        feats = x.mean(dim=(2, 3))                 # adaptive avg pool -> [N, 2048]
        return feats, self.fc(feats)


@contextlib.contextmanager
def fp32_precision():
    """TF32 off for convolutions and matrix products inside; torch's flags
    as they were on the way out."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def preprocess_for_inception(images: torch.Tensor, size: int = SIZE) -> torch.Tensor:
    """[N, H, W, 3] in [-1, 1] -> [N, 3, size, size] fp32, bilinear with
    half-pixel centres (`jax.image.resize`'s; antialiased only when it
    shrinks, as JAX's); the range is already Inception's input range."""
    x = images.float().permute(0, 3, 1, 2)
    h, w = x.shape[2:]
    if (h, w) != (size, size):
        x = F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False,
                          antialias=h > size or w > size)
    return x.contiguous()


@torch.no_grad()
def init_random_inception(seed: int = 0, num_classes: int = 1000,
                          device="cpu") -> InceptionV3:
    """An InceptionV3 with random weights whose features are usable: the
    JAX init's distribution (`dwcgan_tpu/eval/inception.py:171-192`), drawn
    from a `torch.Generator`, so not JAX's numbers.  Conv kernels flax's
    lecun-normal (truncated normal, variance 1/fan_in) times sqrt(2) (He:
    through ~40 conv+ReLU layers lecun alone decays the signal to ~1e-4 and
    FID to 0 for any two sets); BN at identity; `fc` flax's Dense init
    (lecun-normal kernel, zero bias)."""
    model = InceptionV3(num_classes)
    g = torch.Generator().manual_seed(seed)

    def lecun(w, gain):
        fan_in = w[0].numel()
        # variance_scaling's truncated normal: stddev / .87962566 cut at 2 sd
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=g)
        w.mul_(gain)

    for name, mod in model.named_modules():
        if isinstance(mod, BasicConv2d):
            lecun(mod.conv.weight, math.sqrt(2.0))
    lecun(model.fc.weight, 1.0)
    model.fc.bias.zero_()
    return model.to(device)
