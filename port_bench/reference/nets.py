"""The plain reference of DWC-GAN's nets: the generator (AdaINGen_v2:
content and style encoders, the bi-LSTM text encoder, the AdaIN decoder
with its attention head), the multi-scale discriminator and the VGG16
perceptual loss, as straightforward PyTorch over a {name: tensor} dict of
the reference model's `state_dict` names, in float32.

It follows the reference (yhlleo/DWC-GAN `networks.py`, `networks_v2.py`,
`solver.py`) as the port states it: NCHW convolutions after reflect
padding, the instance norm and AdaIN with biased variance and eps 1e-5
inside the root, the reference LayerNorm (per-sample mean and unbiased
std, eps added to the std, per-channel affine), bilinear 2x upsampling,
LeakyReLU 0.1 in conv blocks, the masked bi-LSTM (packed-sequence
semantics, gates i, f, g, o), the spectral norm by 30 power iterations
from JAX's `normal(PRNGKey(0))` start vector, each norm plus 1e-12.

`Ops` carries the precision: plain float32 (TF32 is switched off by the
caller on the card), or the control, the usual float8 training recipe:
both operands of every convolution and matrix product rounded to e4m3 in
the forward, and the gradient flowing back into each product's output
rounded to e5m2 in the backward, each with one scale per tensor (the
rounding itself passes gradients straight through).

Dropout masks are drawn from a `Drop` (a `torch.Generator` and the
rates) in the order and at the shapes the training step draws them; in
eval mode there is none.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from port_bench.reference.params import VGG_LAYERS
from port_bench.reference.prng import jax_normal_key0

EPS = 1e-5
CONV_LRELU = 0.1
SN_ITERS = 30
BGR_MEAN = (103.939, 116.779, 123.680)
E4M3_MAX, E5M2_MAX = 448.0, 57344.0


def _fp8(t: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """t rounded to `dtype` with one scale for the tensor (its largest
    magnitude onto `top`), back in t's dtype."""
    scale = t.abs().amax().clamp(min=1e-30) / top
    return (t / scale).to(dtype).to(t.dtype) * scale


class _GradE5M2(torch.autograd.Function):
    """Identity forward; the incoming gradient rounded to e5m2."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, E5M2_MAX)


class Ops:
    """Convolution and matrix product in float32, or (`fp8`: the control)
    with e4m3 operands forward and an e5m2 output gradient backward."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def q(self, t: torch.Tensor) -> torch.Tensor:
        if not self.fp8:
            return t
        return t + (_fp8(t.detach(), torch.float8_e4m3fn, E4M3_MAX) - t.detach())

    def g(self, y: torch.Tensor) -> torch.Tensor:
        return _GradE5M2.apply(y) if self.fp8 and y.requires_grad else y

    def conv(self, x, w, b=None, stride=1, padding=0):
        return self.g(F.conv2d(self.q(x), self.q(w), b, stride=stride, padding=padding))

    def linear(self, x, w, b=None):
        return self.g(F.linear(self.q(x), self.q(w), b))


class Drop:
    """Inverted dropout with masks drawn from `generator` (torch.rand at
    the given shape, kept where >= p)."""

    def __init__(self, generator: torch.Generator):
        self.g = generator

    def __call__(self, x: torch.Tensor, p: float, shape=None) -> torch.Tensor:
        u = torch.rand(tuple(shape or x.shape), generator=self.g, device=x.device)
        if shape is not None:
            u = u[:, :x.shape[1]]
        return x * (u >= p).to(x.dtype) / (1.0 - p)


def reflect(x, p):
    return F.pad(x, (p,) * 4, mode="reflect") if p else x


def instance_norm(x):
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(2, 3), keepdim=True)
    return (x - mean) / torch.sqrt(var + EPS)


def adain(x, scale, bias):
    return instance_norm(x) * scale[:, :, None, None] + bias[:, :, None, None]


def layer_norm_ref(x, gamma, beta):
    n = x[0].numel()
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    var = (x - mean).square().sum(dim=(1, 2, 3), keepdim=True) / max(n - 1, 1)
    y = (x - mean) / (torch.sqrt(var) + EPS)
    return y * gamma[None, :, None, None] + beta[None, :, None, None]


def activ(name: str, x):
    if name == "relu":
        return F.relu(x)
    if name == "lrelu":
        return F.leaky_relu(x, CONV_LRELU)
    if name == "tanh":
        return torch.tanh(x)
    if name == "sigmoid":
        return torch.sigmoid(x)
    if name == "none":
        return x
    raise ValueError(f"activation {name!r} is not in the reference")


def sn_weight(w: torch.Tensor) -> torch.Tensor:
    """An OIHW kernel over its largest singular value, the matrix taken
    as [kh * kw * in, out]; u, v without gradient, sigma = v . (W u)."""
    out = w.shape[0]
    mat = w.permute(2, 3, 1, 0).reshape(-1, out)
    with torch.no_grad():
        u = torch.from_numpy(jax_normal_key0(out).copy()).to(w.device)
        u = u / (torch.linalg.vector_norm(u) + 1e-12)
        for _ in range(SN_ITERS):
            v = mat @ u
            v = v / (torch.linalg.vector_norm(v) + 1e-12)
            u = mat.T @ v
            u = u / (torch.linalg.vector_norm(u) + 1e-12)
    return w / (v @ (mat @ u))


def nchw(x):
    return x.permute(0, 3, 1, 2)


def nhwc(x):
    return x.permute(0, 2, 3, 1)


class Generator:
    """The generator over the parameter dict `P` (module docstring)."""

    def __init__(self, cfg: dict, P: Dict[str, torch.Tensor], ops: Ops):
        self.g, self.P, self.ops = cfg["gen"], P, ops
        self.pad = self.g["pad_type"]
        if self.pad != "reflect":
            raise ValueError("the reference pads by reflection only")

    def block(self, prefix, x, k_pad, stride, norm, act, scale=None, bias=None):
        P = self.P
        y = self.ops.conv(reflect(x, k_pad), P[f"{prefix}.conv.weight"],
                          P[f"{prefix}.conv.bias"], stride)
        if norm == "in":
            y = instance_norm(y)
        elif norm == "adain":
            y = adain(y, scale, bias)
        elif norm == "ln":
            y = layer_norm_ref(y, P[f"{prefix}.norm.gamma"], P[f"{prefix}.norm.beta"])
        return activ(act, y)

    def linear(self, prefix, x):
        return self.ops.linear(x, self.P[f"{prefix}.weight"], self.P[f"{prefix}.bias"])

    def heads(self, prefix, feats):
        k = self.g["num_cls"]
        w = torch.cat([self.P[f"{prefix}.{i}.weight"] for i in range(k)])
        b = torch.cat([self.P[f"{prefix}.{i}.bias"] for i in range(k)])
        return self.ops.linear(feats, w, b).reshape(feats.shape[0], k, self.g["c_dim"])

    def style(self, x, drop: Optional[Drop]):
        act = self.g["activ"]
        h = self.block("enc_style.model.0", x, 3, 1, "none", act)
        for i in range(1, 1 + self.g["style_downsample"]):
            h = self.block(f"enc_style.model.{i}", h, 1, 2, "none", act)
        f = h.mean(dim=(2, 3))
        if self.g["use_map"]:
            f = F.relu(self.linear("enc_style.mapping.0", f))
            if drop is not None:
                f = drop(f, 0.1)
            f = F.relu(self.linear("enc_style.mapping.3", f))
        return self.heads("enc_style.fcs", f), self.heads("enc_style.fcvars", f)

    def content(self, x):
        act = self.g["activ"]
        h = self.block("enc_content.model.0", x, 3, 1, "in", act)
        nd = self.g["content_downsample"]
        for j in range(nd):
            h = self.block(f"enc_content.model.{1 + j}", h, 1, 2, "in", act)
        for b in range(self.g["n_res"]):
            p = f"enc_content.model.{1 + nd}.model.{b}.model"
            h = h + self.block(f"{p}.1", self.block(f"{p}.0", h, 1, 1, "in", act),
                               1, 1, "in", "none")
        return h

    def encode(self, images, drop: Optional[Drop] = None):
        """NHWC images -> (content NCHW, mu, logvar [N, K, C])."""
        x = nchw(images)
        mu, logvar = self.style(x, drop)
        return self.content(x), mu, logvar

    def encode_txt(self, style_flat, tokens, lengths, drop: Optional[Drop] = None):
        """The target style from the command: tokens [N, T], lengths [N]."""
        g, P = self.g, self.P
        hid, layers = g["hidden_size"], g["num_layers"]
        x = P["enc_txt.embed_tokens.weight"][tokens.long()]
        total = x.shape[1]
        if drop is not None:
            x = drop(x, g["dropout_in"])
        x = torch.cat([x, style_flat[:, None, :].expand(-1, total, -1)], -1)
        steps = int(lengths.max())          # lengths: best on the host
        lengths = lengths.to(x.device, torch.int64)
        out = x[:, :steps]
        feats = []
        for layer in range(layers):
            if layer and drop is not None:
                out = drop(out, g["dropout_out"], (out.shape[0], total, 2 * hid))
            ys, hs, cs = [], [], []
            for sfx in ("", "_reverse"):
                w_ih = P[f"enc_txt.lstm.weight_ih_l{layer}{sfx}"]
                w_hh = P[f"enc_txt.lstm.weight_hh_l{layer}{sfx}"]
                bias = (P[f"enc_txt.lstm.bias_ih_l{layer}{sfx}"]
                        + P[f"enc_txt.lstm.bias_hh_l{layer}{sfx}"])
                y, h, c = self.lstm_dir(out, lengths, w_ih, w_hh, bias, bool(sfx))
                ys.append(y)
                hs.append(h)
                cs.append(c)
            out = torch.cat(ys, -1)
            feats += [hs[0], hs[1], cs[0], cs[1]]
        f = torch.cat(feats, -1)
        return self.heads("enc_txt.fcs", f), self.heads("enc_txt.fcvars", f)

    def lstm_dir(self, x, lengths, w_ih, w_hh, bias, reverse):
        b, steps, _ = x.shape
        hid = w_hh.shape[1]
        if reverse:
            x = reverse_padded(x, lengths)
        proj = self.ops.linear(x, w_ih, bias)
        h = x.new_zeros(b, hid)
        c = x.new_zeros(b, hid)
        outs = []
        for t in range(steps):
            gates = proj[:, t] + self.ops.linear(h, w_hh)
            i, f, gg, o = gates.chunk(4, -1)
            c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
            h_new = torch.sigmoid(o) * torch.tanh(c_new)
            valid = (t < lengths)[:, None]
            h = torch.where(valid, h_new, h)
            c = torch.where(valid, c_new, c)
            outs.append(torch.where(valid, h_new, torch.zeros_like(h_new)))
        y = torch.stack(outs, 1)
        return (reverse_padded(y, lengths) if reverse else y), h, c

    def decode(self, content, style_flat):
        """content NCHW, style [N, K * C] -> (image NHWC, attention NHWC)."""
        g, P = self.g, self.P
        n, d = content.shape[0], content.shape[1]
        a = F.relu(self.linear("mlp.model.0.fc", style_flat))
        a = F.relu(self.linear("mlp.model.1.fc", a))
        sp = self.linear("mlp.model.2.fc", a).reshape(n, g["n_res"], 2, 2, d)
        x = content
        for b in range(g["n_res"]):
            p = f"dec.model.0.model.{b}.model"
            y = self.block(f"{p}.0", x, 1, 1, "adain", g["activ"],
                           sp[:, b, 0, 1], sp[:, b, 0, 0])
            x = x + self.block(f"{p}.1", y, 1, 1, "adain", "none",
                               sp[:, b, 1, 1], sp[:, b, 1, 0])
        for j in range(g["content_downsample"]):
            x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)
            x = self.block(f"dec.model.{2 + 2 * j}", x, 2, 1, "ln", g["activ"])
        img = torch.tanh(self.ops.conv(reflect(x, 3), P["dec.image_content.conv.weight"],
                                       P["dec.image_content.conv.bias"]))
        if not g["use_attention"]:
            return nhwc(img), None
        att = torch.sigmoid(self.ops.conv(reflect(x, 3), P["dec.image_attention.conv.weight"],
                                          P["dec.image_attention.conv.bias"]))
        return nhwc(img), nhwc(att)


def reverse_padded(x, lengths):
    """out[b, t] = x[b, len_b - 1 - t] for t < len_b, zero past it."""
    t = torch.arange(x.shape[1], device=x.device)
    idx = lengths[:, None] - 1 - t[None, :]
    valid = idx >= 0
    idx = idx.clamp(0, x.shape[1] - 1)
    out = torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[2]))
    return torch.where(valid[..., None], out, torch.zeros_like(out))


def blend(img, att, x_real, on: bool = True):
    """img * att + x_real * (1 - att) when the attention head is on."""
    if att is None or not on:
        return img
    return img * att + x_real * (1.0 - att)


def translate(gen: Generator, images, tokens, lengths):
    """Serving: encode, text-encode, decode, blend (solver.py:142-149)."""
    with torch.no_grad():
        content, mu, _ = gen.encode(images)
        n = mu.shape[0]
        mu_txt, _ = gen.encode_txt(mu.reshape(n, -1), tokens, lengths)
        img, att = gen.decode(content, mu_txt.reshape(n, -1))
        return blend(img, att, images)


class Discriminator:
    """Multi-scale PatchGAN with the attribute head (networks.py:43-114)."""

    def __init__(self, cfg: dict, P: Dict[str, torch.Tensor], ops: Ops):
        self.d, self.P, self.ops = cfg["dis"], P, ops
        if self.d["pad_type"] != "reflect":
            raise ValueError("the reference pads by reflection only")

    def __call__(self, images, P: Optional[Dict[str, torch.Tensor]] = None):
        """NHWC images -> per scale (src, cls [N, K]); `P` overrides the
        parameters (the generator's update reads them detached)."""
        P = self.P if P is None else P
        x = nchw(images)
        outs = []
        for s in range(self.d["num_scales"]):
            h = x
            for j in range(self.d["n_layer"]):
                w = P[f"cnns_feat.{s}.{j}.conv.weight"]
                norm = self.d["norm"] if j else "none"
                if norm == "sn":
                    w = sn_weight(w)
                h = self.ops.conv(reflect(h, 1), w, P[f"cnns_feat.{s}.{j}.conv.bias"], 2)
                if norm == "in":
                    h = instance_norm(h)
                h = activ(self.d["activ"], h)
            src = self.ops.conv(h, P[f"cnns_src.{s}.weight"], P[f"cnns_src.{s}.bias"])
            cls = self.ops.conv(h, P[f"cnns_cls.{s}.weight"])
            outs.append((src, cls.reshape(cls.shape[0], -1)))
            x = F.avg_pool2d(x, 2)
        return outs


class VggLoss:
    """Mean squared difference of the instance-normed relu5_3 features of
    two NHWC images in [-1, 1] (solver.py:242-247, utils.py:207-217)."""

    def __init__(self, P: Dict[str, torch.Tensor], ops: Ops):
        self.P, self.ops = P, ops

    def features(self, images):
        bgr = (images.flip(-1) + 1.0) * 255.0 * 0.5
        x = nchw(bgr - torch.tensor(BGR_MEAN, device=images.device))
        for name, _, pool in VGG_LAYERS:
            x = F.relu(self.ops.conv(x, self.P[f"{name}.weight"], self.P[f"{name}.bias"],
                                     padding=1))
            if pool:
                x = F.max_pool2d(x, 2)
        return instance_norm(x)

    def __call__(self, x, y):
        return (self.features(x) - self.features(y)).square().mean()

