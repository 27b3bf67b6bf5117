"""Load the JAX package's parameters into the port: generator,
discriminator, VGG16 and InceptionV3.

`load_jax_params(gen, params)` takes the parameter tree of a
`dwcgan_tpu.models.generator.Generator` as numpy arrays, nested dicts or a
flat dict keyed by "/"-joined paths (an optional leading "params" level is
dropped), and loads it into a port `Generator`.  It is the inverse of
`dwcgan_tpu/interop/torch_import.py::convert_reference_generator`, whose
names the port keeps:

- conv kernels HWIO -> OIHW, dense kernels [in, out] -> [out, in];
- the fused Dense heads of width num_cls*c_dim -> per-attribute
  `fcs.{i}` / `fcvars.{i}` Linears;
- LSTM `l{i}/{fwd,bwd}_{w_x,w_h,b}` -> `weight_ih_l{i}[_reverse]`,
  `weight_hh_l{i}[_reverse]`, `bias_ih = b`, `bias_hh = 0`;
- the text heads' input rows from the JAX order [h all layers, c all
  layers] to the port's per-layer order [h_l, c_l] (torch_import.py:137-150).

`bias_hh` carries no JAX parameter: it is loaded as zero and stays frozen
(`models/generator.py::freeze_lstm_bias_hh`).

Every block maps its options' leaves too: a spectral norm's raw
`sn_kernel` / `sn_bias` to `conv.*` or `fc.*`, `bn_gamma` / `bn_beta` to
`norm.weight` / `norm.bias`, a LinearBlock's `ln_gamma` / `ln_beta` to
`norm.gamma` / `norm.beta`, a PReLU's `PReLU_0/slope` (shape ()) to
`activation.weight` ([1]).  A JAX leaf that no mapping reads raises, so an
option the mapping does not know cannot load silently.
`jax_legacy_to_state_dict` / `load_jax_legacy_params` map the five
modules of `dwcgan_tpu/models/legacy.py` to `models/legacy.py`.

`load_jax_dis_params` is the inverse of `convert_reference_discriminator`
(torch_import.py:156-169); `jax_vgg_to_state_dict` maps the VGG16 tree
(`{name}/kernel` HWIO, `{name}/bias`) to the port's `{name}.weight` OIHW;
`jax_inception_to_state_dict` maps the FID/IS InceptionV3 tree
(`dwcgan_tpu/eval/inception.py`) to the port's torchvision names.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def flatten_params(params) -> Dict[str, np.ndarray]:
    """Nested or flat parameter dict -> {"a/b/c": array}, without "params/"."""
    flat: Dict[str, np.ndarray] = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else str(k), v)
        else:
            flat[prefix] = np.asarray(node, dtype=np.float32)

    walk("", params)
    if all(k.startswith("params/") for k in flat):
        flat = {k[len("params/"):]: v for k, v in flat.items()}
    return flat


class _Leaves(dict):
    """The flat JAX tree; `done()` raises on any leaf no mapping read, so
    a block option the mapping does not know cannot load silently."""

    def __init__(self, params):
        super().__init__(flatten_params(params))
        self.read = set()

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)

    def done(self, sd) -> Dict[str, np.ndarray]:
        left = sorted(set(self) - self.read)
        if left:
            raise KeyError(f"JAX leaves with no port parameter: {left}")
        # np.array copies: the inputs may be read-only views (of JAX buffers
        # or an open .npz), which torch.from_numpy must not share
        return {k: np.array(v, dtype=np.float32, order="C")
                for k, v in sd.items()}


def _at(name: str, leaf: str) -> str:
    return f"{name}.{leaf}" if name else leaf


def _sub(path: str, leaf: str) -> str:
    return f"{path}/{leaf}" if path else leaf


class _Mapper:
    """Writes port names into `sd` from the JAX leaves `p`; a module at the
    top of either tree has the name or path ""."""

    def __init__(self, p: _Leaves):
        self.p, self.sd = p, {}

    def conv(self, name, path):
        self.sd[f"{name}.weight"] = self.p[f"{path}/kernel"].transpose(3, 2, 0, 1)
        if f"{path}/bias" in self.p:
            self.sd[f"{name}.bias"] = self.p[f"{path}/bias"]

    def dense(self, name, path):
        self.sd[f"{name}.weight"] = self.p[f"{path}/kernel"].T
        self.sd[f"{name}.bias"] = self.p[f"{path}/bias"]

    def block(self, name, path):
        """A Conv2dBlock or LinearBlock: its conv/dense (raw, or the
        spectral-norm `sn_kernel`/`sn_bias`), its norm's affine (ln ->
        `norm.gamma`/`norm.beta`, bn -> `norm.weight`/`norm.bias`) and a
        PReLU's slope (shape () -> `activation.weight` [1])."""
        p, sd = self.p, self.sd
        if f"{path}/sn_kernel" in p:
            k = p[f"{path}/sn_kernel"]
            layer = "conv" if k.ndim == 4 else "fc"
            sd[f"{name}.{layer}.weight"] = (k.transpose(3, 2, 0, 1)
                                            if k.ndim == 4 else k.T)
            sd[f"{name}.{layer}.bias"] = p[f"{path}/sn_bias"]
        elif f"{path}/Dense_0/kernel" in p:
            self.dense(f"{name}.fc", f"{path}/Dense_0")
        else:
            self.conv(f"{name}.conv", f"{path}/Conv_0")
        for jax_leaf, leaf in (("ln_gamma", "gamma"), ("ln_beta", "beta"),
                               ("bn_gamma", "weight"), ("bn_beta", "bias")):
            if f"{path}/{jax_leaf}" in p:
                sd[f"{name}.norm.{leaf}"] = p[f"{path}/{jax_leaf}"]
        if f"{path}/PReLU_0/slope" in p:
            sd[f"{name}.activation.weight"] = p[f"{path}/PReLU_0/slope"].reshape(1)

    def heads(self, name, path, n_heads, width, kernel=None):
        """A fused Dense of n_heads * width outputs -> `{name}.{i}` Linears."""
        k = self.p[f"{path}/kernel"] if kernel is None else kernel
        b = self.p[f"{path}/bias"]
        for i in range(n_heads):
            self.sd[f"{name}.{i}.weight"] = k[:, i * width:(i + 1) * width].T
            self.sd[f"{name}.{i}.bias"] = b[i * width:(i + 1) * width]

    def style_convs(self, name, path, n_downsample):
        for i in range(1 + 2 + (n_downsample - 2)):
            self.block(_at(name, f"model.{i}"), _sub(path, f"Conv2dBlock_{i}"))

    def content_encoder(self, name, path, n_downsample, n_res):
        for i in range(1 + n_downsample):
            self.block(_at(name, f"model.{i}"), _sub(path, f"Conv2dBlock_{i}"))
        for b in range(n_res):
            for j in range(2):
                self.block(
                    _at(name, f"model.{1 + n_downsample}.model.{b}.model.{j}"),
                    _sub(path, f"ResBlocks_0/ResBlock_{b}/Conv2dBlock_{j}"))

    def decoder(self, name, path, n_upsample, n_res, use_attention):
        for b in range(n_res):
            for j in range(2):
                self.block(_at(name, f"model.0.model.{b}.model.{j}"),
                           _sub(path, f"AdaINResBlocks_0/Conv2dBlock_{2 * b + j}"))
        for u in range(n_upsample):
            self.block(_at(name, f"model.{2 + 2 * u}"),
                       _sub(path, f"Conv2dBlock_{u}"))
        self.conv(_at(name, "image_content.conv"), _sub(path, "image_head/Conv_0"))
        if use_attention:
            self.conv(_at(name, "image_attention.conv"),
                      _sub(path, "attention_head/Conv_0"))

    def mlp(self, name, path, n_blk=3):
        for i in range(n_blk):
            self.block(_at(name, f"model.{i}"), _sub(path, f"LinearBlock_{i}"))

    def txt_encoder(self, name, path, num_layers, hidden, num_cls, c_dim):
        p, sd = self.p, self.sd
        sd[f"{name}.embed_tokens.weight"] = p[f"{path}/embedding"]
        for layer in range(num_layers):
            for d, suf in (("fwd", ""), ("bwd", "_reverse")):
                base = f"{path}/lstm/l{layer}/{d}"
                sd[f"{name}.lstm.weight_ih_l{layer}{suf}"] = p[f"{base}_w_x"].T
                sd[f"{name}.lstm.weight_hh_l{layer}{suf}"] = p[f"{base}_w_h"].T
                sd[f"{name}.lstm.bias_ih_l{layer}{suf}"] = p[f"{base}_b"]
                sd[f"{name}.lstm.bias_hh_l{layer}{suf}"] = np.zeros_like(
                    p[f"{base}_b"])

        def txt_rows(head):
            # the JAX rows [{h,c}, layer, dir, H] -> the port's [layer,
            # {h,c}, dir, H] (torch_import.py:137-150; any num_cls)
            k = p[f"{path}/{head}/kernel"].reshape(2, num_layers, 2, hidden, -1)
            return k.transpose(1, 0, 2, 3, 4).reshape(num_layers * 4 * hidden, -1)

        self.heads(f"{name}.fcs", f"{path}/head_mu", num_cls, c_dim,
                   txt_rows("head_mu"))
        self.heads(f"{name}.fcvars", f"{path}/head_logvar", num_cls, c_dim,
                   txt_rows("head_logvar"))


def jax_to_state_dict(params, gen_cfg) -> Dict[str, np.ndarray]:
    """JAX generator params -> a port (reference-named) state dict."""
    c = gen_cfg
    m = _Mapper(_Leaves(params))
    m.style_convs("enc_style", "enc_style", c.style_downsample)
    if c.use_map:
        m.dense("enc_style.mapping.0", "enc_style/map_0")
        m.dense("enc_style.mapping.3", "enc_style/map_1")
    m.heads("enc_style.fcs", "enc_style/head_mu", c.num_cls, c.c_dim)
    m.heads("enc_style.fcvars", "enc_style/head_logvar", c.num_cls, c.c_dim)
    m.content_encoder("enc_content", "enc_content", c.content_downsample, c.n_res)
    m.decoder("dec", "dec", c.content_downsample, c.n_res, c.use_attention)
    m.mlp("mlp", "mlp")
    m.txt_encoder("enc_txt", "enc_txt", c.num_layers, c.hidden_size,
                  c.num_cls, c.c_dim)
    return m.p.done(m.sd)


def load_jax_params(gen, params) -> None:
    """Load JAX generator params into `gen` (strict: every name must match)."""
    sd = jax_to_state_dict(params, gen.cfg)
    gen.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                        strict=True)


def jax_dis_to_state_dict(params, dis_cfg) -> Dict[str, np.ndarray]:
    """JAX MsImageDis params -> a port (reference-named) state dict."""
    m = _Mapper(_Leaves(params))
    for s in range(dis_cfg.num_scales):
        base = f"scale_{s}"
        for j in range(dis_cfg.n_layer):
            m.block(f"cnns_feat.{s}.{j}", f"{base}/Conv2dBlock_{j}")
        m.conv(f"cnns_src.{s}", f"{base}/src_head")
        m.conv(f"cnns_cls.{s}", f"{base}/cls_head")
    return m.p.done(m.sd)


def load_jax_dis_params(dis, params) -> None:
    """Load JAX discriminator params into `dis` (strict)."""
    sd = jax_dis_to_state_dict(params, dis.cfg)
    dis.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                        strict=True)


LEGACY_KINDS = ("StyleEncoderV1", "TxtEncoderV1", "ContentEncoderOld",
                "AdaINGenV1", "VAEGen")


def _legacy(m: _Mapper, kind: str, name: str, path: str, d: dict) -> None:
    """Map one legacy module (`dwcgan_tpu/models/legacy.py`) at JAX `path`
    to port names under `name`."""
    if kind == "StyleEncoderV1":
        m.style_convs(name, path, d.get("n_downsample", 5))
        if d["use_map"]:
            m.dense(_at(name, "mapping.0"), _sub(path, "Dense_0"))
            m.dense(_at(name, "mapping.3"), _sub(path, "Dense_1"))
        m.dense(_at(name, "fc"), _sub(path, "fc"))
        m.dense(_at(name, "fcVar"), _sub(path, "fcVar"))
    elif kind == "TxtEncoderV1":
        m.txt_encoder(_at(name, "inner"), _sub(path, "inner"), d["num_layers"],
                      d["hidden_size"], 1, d["style_dim"])
    elif kind == "ContentEncoderOld":
        m.content_encoder(name, path, d["n_downsample"], d["n_res"])
    elif kind == "AdaINGenV1":
        _legacy(m, "StyleEncoderV1", _at(name, "enc_style"),
                _sub(path, "enc_style"), dict(d, n_downsample=5))
        m.content_encoder(_at(name, "enc_content"), _sub(path, "enc_content"),
                          d["n_downsample"], d["n_res"])
        m.decoder(_at(name, "dec"), _sub(path, "dec"), d["n_downsample"],
                  d["n_res"], d["use_attention"])
        _legacy(m, "TxtEncoderV1", _at(name, "enc_txt"), _sub(path, "enc_txt"), d)
        m.mlp(_at(name, "mlp"), _sub(path, "mlp"))
    elif kind == "VAEGen":
        m.content_encoder(_at(name, "enc"), _sub(path, "enc"),
                          d["n_downsample"], d["n_res"])
        m.decoder(_at(name, "dec"), _sub(path, "dec"), d["n_downsample"],
                  d["n_res"], False)
    else:
        raise ValueError(f"unknown legacy module {kind!r} ({LEGACY_KINDS})")


def jax_legacy_to_state_dict(params, kind: str, **dims) -> Dict[str, np.ndarray]:
    """JAX legacy-module params -> the port module's state dict.  `kind` is
    one of `LEGACY_KINDS`; `dims` are the module's sizes: `n_downsample`,
    `n_res`, `use_map`, `use_attention`, `style_dim`, `num_layers`,
    `hidden_size`, as the kind needs (`models/legacy.py` keeps them as
    each module's `dims`)."""
    m = _Mapper(_Leaves(params))
    _legacy(m, kind, "", "", dims)
    return m.p.done(m.sd)


def load_jax_legacy_params(model, params) -> None:
    """Load a JAX legacy module's params into its port counterpart
    (`models/legacy.py`; strict)."""
    sd = jax_legacy_to_state_dict(params, type(model).__name__, **model.dims)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                          strict=True)


def jax_vgg_to_state_dict(params) -> Dict[str, np.ndarray]:
    """JAX VGG16 params ({name}/kernel HWIO, {name}/bias) -> the port's
    {name}.weight (OIHW) and {name}.bias."""
    p = flatten_params(params)
    sd = {}
    for key, v in p.items():
        name, leaf = key.rsplit("/", 1)
        if leaf == "kernel":
            sd[f"{name}.weight"] = v.transpose(3, 2, 0, 1)
        else:
            sd[f"{name}.bias"] = v
    return {k: np.array(v, dtype=np.float32, order="C") for k, v in sd.items()}


_INCEPTION_BN = {"bn_gamma": "bn.weight", "bn_beta": "bn.bias",
                 "bn_mean": "bn.running_mean", "bn_var": "bn.running_var"}


def jax_inception_to_state_dict(params) -> Dict[str, np.ndarray]:
    """JAX InceptionV3 variables (`{block}/conv/kernel` HWIO, `{block}/bn_*`,
    `fc/kernel` [in, out], `fc/bias`) -> the port's torchvision-named
    state dict: conv weights OIHW, the BN leaves as the BN buffers, `fc`
    transposed."""
    sd: Dict[str, np.ndarray] = {}
    for key, v in flatten_params(params).items():
        *path, leaf = key.split("/")
        if leaf == "kernel" and path[-1] == "conv":
            sd[".".join(path) + ".weight"] = v.transpose(3, 2, 0, 1)
        elif leaf in _INCEPTION_BN:
            sd[".".join(path + [_INCEPTION_BN[leaf]])] = v
        elif path == ["fc"] and leaf == "kernel":
            sd["fc.weight"] = v.T
        elif path == ["fc"] and leaf == "bias":
            sd["fc.bias"] = v
        else:
            raise KeyError(f"no InceptionV3 tensor for {key!r}")
    return {k: np.array(v, dtype=np.float32, order="C") for k, v in sd.items()}


def load_jax_inception(model, params) -> None:
    """Load JAX InceptionV3 variables into the port's `InceptionV3`
    (strict: every name must match), on the model's device."""
    sd = jax_inception_to_state_dict(params)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                          strict=True)
