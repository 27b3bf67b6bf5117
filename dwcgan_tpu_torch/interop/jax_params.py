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


def jax_to_state_dict(params, gen_cfg) -> Dict[str, np.ndarray]:
    """JAX generator params -> a port (reference-named) state dict."""
    p = flatten_params(params)
    sd: Dict[str, np.ndarray] = {}
    K, C = gen_cfg.num_cls, gen_cfg.c_dim

    def conv(name, path):
        sd[f"{name}.weight"] = p[f"{path}/kernel"].transpose(3, 2, 0, 1)
        sd[f"{name}.bias"] = p[f"{path}/bias"]

    def dense(name, path):
        sd[f"{name}.weight"] = p[f"{path}/kernel"].T
        sd[f"{name}.bias"] = p[f"{path}/bias"]

    def heads(name, path, kernel=None):
        k = p[f"{path}/kernel"] if kernel is None else kernel
        b = p[f"{path}/bias"]
        for i in range(K):
            sd[f"{name}.{i}.weight"] = k[:, i * C:(i + 1) * C].T
            sd[f"{name}.{i}.bias"] = b[i * C:(i + 1) * C]

    n_style = 1 + 2 + (gen_cfg.style_downsample - 2)
    for i in range(n_style):
        conv(f"enc_style.model.{i}.conv", f"enc_style/Conv2dBlock_{i}/Conv_0")
    if gen_cfg.use_map:
        dense("enc_style.mapping.0", "enc_style/map_0")
        dense("enc_style.mapping.3", "enc_style/map_1")
    heads("enc_style.fcs", "enc_style/head_mu")
    heads("enc_style.fcvars", "enc_style/head_logvar")

    nd = gen_cfg.content_downsample
    for i in range(1 + nd):
        conv(f"enc_content.model.{i}.conv",
             f"enc_content/Conv2dBlock_{i}/Conv_0")
    for b in range(gen_cfg.n_res):
        for j in range(2):
            conv(f"enc_content.model.{1 + nd}.model.{b}.model.{j}.conv",
                 f"enc_content/ResBlocks_0/ResBlock_{b}/Conv2dBlock_{j}/Conv_0")

    for b in range(gen_cfg.n_res):
        for j in range(2):
            conv(f"dec.model.0.model.{b}.model.{j}.conv",
                 f"dec/AdaINResBlocks_0/Conv2dBlock_{2 * b + j}/Conv_0")
    for u in range(nd):
        t = 2 + 2 * u
        conv(f"dec.model.{t}.conv", f"dec/Conv2dBlock_{u}/Conv_0")
        sd[f"dec.model.{t}.norm.gamma"] = p[f"dec/Conv2dBlock_{u}/ln_gamma"]
        sd[f"dec.model.{t}.norm.beta"] = p[f"dec/Conv2dBlock_{u}/ln_beta"]
    conv("dec.image_content.conv", "dec/image_head/Conv_0")
    if gen_cfg.use_attention:
        conv("dec.image_attention.conv", "dec/attention_head/Conv_0")

    for i in range(3):
        dense(f"mlp.model.{i}.fc", f"mlp/LinearBlock_{i}/Dense_0")

    sd["enc_txt.embed_tokens.weight"] = p["enc_txt/embedding"]
    for layer in range(gen_cfg.num_layers):
        for d, suf in (("fwd", ""), ("bwd", "_reverse")):
            base = f"enc_txt/lstm/l{layer}/{d}"
            sd[f"enc_txt.lstm.weight_ih_l{layer}{suf}"] = p[f"{base}_w_x"].T
            sd[f"enc_txt.lstm.weight_hh_l{layer}{suf}"] = p[f"{base}_w_h"].T
            sd[f"enc_txt.lstm.bias_ih_l{layer}{suf}"] = p[f"{base}_b"]
            sd[f"enc_txt.lstm.bias_hh_l{layer}{suf}"] = np.zeros_like(
                p[f"{base}_b"])

    L, H = gen_cfg.num_layers, gen_cfg.hidden_size

    def txt_rows(path):
        k = p[f"{path}/kernel"].reshape(2, L, 2, H, -1)  # [{h,c}, layer, dir, H, out]
        return k.transpose(1, 0, 2, 3, 4).reshape(L * 4 * H, -1)

    heads("enc_txt.fcs", "enc_txt/head_mu", txt_rows("enc_txt/head_mu"))
    heads("enc_txt.fcvars", "enc_txt/head_logvar",
          txt_rows("enc_txt/head_logvar"))
    # np.array copies: the inputs may be read-only views (of JAX buffers or
    # an open .npz), which torch.from_numpy must not share
    return {k: np.array(v, dtype=np.float32, order="C") for k, v in sd.items()}


def load_jax_params(gen, params) -> None:
    """Load JAX generator params into `gen` (strict: every name must match)."""
    sd = jax_to_state_dict(params, gen.cfg)
    gen.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                        strict=True)


def jax_dis_to_state_dict(params, dis_cfg) -> Dict[str, np.ndarray]:
    """JAX MsImageDis params -> a port (reference-named) state dict."""
    p = flatten_params(params)
    sd: Dict[str, np.ndarray] = {}
    for s in range(dis_cfg.num_scales):
        base = f"scale_{s}"
        for j in range(dis_cfg.n_layer):
            conv = f"{base}/Conv2dBlock_{j}/Conv_0"
            sd[f"cnns_feat.{s}.{j}.conv.weight"] = p[f"{conv}/kernel"].transpose(3, 2, 0, 1)
            sd[f"cnns_feat.{s}.{j}.conv.bias"] = p[f"{conv}/bias"]
            if dis_cfg.norm == "ln" and j > 0:   # the first block has none
                sd[f"cnns_feat.{s}.{j}.norm.gamma"] = p[f"{base}/Conv2dBlock_{j}/ln_gamma"]
                sd[f"cnns_feat.{s}.{j}.norm.beta"] = p[f"{base}/Conv2dBlock_{j}/ln_beta"]
        sd[f"cnns_src.{s}.weight"] = p[f"{base}/src_head/kernel"].transpose(3, 2, 0, 1)
        sd[f"cnns_src.{s}.bias"] = p[f"{base}/src_head/bias"]
        sd[f"cnns_cls.{s}.weight"] = p[f"{base}/cls_head/kernel"].transpose(3, 2, 0, 1)
    return {k: np.array(v, dtype=np.float32, order="C") for k, v in sd.items()}


def load_jax_dis_params(dis, params) -> None:
    """Load JAX discriminator params into `dis` (strict)."""
    sd = jax_dis_to_state_dict(params, dis.cfg)
    dis.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
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
