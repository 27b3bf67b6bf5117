"""Offline tool: convert torchvision `inception_v3` weights for the FID/IS
harness (the counterpart of `dwcgan_tpu/cli/convert_inception.py`; no
network, so the user supplies `inception_v3_google-*.pth`).

    python -m dwcgan_tpu_torch.cli.convert_inception --torch_weights iv3.pth --out iv3.npz

`convert` writes the same `.npz` as the JAX tool, key for key (conv
kernels HWIO under `<block>/conv/kernel`, `<block>/bn_{gamma,beta,mean,
var}`, `fc/kernel` [in, out], `fc/bias`), so one file serves both
packages.  Like the JAX tool it drops `num_batches_tracked` and
`AuxLogits.fc` and keeps the `AuxLogits` convolutions, which no trunk
reads; `load_converted` skips them and is strict on every trunk tensor.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from dwcgan_tpu_torch.interop.jax_params import load_jax_inception

AUX = "AuxLogits"


def convert(torch_weights: str, out: str):
    sd = torch.load(torch_weights, map_location="cpu", weights_only=True)
    arrays = {}
    for key, val in sd.items():
        v = val.numpy()
        if key.endswith(".conv.weight"):
            arrays[key.replace(".conv.weight", "/conv/kernel")] = v.transpose(2, 3, 1, 0)
        elif key.endswith(".bn.weight"):
            arrays[key.replace(".bn.weight", "/bn_gamma")] = v
        elif key.endswith(".bn.bias"):
            arrays[key.replace(".bn.bias", "/bn_beta")] = v
        elif key.endswith(".bn.running_mean"):
            arrays[key.replace(".bn.running_mean", "/bn_mean")] = v
        elif key.endswith(".bn.running_var"):
            arrays[key.replace(".bn.running_var", "/bn_var")] = v
        elif key == "fc.weight":
            arrays["fc/kernel"] = v.T
        elif key == "fc.bias":
            arrays["fc/bias"] = v
    np.savez(out, **arrays)
    print(f"wrote {out} with {len(arrays)} arrays")


def load_converted(path: str, model):
    """Load a converted `.npz` into the port's `InceptionV3` (on its
    device), strict on the trunk; returns the model."""
    with np.load(path) as data:
        params = {k.replace(".", "/"): data[k] for k in data.files
                  if not k.startswith(AUX)}
    load_jax_inception(model, params)
    return model


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--torch_weights", required=True)
    p.add_argument("--out", required=True)
    a = p.parse_args()
    convert(a.torch_weights, a.out)
