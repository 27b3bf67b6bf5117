"""Offline tool: convert torchvision VGG16 weights to the `.npz` the
perceptual loss loads (the counterpart of `dwcgan_tpu/cli/convert_vgg.py`;
no network, so the user supplies a `vgg16-*.pth` state_dict).

    python -m dwcgan_tpu_torch.cli.convert_vgg --torch_weights vgg16.pth \
        --out OUT/models/vgg16.npz

The same `.npz` as the JAX tool (`{name}_kernel` HWIO, `{name}_bias`), key
for key.  The training CLI reads `<output_path>/models/vgg16.npz` when the
config's `vgg_model_path` is empty, as the JAX CLI does.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from dwcgan_tpu_torch.models.vgg import LAYERS


def convert(torch_weights: str, out: str):
    sd = torch.load(torch_weights, map_location="cpu", weights_only=True)
    # torchvision vgg16 features: conv layers at indices 0,2,5,7,10,12,14,...
    conv_keys = sorted(
        {k.rsplit(".", 1)[0] for k in sd if k.startswith("features") and k.endswith("weight")},
        key=lambda k: int(k.split(".")[1]))
    assert len(conv_keys) >= len(LAYERS), f"found {len(conv_keys)} convs"
    arrays = {}
    for (name, ch, _), key in zip(LAYERS, conv_keys):
        w = sd[key + ".weight"].numpy()          # OIHW
        b = sd[key + ".bias"].numpy()
        assert w.shape[0] == ch, (name, w.shape)
        arrays[f"{name}_kernel"] = w.transpose(2, 3, 1, 0)  # -> HWIO
        arrays[f"{name}_bias"] = b
    np.savez(out, **arrays)
    print(f"wrote {out} with {len(arrays)} arrays")


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--torch_weights", required=True)
    p.add_argument("--out", required=True)
    a = p.parse_args()
    convert(a.torch_weights, a.out)
