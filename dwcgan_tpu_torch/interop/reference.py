"""Load a trained reference (torch) DWC-GAN checkpoint into the port's
models (the counterpart of `dwcgan_tpu/interop/torch_import.py`).

The port's generator and discriminator keep the reference's `state_dict`
names, and its text heads read their inputs in the reference's row order
[h_l, c_l] per layer, so an import is `load_state_dict` (strict) after
three rules:

- the reference saves `{'a': gen_state_dict}` and `{'b': dis_state_dict}`;
  the wrapper is taken off;
- a top-level `embed_tokens.weight` is the text encoder's word embedding
  (`torch_import.py:121-123`);
- each LSTM `bias_hh_l*` is folded into `bias_ih_l*` (their fp32 sum, as
  `torch_import.py:131-133` sums them) and set to zero: the port's
  `bias_hh` stays zero and frozen (`models/generator.py::
  freeze_lstm_bias_hh`).
"""

from __future__ import annotations

from typing import Dict

import torch

EMBED = "enc_txt.embed_tokens.weight"


def reference_generator_state(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A reference `AdaINGen_v2` state dict -> the port generator's: fp32
    tensors, the embedding under the text encoder, `bias_hh` folded into
    `bias_ih`."""
    out = {k: v.detach().float().clone() for k, v in sd.get("a", sd).items()}
    if "embed_tokens.weight" in out:
        out[EMBED] = out.pop("embed_tokens.weight")
    for name in [k for k in out if ".bias_hh_l" in k]:
        ih = name.replace(".bias_hh_l", ".bias_ih_l")
        out[ih] = out[ih] + out[name]
        out[name] = torch.zeros_like(out[name])
    return out


def load_reference_generator(gen, sd) -> None:
    """Load a reference generator checkpoint (wrapped or not) into the
    port's `Generator`, on its device (strict: a checkpoint of another
    config raises)."""
    gen.load_state_dict(reference_generator_state(sd), strict=True)


def load_reference_discriminator(dis, sd) -> None:
    """Load a reference `MsImageDis` checkpoint (wrapped or not) into the
    port's discriminator, on its device (strict)."""
    dis.load_state_dict({k: v.detach().float() for k, v in sd.get("b", sd).items()},
                        strict=True)
