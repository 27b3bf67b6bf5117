"""The tensor-parallel rules in the port's parameter names (the counterpart
of `_TP_RULES` and `param_shardings`, dwcgan_tpu/parallel/mesh.py:32-54,
106-122, and of `place_state`, :151-176), and the full tensors a checkpoint
holds.

The port's names are the reference's `state_dict` names that
`interop/jax_params.py` gives the JAX leaves.  A torch weight is the
transpose of a flax kernel, and JAX's one head `Dense(feat -> num_cls *
c_dim)` is the port's `num_cls` Linears (the text heads' input rows
permuted), so the port shards the same dimension of the same tensors, each
slice contiguous in its own layout:

- the Gaussian heads of both encoders, `enc_{style,txt}.{fcs,fcvars}.{i}
  .weight` [c_dim, feat], on the input dim (JAX `head_(mu|logvar)/kernel`,
  dim 0);
- the bi-LSTM's `enc_txt.lstm.weight_{ih,hh}_l{k}[_reverse]` [4H, in], on
  the fused-gate dim (JAX `w_x`, `w_h`, dim 1);
- the style MLP's `mlp.model.1.fc.weight` on its output dim and
  `mlp.model.2.fc.weight` (the AdaIN head) on its input dim (JAX
  `LinearBlock_{1,2}/Dense_0/kernel`, dims 1 and 0);
- the discriminator's `cnns_feat.{s}.{3,4}.conv.weight` on the output
  channels (JAX `Conv2dBlock_[34]/Conv_0/kernel`, dim 3).

A spectral-norm block's kernel is JAX's `sn_kernel`, which no rule names,
and stays replicated; so does a tensor whose dimension the model axis does
not divide (mesh.py:114-115).  No bias is sharded.

`shard_(module, mg)` keeps each rank's slice of the matched parameters
and marks them and their modules (`tp_shard`, a `tensor.Shard`); the
modules then run their sharded forward.  A checkpoint holds full tensors: `full_state_dict` and
`full_optimizer_state` gather them over the model group (a collective on
every rank of it), `local_state_dict` and `local_optimizer_state` cut a
full file to this rank's slices.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

import torch
from torch import nn

from dwcgan_tpu_torch.parallel.tensor import (ModelGroup, Shard, all_gather_cat,
                                              shard_of)

TP_RULES = (
    # style MLP: the middle layer's output, then the AdaIN head's input
    # (contracting): one all-reduce at the head
    (re.compile(r"^mlp\.model\.1\.fc\.weight$"), 0),
    (re.compile(r"^mlp\.model\.2\.fc\.weight$"), 1),
    # discriminator towers: the deep convs' output channels
    (re.compile(r"^cnns_feat\.\d+\.[34]\.conv\.weight$"), 0),
    # Gaussian heads of both encoders: the input (contracting) dim
    (re.compile(r"^enc_(style|txt)\.(fcs|fcvars)\.\d+\.weight$"), 1),
    # bi-LSTM gate kernels: the fused-gate dim
    (re.compile(r"^enc_txt\.lstm\.weight_(ih|hh)_l\d+(_reverse)?$"), 0),
)


def _spectral(module: nn.Module, name: str) -> bool:
    """Whether `name` (`<block>.fc.weight` or `<block>.conv.weight`) is the
    raw kernel of a spectral-norm block."""
    parts = name.split(".")
    if len(parts) < 3 or parts[-2] not in ("fc", "conv"):
        return False
    block = module.get_submodule(".".join(parts[:-2]))
    return getattr(block, "norm_type", None) == "sn"


def param_shards(module: nn.Module, model: int) -> Dict[str, int]:
    """{parameter name: the dim it is sharded on} for a model axis of
    `model` ranks (empty for 1): the first rule that matches, where the
    dimension divides by `model`."""
    if model <= 1:
        return {}
    out = {}
    for name, p in module.named_parameters():
        for pat, dim in TP_RULES:
            if pat.search(name) and p.dim() > dim and p.shape[dim] % model == 0 \
                    and not _spectral(module, name):
                out[name] = dim
                break
    return out


def shard_(module: nn.Module, mg: Optional[ModelGroup]) -> Dict[str, int]:
    """Keep this rank's slice of every parameter `param_shards` names, in
    place, and mark the module that owns it; `mg` None (no model axis)
    leaves `module` as it is.  Returns the shards."""
    shards = param_shards(module, mg.size) if mg is not None else {}
    with torch.no_grad():
        for name, dim in shards.items():
            owner_name, attr = name.rsplit(".", 1)
            owner = module.get_submodule(owner_name)
            p = getattr(owner, attr)
            p.data = shard_of(p.data, dim, mg).clone()
            p.tp_shard = owner.tp_shard = Shard(mg, dim)
    module.tp_shards = shards
    module.tp_group = mg
    return shards


def shards(module: nn.Module) -> Dict[str, int]:
    """The shards `shard_` made of `module` (empty: all replicated)."""
    return getattr(module, "tp_shards", {})


def full_numel(module: nn.Module) -> int:
    """The elements of the module's full parameters, whatever this rank
    holds."""
    sh, mg = shards(module), getattr(module, "tp_group", None)
    return sum(p.numel() * (mg.size if n in sh else 1)
               for n, p in module.named_parameters())


def full_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """`module.state_dict()` with every sharded tensor gathered (a
    collective on every rank of the model group)."""
    sd = module.state_dict()
    for name, dim in shards(module).items():
        sd[name] = all_gather_cat(sd[name], dim, module.tp_group)
    return sd


def local_state_dict(module: nn.Module, sd: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """A full state dict cut to this rank's slices of `module`'s shards."""
    sh = shards(module)
    return {k: shard_of(v, sh[k], module.tp_group).clone() if k in sh else v
            for k, v in sd.items()}


def _opt_dims(opt: torch.optim.Optimizer, module: nn.Module) -> List[Optional[int]]:
    """Per optimizer parameter, in `state_dict` order, its shard dim or
    None."""
    sh = shards(module)
    by_id = {id(p): sh[n] for n, p in module.named_parameters() if n in sh}
    return [by_id.get(id(p)) for g in opt.param_groups for p in g["params"]]


_MOMENTS = ("exp_avg", "exp_avg_sq")


def full_optimizer_state(opt: torch.optim.Optimizer, module: nn.Module) -> Dict:
    """`opt.state_dict()` with the moments of every sharded parameter
    gathered (a collective on every rank of the model group)."""
    sd = opt.state_dict()
    for i, dim in enumerate(_opt_dims(opt, module)):
        if dim is not None and i in sd["state"]:
            st = dict(sd["state"][i])
            for k in _MOMENTS:
                if k in st:
                    st[k] = all_gather_cat(st[k], dim, module.tp_group)
            sd["state"][i] = st
    return sd


def local_optimizer_state(opt: torch.optim.Optimizer, module: nn.Module,
                          saved: Dict) -> Dict:
    """A full optimizer state dict cut to this rank's slices."""
    state = dict(saved["state"])
    for i, dim in enumerate(_opt_dims(opt, module)):
        if dim is not None and i in state:
            state[i] = {k: shard_of(v, dim, module.tp_group).clone()
                        if k in _MOMENTS else v for k, v in state[i].items()}
    return {**saved, "state": state}
