"""The collectives of the model axis as conjugate autograd pairs (the
counterpart of what GSPMD inserts for the tensor-parallel rules of
`dwcgan_tpu/parallel/mesh.py:32-54`).

Every rank of a model group runs the same program on the same rows and
computes the same loss; a sharded parameter holds one contiguous slice of
its tensor on each rank.  Four `torch.autograd.Function`s move activations
between the replicated and the sharded form (the Megatron pattern):

- `copy`: forward the identity, backward an all-reduce (SUM): a replicated
  input used by each rank's shard contributes a partial gradient from each;
- `reduce`: forward an all-reduce (SUM) of the ranks' partial products,
  backward the identity;
- `gather(dim)`: forward an all-gather, the slices concatenated in rank
  order along `dim`; backward this rank's slice of the gradient;
- `split(dim)`: forward this rank's slice along `dim`; backward an
  all-gather.

Each backward calls its conjugate Function, not a raw collective, so a
double backward (the gradient penalty, R1) goes through them too.  (The
backwards of `torch.distributed.nn.functional.all_gather` and `all_reduce`
sum the ranks' gradients, which is right when each rank's loss differs; here
every rank's loss is the same, and they would give `size` times the
gradient.)  With no group (`None`) each is the identity and issues nothing.

Sums below fp32 travel and add in fp32 and round once to the tensor's dtype,
so every rank gets the same bits whatever the transport.  A gloo group with
CUDA tensors (more than one rank on one card) stages each collective
through host memory; NCCL takes the card's tensors as they are.
`COLLECTIVES` counts every collective of the parallel layer (these and
`parallel/mesh.py`'s), by kind: calls and the bytes this rank sends (a
sum below fp32 at its fp32 transport).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

COLLECTIVES: Dict[str, Dict[str, int]] = {}


def reset_collectives() -> None:
    COLLECTIVES.clear()


def count_collective(kind: str, t: torch.Tensor) -> None:
    """Count one collective of `kind` sending `t` in `COLLECTIVES`."""
    c = COLLECTIVES.setdefault(kind, {"calls": 0, "bytes": 0})
    c["calls"] += 1
    c["bytes"] += t.numel() * t.element_size()


@dataclass(frozen=True, eq=False)
class ModelGroup:
    """One model group: the process group, this rank's index in it and its
    size.  Kept on the modules whose parameters it shards; a deep copy (the
    EMA copy) shares it."""
    group: Any
    rank: int
    size: int

    def __deepcopy__(self, memo):
        return self

    def _staged(self, t: torch.Tensor) -> bool:
        return t.is_cuda and dist.get_backend(self.group) == "gloo"


def all_reduce_sum(t: torch.Tensor, mg: ModelGroup, kind: str = "all_reduce"
                   ) -> torch.Tensor:
    """A new tensor: the SUM of `t` over the group (below fp32 summed in
    fp32 and rounded once)."""
    buf = t.detach().to(torch.float32 if t.dtype in (torch.bfloat16, torch.float16)
                        else t.dtype, copy=True)
    host = buf.cpu() if mg._staged(buf) else buf
    count_collective(kind, host)
    dist.all_reduce(host, op=dist.ReduceOp.SUM, group=mg.group)
    return host.to(t.device, t.dtype).contiguous(memory_format=_format(t))


def all_gather_cat(t: torch.Tensor, dim: int, mg: ModelGroup) -> torch.Tensor:
    """The ranks' `t` concatenated in rank order along `dim`."""
    src = t.detach().contiguous()
    if mg._staged(src):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(mg.size)]
    count_collective("all_gather", src)
    dist.all_gather(parts, src, group=mg.group)
    return torch.cat(parts, dim).to(t.device).contiguous(memory_format=_format(t))


def _format(t: torch.Tensor):
    if t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last) \
            and not t.is_contiguous():
        return torch.channels_last
    return torch.contiguous_format


def shard_of(t: torch.Tensor, dim: int, mg: ModelGroup) -> torch.Tensor:
    """This rank's contiguous slice of `t` along `dim` (a view)."""
    size = t.shape[dim] // mg.size
    return t.narrow(dim, mg.rank * size, size)


class _Copy(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, mg):
        ctx.mg = mg
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _Reduce.apply(g, ctx.mg), None


class _Reduce(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, mg):
        ctx.mg = mg
        return all_reduce_sum(x, mg)

    @staticmethod
    def backward(ctx, g):
        return _Copy.apply(g, ctx.mg), None


class _Gather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, dim, mg):
        ctx.dim, ctx.mg = dim, mg
        return all_gather_cat(x, dim, mg)

    @staticmethod
    def backward(ctx, g):
        return _Split.apply(g, ctx.dim, ctx.mg), None, None


class _Split(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, dim, mg):
        ctx.dim, ctx.mg = dim, mg
        return shard_of(x, dim, mg).clone(memory_format=_format(x))

    @staticmethod
    def backward(ctx, g):
        return _Gather.apply(g, ctx.dim, ctx.mg), None, None


def copy(x: torch.Tensor, mg: Optional[ModelGroup]) -> torch.Tensor:
    return x if mg is None else _Copy.apply(x, mg)


def reduce(x: torch.Tensor, mg: Optional[ModelGroup]) -> torch.Tensor:
    return x if mg is None else _Reduce.apply(x, mg)


def gather(x: torch.Tensor, dim: int, mg: Optional[ModelGroup]) -> torch.Tensor:
    return x if mg is None else _Gather.apply(x, dim % x.dim(), mg)


def split(x: torch.Tensor, dim: int, mg: Optional[ModelGroup]) -> torch.Tensor:
    return x if mg is None else _Split.apply(x, dim % x.dim(), mg)


@dataclass(frozen=True)
class Shard:
    """A sharded parameter's group and dimension, kept on the parameter and
    on the module that owns it (`parallel/rules.py::shard_`)."""
    mg: ModelGroup
    dim: int


def module_shard(module) -> Optional[Shard]:
    """The `Shard` of `module`'s weight, or None when it is replicated."""
    return getattr(module, "tp_shard", None)


def module_group(module) -> Optional[ModelGroup]:
    s = module_shard(module)
    return None if s is None else s.mg
