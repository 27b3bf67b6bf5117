"""Data- and tensor-parallel training (the counterpart of
`dwcgan_tpu/parallel/mesh.py`).

The JAX meaning, which the port keeps: `cfg.batch_size` is the *global*
batch; each of the k ranks of the data axis takes `batch_size / k` rows,
and the step is one program on the global batch whose gradients are
averaged (mesh.py:1-17).  Its random tensors are drawn at the global shape
from the step's generator and each rank keeps its own rows (mesh.py:14-16;
`Rows`), so every rank's `state.rng` stays in step with the others and
with a one-process run on the global batch.

Every loss term of the step is a mean over the batch's rows (the
adversarial and classification terms, GP, R1, `gmm_kl`, `gmm_emd`,
`recon_l1`, `diversity_loss` and the VGG term: `losses/`, `models/vgg.py`),
so with equal local batches, which `DataAxis` enforces, the mean of the
ranks' gradients is the gradient of the global batch's loss, and the mean
of their metrics its metrics, up to the all-reduce's summation order.

The collectives are explicit (`all_reduce_grads` between a backward and
Adam, `all_reduce_metrics` on the step's metrics), not
`DistributedDataParallel`: the step runs the discriminator twice before
one backward, runs G's adversarial head through D with D's parameters
taking no gradient, and reads G's gradients for `grad_gen_norm` before
Adam.  Parameters, Adam's moments and the EMA copies are replicated over
the data axis, and stay so.

The model axis (tensor parallelism, `mesh_model > 1`, mesh.py:32-54):
the N ranks form a `data x model` mesh, rank r at (r // model, r % model)
as JAX's `reshape(data, model)` places devices (mesh.py:91).  The ranks of
one model group (one data index) take the same rows and run one program
on them: each holds its slice of the tensors the rules of
`parallel/rules.py` shard, and the collectives of `parallel/tensor.py`
join the slices inside the forward and backward.  A sharded parameter's
gradient (the rank's slice) is averaged over the data group (one model
index); a replicated one's, and the metrics, over the whole mesh, which
gives every rank of a model group the same bits (`all_reduce_grads`).
With `mesh_model` 1 on the whole world no group is made and the data
axis is the world.

A mesh smaller than the world (`mesh_data x mesh_model` below the number
of ranks) is built on ranks `0 .. data * model - 1`, as JAX builds it on
`devices[:data * model]` (mesh.py:82-92).  Every collective then runs over
the mesh's own group; a rank outside the mesh is idle (`DataAxis.idle`):
it takes part in creating the groups, which torch requires of every rank,
and nothing else.

Launch: `python -m torch.distributed.run --nproc_per_node=N -m
dwcgan_tpu_torch.cli.train ... [--mesh_model M]` (NCCL, one card a rank);
in one process the data axis is rank 0 of 1 and nothing changes.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence

import torch
import torch.distributed as dist

from dwcgan_tpu_torch.device import resolve_device
from dwcgan_tpu_torch.parallel.tensor import ModelGroup, count_collective


def maybe_initialize_distributed(device="cuda") -> torch.device:
    """Join the process group when the environment says `WORLD_SIZE > 1`
    (as `torch.distributed.run` sets it; the counterpart of mesh.py:57-77):
    `init_process_group(init_method="env://")`, NCCL for a CUDA device and
    gloo for the CPU, each rank on `cuda:LOCAL_RANK`.  Without `WORLD_SIZE`
    (or with 1) it does nothing, so a plain run never waits on a
    rendezvous.  Returns this rank's device."""
    dev = torch.device(device)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 and not dist.is_initialized():
        if dev.type == "cuda":
            resolve_device("cuda")   # raises without a card
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method="env://")
    return resolve_device(device)


@dataclass(frozen=True)
class Rows:
    """This rank's rows of a global batch of `global_n`: [offset, offset +
    n).  A draw for a tensor whose leading dimension is k * n (a
    pass-batched call on k batches concatenated, e.g. the re-encode of
    [rec, fake, fake1] at 3n) is made at k * global_n, the one-process
    run's shape and order, and keeps this rank's rows of each of its k
    chunks."""
    global_n: int
    offset: int
    n: int

    def draw(self, fn, shape: Sequence[int], generator=None, device=None):
        """`fn(global shape, generator=, device=)` (torch.rand or
        torch.randn) cut to this rank's rows: a tensor of `shape`."""
        shape = tuple(shape)
        k, rest = divmod(shape[0], self.n)
        if rest or k < 1:
            raise ValueError(f"a draw of leading size {shape[0]} is not whole "
                             f"chunks of this rank's {self.n} rows")
        full = fn((k * self.global_n,) + shape[1:], generator=generator,
                  device=device)
        chunks = full.view((k, self.global_n) + shape[1:])
        return chunks[:, self.offset:self.offset + self.n].reshape(shape)


def draw(fn, shape, generator=None, device=None, rows: Optional[Rows] = None):
    """`fn(shape, generator=, device=)`, or with `rows` this rank's rows of
    the draw at the global shape (`Rows.draw`)."""
    if rows is None:
        return fn(tuple(shape), generator=generator, device=device)
    return rows.draw(fn, shape, generator, device)


@dataclass(frozen=True)
class DataAxis:
    """The mesh of one run: this rank, the world size, the global batch and
    the mesh's two axes, `data` x `model`, on ranks 0 .. `mesh` - 1.  Built
    by `from_config`; in one process rank 0 of 1.  `grouped`: a process
    group exists, so the collectives run (a group of one rank included).
    `data_group`: this rank's data group (None: the world, `model` 1 and
    the mesh the world); `model_group`: its model group (None: `model` 1);
    `mesh_group`: the mesh's ranks (None: the mesh is the world)."""
    rank: int
    world: int
    global_batch: int
    grouped: bool = False
    model: int = 1
    data: int = 1
    data_group: Any = field(default=None, compare=False, repr=False)
    model_group: Optional[ModelGroup] = field(default=None, compare=False,
                                              repr=False)
    mesh_group: Any = field(default=None, compare=False, repr=False)

    @property
    def mesh(self) -> int:
        """The number of ranks in the mesh."""
        return self.data * self.model

    @property
    def idle(self) -> bool:
        """This rank lies outside the mesh: it trains nothing."""
        return self.rank >= self.mesh

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    @property
    def local_batch(self) -> int:
        return self.global_batch // self.data

    @property
    def rows(self) -> Rows:
        """This rank's rows of the global batch (the same on every rank of
        a model group), or None in one process without a group (every draw
        is the global one)."""
        if not self.grouped:
            return None
        return Rows(self.global_batch, self.data_rank * self.local_batch,
                    self.local_batch)

    @classmethod
    def from_config(cls, cfg) -> "DataAxis":
        """From the config (`check_mesh`) and the process group's rank and
        size, or rank 0 of 1 without one.  With `mesh_model` above 1, or a
        mesh smaller than the world, every rank makes every group
        (`mesh_groups`): every rank calls this alike."""
        grouped = dist.is_available() and dist.is_initialized()
        rank = dist.get_rank() if grouped else 0
        world = dist.get_world_size() if grouped else 1
        data = check_mesh(cfg, world)
        model = cfg.mesh_model
        if model == 1 and data == world:
            return cls(rank, world, cfg.batch_size, grouped, data=data)
        data_group, model_group, mesh_group = mesh_groups(rank, world, model, data)
        return cls(rank, world, cfg.batch_size, grouped, model, data, data_group,
                   model_group, mesh_group)


def mesh_groups(rank: int, world: int, model: int, data: int):
    """(this rank's data group, its `ModelGroup`, the mesh's group) on the
    `data x model` mesh of ranks 0 .. data * model - 1.  Every rank of the
    world creates every group, in the same order (the mesh's where it is
    smaller than the world, then with a model axis the model groups by data
    index and the data groups by model index), as torch requires, idle
    ranks included.  A group that is the world is None (the default group);
    with `model` 1 there is no model group and the data group is the
    mesh's; an idle rank gets (None, None, None)."""
    size = data * model
    mesh = dist.new_group(list(range(size))) if size < world else None
    by_data, by_model = [], [mesh]
    if model > 1:
        by_data = [dist.new_group(list(range(d * model, (d + 1) * model)))
                   for d in range(data)]
        by_model = [dist.new_group(list(range(j, size, model))) for j in range(model)]
    if rank >= size:
        return None, None, None
    group = (ModelGroup(by_data[rank // model], rank % model, model)
             if model > 1 else None)
    return by_model[rank % model], group, mesh


def check_mesh(cfg, world: int) -> int:
    """The data axis's size for `world` ranks: `cfg.mesh_data` (-1: the
    world size over the model axis; anything else times `cfg.mesh_model`
    at most the world size, the mesh then on the first ranks) and
    `cfg.batch_size` (the global batch, divisible by the data axis), with
    JAX's messages (dwcgan_tpu/parallel/mesh.py:82-92,
    dwcgan_tpu/cli/train.py:130-132)."""
    model = cfg.mesh_model
    if model < 1:
        raise ValueError(f"mesh_model {model} must be at least 1")
    if cfg.mesh_data == -1:
        if world % model:
            # JAX: `assert len(devices) % model == 0` (mesh.py:86), no message
            raise ValueError(f"mesh_model {model} does not divide the {world} "
                             "devices")
        data = world // model
    else:
        data = cfg.mesh_data
    if data * model > world:
        raise ValueError(f"mesh {data}x{model} needs {data * model} devices, "
                         f"have {world}")
    if cfg.batch_size % data:
        raise ValueError(
            f"batch_size {cfg.batch_size} must be divisible by the data mesh "
            f"axis ({data}); set batch_size or mesh_data accordingly")
    return data


def _flat_grads(params):
    """The parameters' gradients in order as one fp32 buffer (a missing
    one as zeros, as `train/step.py::_apply` gives it), and the views to
    copy it back."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    return torch.cat([p.grad.reshape(-1).float() for p in params])


def _all_reduce_mean(params, group, size: int) -> None:
    """Average the gradients of `params` over `group` (None: the world) of
    `size` ranks: one fp32 buffer of them in parameter order, all-reduced
    with SUM, divided by `size`, copied back."""
    if not params:
        return
    buf = _flat_grads(params)
    count_collective("all_reduce_grads", buf)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    buf.div_(size)
    offset = 0
    for p in params:
        n = p.grad.numel()
        p.grad.copy_(buf[offset:offset + n].view_as(p.grad))
        offset += n


def all_reduce_grads(params, axis: Optional[DataAxis]) -> None:
    """Average the gradients of `params` over the data axis.  Runs after a
    backward, before Adam.  A replicated parameter's gradient is averaged
    over every rank of the mesh: the ranks of a model group compute it
    alike, but on the card a backward that adds with atomics (the reflect
    pad's) can give them other last bits, and the mean over the whole mesh
    gives every rank the same update.  A sharded parameter's slice
    (`parallel/rules.py`) is averaged over the data group.  Without a
    process group it does nothing (no copy, no collective); with a group
    of any size, one rank included, it runs the collective."""
    if axis is None or not axis.grouped:
        return
    params = list(params)
    _all_reduce_mean([p for p in params if not hasattr(p, "tp_shard")],
                     axis.mesh_group, axis.mesh)
    _all_reduce_mean([p for p in params if hasattr(p, "tp_shard")],
                     axis.data_group, axis.data)


# metrics that are not averaged: Python floats, and the gradient norms of
# already-averaged gradients (the same on every rank)
NOT_AVERAGED = ("grad_gen_norm", "grad_dis_norm")


def all_reduce_metrics(metrics: Dict, axis: Optional[DataAxis]) -> Dict:
    """The step's 0-d metric tensors averaged over the mesh in one
    collective (the ranks of a model group compute them alike), so every
    rank holds the same; Python floats (`lr`, `ds_w`) and the gradient
    norms stay as they are.  Without a process group, `metrics` itself."""
    if axis is None or not axis.grouped:
        return metrics
    keys = [k for k, v in metrics.items()
            if torch.is_tensor(v) and k not in NOT_AVERAGED]
    if not keys:
        return metrics
    stacked = torch.stack([metrics[k].float() for k in keys])
    count_collective("all_reduce_metrics", stacked)
    dist.all_reduce(stacked, op=dist.ReduceOp.SUM, group=axis.mesh_group)
    stacked.div_(axis.mesh)
    return {**metrics, **{k: stacked[i] for i, k in enumerate(keys)}}


def barrier(axis: Optional[DataAxis]) -> None:
    """Wait for every rank of the mesh."""
    if axis is not None and axis.grouped:
        dist.barrier(group=axis.mesh_group)


def destroy() -> None:
    """Leave the process group, where one exists."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
