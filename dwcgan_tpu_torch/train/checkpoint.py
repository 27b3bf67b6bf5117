"""Lossless checkpoints of the training state (the counterpart of
`dwcgan_tpu/train/checkpoint.py`).

One file per step, `ckpt_<step:08d>.pt`, written by `torch.save`: the
`state_dict()` of the generator, the discriminator and their EMA copies,
both optimizers' `state_dict()` (Adam's moments and counts), the step, the
state of the step's random generator (`state.rng`: the style draws and the
dropout masks) and a header (config name, vocabulary size, compute dtype)
that `restore` checks.  Restoring all of it makes a resumed run the same
run: the schedules are functions of the step, and the draws continue from
the saved generator state.  A file is written under a temporary name and
then renamed, so a crash never leaves a half-written file as the latest.

Data parallel (`axis`): rank 0 writes and the other ranks wait at a
barrier until the file is there; every rank restores from the same file.
Every tensor of the state is replicated over the data axis.  Under a model
axis every rank gathers the full tensors of its shards (parameters, EMA
copies, Adam's moments; `parallel/rules.py`) over its model group before
rank 0 writes, and on restore each rank reads the full file and keeps its
slices.  So the file always holds the whole state, in one format, and a
snapshot of any mesh restores bit-equal into any other (the counterpart of
`tests/test_cross_topology_ckpt.py`).
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

import torch

from dwcgan_tpu_torch.parallel.mesh import DataAxis, barrier
from dwcgan_tpu_torch.parallel.rules import (full_optimizer_state, full_state_dict,
                                             local_optimizer_state, local_state_dict)
from dwcgan_tpu_torch.train.state import TrainState

_NAME = re.compile(r"^ckpt_(\d{8,})\.pt$")


def checkpoint_header(cfg, vocab_size: int, config: Optional[str] = None) -> Dict:
    """What `restore` checks: a checkpoint of another vocabulary or compute
    dtype (or, when given, another config name) is refused."""
    return {"config": config, "vocab_size": int(vocab_size),
            "compute_dtype": cfg.compute_dtype}


def checkpoint_steps(directory: str) -> List[int]:
    """The steps of the complete checkpoint files in `directory`, oldest
    first (a temporary file of an unfinished save is not one)."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(directory))
                  if m)


def checkpoint_file(path: str, step: Optional[int] = None) -> str:
    """A checkpoint file, or the file of `step` (default: the latest) in a
    checkpoint directory."""
    if os.path.isfile(path):
        return path
    steps = checkpoint_steps(path)
    if not steps:
        raise FileNotFoundError(f"no checkpoint under {path}")
    step = steps[-1] if step is None else step
    if step not in steps:
        raise FileNotFoundError(f"no checkpoint of step {step} under {path} "
                                f"(steps {steps})")
    return os.path.join(path, f"ckpt_{step:08d}.pt")


def read_checkpoint(path: str, map_location="cpu",
                    header: Optional[Dict] = None) -> Dict:
    """The saved dict, its tensors on `map_location`; raises if a value of
    `header` that is not None differs from the saved header's."""
    ckpt = torch.load(path, map_location=map_location, weights_only=True)
    bad = {k: (ckpt["header"].get(k), v) for k, v in (header or {}).items()
           if v is not None and ckpt["header"].get(k) != v}
    if bad:
        raise ValueError(f"checkpoint {path} does not fit this run: "
                         f"(saved, expected) {bad}")
    return ckpt


def _load_optimizer(opt: torch.optim.Optimizer, saved: Dict) -> None:
    """`load_state_dict`, with Adam's step counts back on the host where
    Adam keeps them (unless capturable or fused): `map_location` moved
    them to the device with the moments."""
    opt.load_state_dict(saved)
    for group in opt.param_groups:
        if group.get("capturable") or group.get("fused"):
            continue
        for p in group["params"]:
            st = opt.state.get(p, {})
            if "step" in st:
                st["step"] = st["step"].cpu()


def state_payload(state: TrainState, header: Dict) -> Dict:
    """What a checkpoint file holds: the full tensors of every net and
    optimizer (gathered over the model group where they are sharded: a
    collective on every rank of it), the step and the generator state."""
    return {
        "header": header, "step": int(state.step),
        **{name: full_state_dict(getattr(state, name))
           for name in ("gen", "dis", "ema_gen", "ema_dis")},
        "gen_opt": full_optimizer_state(state.gen_opt, state.gen),
        "dis_opt": full_optimizer_state(state.dis_opt, state.dis),
        "rng": state.rng.get_state(),
    }


class CheckpointManager:
    """Saves and restores the `TrainState` in `directory`, keeping the
    newest `max_to_keep` files; `axis`: the data axis of a data-parallel
    run (rank 0 writes)."""

    def __init__(self, directory: str, max_to_keep: int = 5,
                 header: Optional[Dict] = None, axis: Optional[DataAxis] = None):
        self.directory = directory
        self.max_to_keep = max_to_keep
        self.header = dict(header or {})
        self.axis = axis

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}.pt")

    def latest_step(self) -> Optional[int]:
        steps = checkpoint_steps(self.directory)
        return steps[-1] if steps else None

    def save(self, state: TrainState) -> str:
        """Write the state at `state.step` (rank 0 of the mesh writes, every
        rank takes part in gathering the shards, the others wait for the
        file); returns the file's path."""
        final = self.path(state.step)
        payload = state_payload(state, self.header)
        if self.axis is None or self.axis.rank == 0:
            self._write(payload, final)
        barrier(self.axis)
        return final

    def _write(self, payload: Dict, final: str) -> None:
        os.makedirs(self.directory, exist_ok=True)
        tmp = final + ".tmp"
        with open(tmp, "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
        for old in checkpoint_steps(self.directory)[:-self.max_to_keep]:
            os.remove(self.path(old))

    def restore(self, template: TrainState,
                step: Optional[int] = None) -> TrainState:
        """Load the checkpoint of `step` (default: the latest) into
        `template`, in place, onto its device; returns it."""
        dev = next(template.gen.parameters()).device
        ckpt = read_checkpoint(checkpoint_file(self.directory, step),
                               map_location=dev, header=self.header)
        for name in ("gen", "dis", "ema_gen", "ema_dis"):
            net = getattr(template, name)
            net.load_state_dict(local_state_dict(net, ckpt[name]))
        for name, net in (("gen_opt", template.gen), ("dis_opt", template.dis)):
            opt = getattr(template, name)
            _load_optimizer(opt, local_optimizer_state(opt, net, ckpt[name]))
        template.step = ckpt["step"]
        template.rng.set_state(ckpt["rng"].cpu())
        return template


def warm_start(state: TrainState, pretrain: str,
               skip_substrings=("embed_tokens",)) -> TrainState:
    """Partial warm start from another run's checkpoint (file or
    directory, the latest step), as the reference's `init_network`
    (solver.py:383-400): copy every generator and discriminator parameter
    whose name and shape match, except the word embedding; the EMA copies,
    the optimizers and the step stay as they were.  The donor's header is
    not checked, so a run with another vocabulary still lends the rest."""
    dev = next(state.gen.parameters()).device
    donor = read_checkpoint(checkpoint_file(pretrain), map_location=dev)
    with torch.no_grad():
        for module, saved in ((state.gen, donor["gen"]), (state.dis, donor["dis"])):
            saved = local_state_dict(module, saved)
            for name, p in module.named_parameters():
                new = saved.get(name)
                if any(s in name for s in skip_substrings) or new is None \
                        or new.shape != p.shape:
                    continue
                p.copy_(new)
    return state
