"""The training state (the counterpart of `dwcgan_tpu/train/state.py`).

One object holds the generator and discriminator, their EMA copies, both
Adam optimizers, the global step and the random generators of the step.
The port updates parameters, moments and EMA copies in place.

Adam has *coupled* weight decay, `torch.optim.Adam(weight_decay=wd)`: wd *
param is added to the gradient before the moments (state.py:58-81).  The
learning rate is set from `lr(global step)` before each `step()`, so both
nets follow the iteration-indexed schedule whatever `n_critic` is.  Frozen
parameters are outside every optimizer: the LSTM's `bias_hh` always, the
word embedding when a pretrained table was given.  The frozen embedding
keeps `requires_grad`, so its gradient still counts in `grad_gen_norm` as
it does in the JAX step; it is just never applied.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from dwcgan_tpu_torch.config import Config
from dwcgan_tpu_torch.models.discriminator import MsImageDis, build_discriminator
from dwcgan_tpu_torch.models.generator import Generator, build_generator
from dwcgan_tpu_torch.parallel.rules import shard_

EMA_DECAY = 0.999


@dataclass
class TrainState:
    gen: Generator
    dis: MsImageDis
    ema_gen: Generator
    ema_dis: MsImageDis
    gen_opt: torch.optim.Adam
    dis_opt: torch.optim.Adam
    step: int
    rng: torch.Generator          # style draws and dropout masks, on the device


def trainable(module: nn.Module, frozen: tuple = ()) -> List[nn.Parameter]:
    """Parameters an optimizer updates: those that need grad, minus the
    names in `frozen`."""
    return [p for n, p in module.named_parameters()
            if p.requires_grad and n not in frozen]


def make_optimizer(cfg: Config, params) -> torch.optim.Adam:
    """Adam(beta1, beta2, eps 1e-8) with coupled weight decay; lr is set
    by the step."""
    return torch.optim.Adam(params, lr=cfg.lr, betas=(cfg.beta1, cfg.beta2),
                            eps=1e-8, weight_decay=cfg.weight_decay)


def frozen_gen_names(embed_table) -> tuple:
    return ("enc_txt.embed_tokens.weight",) if embed_table is not None else ()


def make_ema(module: nn.Module) -> nn.Module:
    """A frozen copy that `ema_update` keeps as the running average."""
    ema = copy.deepcopy(module).eval()
    ema.requires_grad_(False)
    return ema


@torch.no_grad()
def ema_update(ema: nn.Module, module: nn.Module, decay: float = EMA_DECAY):
    """ema = lerp(ema, param, 1 - decay) for every parameter
    (utils.py:52-54)."""
    for e, p in zip(ema.parameters(), module.parameters()):
        e.lerp_(p, 1.0 - decay)


def create_train_state(cfg: Config, vocab_size: int, device="cuda",
                       seed: Optional[int] = None,
                       embed_table: Optional[np.ndarray] = None,
                       axis=None) -> TrainState:
    """Models in train mode with random weights from `seed` (default
    `cfg.seed`), their EMA copies, both optimizers, step 0 and the step's
    generator, on `device` (the card unless the caller asks for the CPU).
    With a model axis (`axis.model_group`, `parallel/mesh.py`) the models
    are built whole and then keep this rank's shards
    (`parallel/rules.py::shard_`), before the optimizers and the EMA
    copies are made, so moments and EMA copies are shards too (JAX's
    `place_state`, dwcgan_tpu/parallel/mesh.py:151-176)."""
    seed = cfg.seed if seed is None else seed
    gen = build_generator(cfg, vocab_size, device=device, seed=seed,
                          train=True, embed_table=embed_table)
    dis = build_discriminator(cfg, device=device, seed=seed + 1)
    dis.train()
    mg = axis.model_group if axis is not None else None
    shard_(gen, mg)
    shard_(dis, mg)
    dev = next(gen.parameters()).device
    return TrainState(
        gen=gen, dis=dis, ema_gen=make_ema(gen), ema_dis=make_ema(dis),
        gen_opt=make_optimizer(cfg, trainable(gen, frozen_gen_names(embed_table))),
        dis_opt=make_optimizer(cfg, trainable(dis)),
        step=0, rng=torch.Generator(device=dev).manual_seed(seed + 2))
