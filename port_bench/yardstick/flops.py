"""Floating-point operations of a served batch and of a training step,
counted from the plain reference at the cell's shapes on the meta device
(`torch.utils.flop_counter`: convolutions and matrix products, forward and
backward, as the graph needs them; no recomputation), per image.

The text encoder's loop runs `LSTM_STEPS` steps in the count (a command
of the traffic is 10 to 40 tokens with its markers; the loop's products
are under 0.1% of either count, so the choice moves neither).  The
spectral norm's power iteration is matrix-vector work the counter does not
count.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench.reference.nets import Generator, Ops, translate
from port_bench.reference.params import (dis_specs, frozen_names, gen_specs,
                                         vgg_specs)
from port_bench.reference.step import Trainer

LSTM_STEPS = 24


def _meta(specs):
    return {name: torch.empty(shape, device="meta") for name, shape, _ in specs}


def _inputs(cfg: dict, batch: int):
    hw = cfg["image_size"]
    images = torch.empty(batch, hw, hw, cfg["input_dim"], device="meta")
    tokens = torch.zeros(batch, cfg["max_text_len"] + 2, dtype=torch.long, device="meta")
    lengths = torch.full((batch,), LSTM_STEPS, dtype=torch.long)
    return images, tokens, lengths


def serve_flops_per_image(cfg: dict, vocab_size: int, batch: int) -> float:
    """`translate` (encode, text-encode, decode) over `batch` images."""
    gen = Generator(cfg, _meta(gen_specs(cfg, vocab_size)), Ops())
    images, tokens, lengths = _inputs(cfg, batch)
    with FlopCounterMode(display=False) as count:
        translate(gen, images, tokens, lengths)
    return count.get_total_flops() / batch


def train_flops_per_image(cfg: dict, vocab_size: int, batch: int) -> float:
    """One reference training step (dropout off) over `batch` images."""
    specs = gen_specs(cfg, vocab_size)
    trainer = Trainer(cfg, _meta(specs), _meta(dis_specs(cfg)), _meta(vgg_specs()),
                      frozen_names(specs), None, Ops())
    images, tokens, lengths = _inputs(cfg, batch)
    labels = torch.zeros(batch, cfg["gen"]["num_cls"], device="meta")
    with FlopCounterMode(display=False) as count:
        trainer.step(images, labels, labels, tokens, lengths)
    return count.get_total_flops() / batch
