"""Faults planted under a cell's timed path, to show that `correct`
catches them (the CPU tests) and to read what they do to the compared
numbers at the cell's size (`calibrate.py --fault`).  Each wraps the
program's timed call as `core.Run.wrap` does.

- `unchanged`: the training step runs and reports its losses, but leaves
  the nets, their EMA copies and both optimizers as they were;
- `half_batch`: the training step sees only the first half of each batch,
  so every loss is a mean over the rest;
- `altered_answer`: the first image of every served batch comes back
  negated.
"""

from __future__ import annotations

import torch


def _tensors(state):
    out = []
    for net in (state.gen, state.dis, state.ema_gen, state.ema_dis):
        out += [p for p in net.parameters()]
    for opt in (state.gen_opt, state.dis_opt):
        for s in opt.state.values():
            out += [v for v in s.values() if torch.is_tensor(v)]
    return out


def unchanged(step):
    def faulty(state, batch, *args, **kw):
        before = {id(t): t.detach().clone() for t in _tensors(state)}
        had = {k: set(opt.state) for k, opt in (("g", state.gen_opt), ("d", state.dis_opt))}
        metrics = step(state, batch, *args, **kw)
        with torch.no_grad():
            for t in _tensors(state):
                if id(t) in before:
                    t.copy_(before[id(t)])
        for key, opt in (("g", state.gen_opt), ("d", state.dis_opt)):
            for p in list(opt.state):
                if p not in had[key]:
                    del opt.state[p]
        state.step -= 1
        return metrics
    return faulty


def half_batch(step):
    def faulty(state, batch, *args, **kw):
        n = batch.image.shape[0] // 2
        return step(state, type(batch)(*(t[:n] for t in batch)), *args, **kw)
    return faulty


def altered_answer(infer):
    def faulty(*args, **kw):
        out = infer(*args, **kw).clone()
        out[0] = -out[0]
        return out
    return faulty


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "altered_answer": altered_answer}
