"""Masked multi-layer bidirectional LSTM (the counterpart of
`dwcgan_tpu/ops/lstm.py::MaskedBiLSTM`, lstm.py:157-196, with its fused
directions `_LSTMBiFused`, lstm.py:92-154).

It computes in the dtype of its input, as the JAX LSTM computes in its
compute dtype: the input projection, the recurrence and `h`, `c` are all in
that dtype, with the fp32 parameters cast where they are used.  The
recurrence is a loop of torch ops that rounds where the JAX scan rounds: each
matrix product, the bias add, the gate add, and every elementwise op of the
cell, with the sigmoid formed as 1 / (1 + exp(-x)), which is how XLA expands
it, and differentiated by JAX's rule (`ops/blocks.py::sigmoid`).  (`nn.LSTM`'s fused bf16 cell rounds only its outputs, and lands as far
from the JAX bf16 result as an fp32 run does; in fp32 the two agree.)

Both directions run as one recurrence at doubled batch: the forward stream
and the length-reversed stream stacked along the batch axis, one batched
product per step.  Each sequence runs over its own length: past it the
carry is frozen and the output is zero, the packed-sequence semantics.  The
loop stops at the longest length in the batch, read from lengths the
caller gives on the host (on the card they are read back once otherwise).
On the kernel route, lengths already on the card (a CUDA graph of the
training step, where nothing may be read back) are not read: every step of
the input's width runs, masked throughout, and the recurrence kernels stop
at their rows' longest length there.  Parameter names are
`nn.LSTM`'s (`weight_ih_l0`, `weight_hh_l0_reverse`, ...), as in the
reference model; the bias is `bias_ih + bias_hh` (the JAX LSTM has one).
Inter-layer dropout draws its mask from the `rng` generator it is given.

Under a model axis (`parallel/rules.py`) `weight_ih_l*` and `weight_hh_l*`
hold this rank's slice of the 4H fused gates: the input projection is
computed on the slice and gathered once a layer, `h @ w_hh` on the slice
and gathered every step before the gate nonlinearities; the biases, `h`,
`c` and the dropout masks are whole on every rank.

The route follows what the call can observe (`MaskedBiLSTM.kernel_route`):
on a CUDA tensor without a model axis each layer is one product for both
directions' input projections and one launch of the recurrence kernel
(`ops/cuda/kernels.py::lstm`, `csrc/lstm_kernels.cu`), whose backward is
one launch of `lstm_bwd` and one product for w_hh's gradient
(`recurrent_weight_grad`); it rounds where the loop rounds, but for the
order of the recurrent product's sums, and takes each gradient's sum over
the steps in fp32 with one rounding.  On the CPU, and under a model axis,
the loop runs.  `recurrence_plain` and `recurrence_plain_bwd` are the
kernels' contract in torch ops, for the tests.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from dwcgan_tpu_torch.ops.blocks import dropout, sigmoid
from dwcgan_tpu_torch.ops.cuda import kernels
from dwcgan_tpu_torch.parallel.tensor import copy, gather, module_group


def reverse_padded(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Reverse the valid prefix of each padded sequence: out[b, t] =
    x[b, len_b - 1 - t] for t < len_b, zero past it.  x: [B, T, D]."""
    t = torch.arange(x.shape[1], device=x.device)
    idx = lengths[:, None] - 1 - t[None, :]
    valid = idx >= 0
    idx = idx.clamp(0, x.shape[1] - 1)
    out = torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[2]))
    return torch.where(valid[..., None], out, 0.0)


def _steps_valid(lengths: torch.Tensor, steps: int) -> torch.Tensor:
    """[steps, B, 1]: whether each row still runs at each step."""
    t = torch.arange(steps, device=lengths.device)
    return (t[:, None] < lengths[None, :])[..., None]


def _by_step(x: torch.Tensor, lengths: torch.Tensor, width: int) -> torch.Tensor:
    """[B, T, 2 * width] by position -> [T, 2, B, width] by step: the
    reverse direction's half read in its own valid prefix reversed."""
    return torch.stack([x[..., :width], reverse_padded(x[..., width:], lengths)]
                       ).permute(2, 0, 1, 3)


def _by_position(y: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """`_by_step`'s inverse: [T, 2, B, width] -> [B, T, 2 * width]."""
    y = y.permute(1, 2, 0, 3)
    return torch.cat([y[0], reverse_padded(y[1], lengths)], -1)


def recurrence_plain(proj: torch.Tensor, w_hh: torch.Tensor,
                     lengths: torch.Tensor, save: bool = False):
    """`kernels.lstm` in torch ops, with its arguments and results: the
    loop's cell on proj [B, T, 8H] (the reverse direction's gates at the
    forward input's positions) and w_hh [2, 4H, H]."""
    b, steps, _ = proj.shape
    hid = w_hh.shape[2]
    lengths = lengths.long()
    valid = _steps_valid(lengths, steps)
    xs = _by_step(proj, lengths, 4 * hid)
    w = w_hh.transpose(1, 2)
    h = proj.new_zeros(2, b, hid)
    c = torch.zeros_like(h)
    outs, acts, cs = [], [], []
    for t in range(steps):
        gates = xs[t] + torch.bmm(h, w)
        i, f, _, o = sigmoid(gates).chunk(4, -1)
        g = torch.tanh(gates[..., 2 * hid:3 * hid])
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        h = torch.where(valid[t], h_new, h)
        c = torch.where(valid[t], c_new, c)
        outs.append(torch.where(valid[t], h_new, 0.0))
        acts.append(torch.cat([i, f, g, o], -1))
        cs.append(c_new)
    out = _by_position(torch.stack(outs), lengths)
    if not save:
        return out, h, c, None, None
    return out, h, c, torch.stack(acts, 1), torch.stack(cs, 1)


def recurrence_plain_bwd(w_hh: torch.Tensor, lengths: torch.Tensor,
                         acts: torch.Tensor, cs: torch.Tensor, d_out=None,
                         d_h=None, d_c=None) -> torch.Tensor:
    """`kernels.lstm_bwd` in torch ops: proj's gradient [B, T, 8H] by the
    loop's autograd rules (the sigmoid's JAX rule, torch's tanh_backward),
    each op rounded, the recurrent product's sum rounded once."""
    _, steps, b, g4 = acts.shape
    hid = g4 // 4
    lengths = lengths.long()
    valid = _steps_valid(lengths, steps)
    zeros = acts.new_zeros(2, b, hid)
    go = (acts.new_zeros(steps, 2, b, hid) if d_out is None
          else _by_step(d_out, lengths, hid))
    dh = zeros if d_h is None else d_h
    dc = zeros if d_c is None else d_c
    tanh_bwd = torch.ops.aten.tanh_backward
    sig_bwd = lambda g, s: g * (s * (1 - s))
    grads = [None] * steps
    for t in reversed(range(steps)):
        i, f, g, o = acts[:, t].chunk(4, -1)
        c_prev = cs[:, t - 1] if t else zeros
        tc = torch.tanh(cs[:, t])
        gh = go[t] + dh
        d_o = gh * tc
        dcs = tanh_bwd(gh * o, tc) + dc
        dg = torch.cat([sig_bwd(dcs * g, i), sig_bwd(dcs * c_prev, f),
                        tanh_bwd(dcs * i, g), sig_bwd(d_o, o)], -1)
        grads[t] = dg = torch.where(valid[t], dg, 0.0)
        dc = torch.where(valid[t], dcs * f, dc)
        dh = torch.where(valid[t], torch.bmm(dg, w_hh), dh)
    return _by_position(torch.stack(grads), lengths)


def recurrent_weight_grad(dproj: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """w_hh's gradient [2, 4H, H] from the recurrence's gate gradients dproj
    [B, T, 8H] and outputs out [B, T, 2H]: per direction the sum over every
    (row, step) of dgates x h_{step-1}, in fp32, rounded once.  h_{step-1}
    at position t is the forward direction's output at t - 1 and the
    reverse direction's at t + 1 (zero at a row's last position, where its
    output is zero already)."""
    hid = out.shape[2] // 2
    prev = torch.stack([F.pad(out[:, :-1, :hid], (0, 0, 1, 0)),
                        F.pad(out[:, 1:, hid:], (0, 0, 0, 1))])       # [2, B, T, H]
    dg = dproj.unflatten(2, (2, 4 * hid)).permute(2, 3, 0, 1)          # [2, 4H, B, T]
    return torch.bmm(dg.reshape(2, 4 * hid, -1).float(),
                     prev.reshape(2, -1, hid).float()).to(out.dtype)


class _Recurrence(torch.autograd.Function):
    """One layer's recurrence on the card: `kernels.lstm`, saving what
    `kernels.lstm_bwd` needs; w_hh's gradient is `recurrent_weight_grad`."""

    @staticmethod
    def forward(ctx, proj, w_hh, lengths):
        ctx.set_materialize_grads(False)
        out, h, c, acts, cs = kernels.lstm(proj, w_hh, lengths, save=True)
        ctx.save_for_backward(w_hh, lengths, acts, cs, out)
        return out, h, c

    @staticmethod
    def backward(ctx, d_out, d_h, d_c):
        w_hh, lengths, acts, cs, out = ctx.saved_tensors
        grads = [None if g is None else g.contiguous() for g in (d_out, d_h, d_c)]
        dproj = kernels.lstm_bwd(w_hh, lengths, acts, cs, *grads)
        return dproj, recurrent_weight_grad(dproj, out), None


class MaskedBiLSTM(nn.LSTM):

    def __init__(self, input_size: int, hidden: int, num_layers: int = 1,
                 dropout: float = 0.0):
        super().__init__(input_size, hidden, num_layers=num_layers,
                         bidirectional=True, batch_first=True,
                         dropout=dropout if num_layers > 1 else 0.0)

    def flatten_parameters(self) -> None:
        """Nothing: the recurrence is the port's own (the kernels or the
        loop below), never cuDNN's, so the weights (this rank's gate slices
        under a model axis) are never packed into cuDNN's buffer (`nn.LSTM`
        calls this on `to` and on a deep copy)."""

    def kernel_route(self, device) -> bool:
        """Whether a call on `device` runs the recurrence kernels: a CUDA
        device and no model axis.  (On the CPU the loop is the JAX scan's
        arithmetic; under a model axis it keeps its per-step gather.)"""
        return torch.device(device).type == "cuda" and module_group(self) is None

    def _layer_kernel(self, x: torch.Tensor, lengths: torch.Tensor, layer: int):
        """One layer on the card, both directions: (outputs [B, T, 2H], h, c
        [2, B, H]).  Both input projections are one product; the recurrence
        is one launch (`_Recurrence` where a gradient is wanted)."""
        cd = x.dtype
        params = lambda name: [getattr(self, f"{name}_l{layer}{s}")
                               for s in ("", "_reverse")]
        w_ih = torch.cat(params("weight_ih")).to(cd)                  # [8H, D]
        bias = (torch.cat(params("bias_ih")) + torch.cat(params("bias_hh"))).to(cd)
        proj = x @ w_ih.t() + bias                                    # [B, T, 8H]
        w_hh = torch.stack(params("weight_hh")).to(cd)                # [2, 4H, H]
        if torch.is_grad_enabled() and (proj.requires_grad or w_hh.requires_grad):
            return _Recurrence.apply(proj, w_hh, lengths)
        return kernels.lstm(proj, w_hh, lengths)[:3]

    def _layer(self, x: torch.Tensor, lengths: torch.Tensor, layer: int,
               lmin: int):
        """One layer, both directions: (outputs [B, T, 2H], h, c [2, B, H]).
        Everything per step is [2, B, ...] (direction first), so the step
        issues no reshapes, only the cell's own ops."""
        b, steps, _ = x.shape
        cd = x.dtype
        sfx = ("", "_reverse")
        w_ih = [getattr(self, f"weight_ih_l{layer}{s}").to(cd) for s in sfx]
        w_hh = torch.stack([getattr(self, f"weight_hh_l{layer}{s}").t()
                            for s in sfx]).to(cd)                 # [2, H, 4H]
        bias = [(getattr(self, f"bias_ih_l{layer}{s}")
                 + getattr(self, f"bias_hh_l{layer}{s}")).to(cd) for s in sfx]
        rev = reverse_padded(x, lengths)
        mg = module_group(self)
        if mg is None:
            proj = torch.stack([x @ w_ih[0].t() + bias[0],
                                rev @ w_ih[1].t() + bias[1]])     # [2, B, T, 4H]
        else:
            # this rank's gates of both directions, gathered once
            xs = copy(torch.stack([x, rev]), mg)
            proj = gather(torch.stack([xs[0] @ w_ih[0].t(), xs[1] @ w_ih[1].t()]),
                          -1, mg) + torch.stack(bias)[:, None, None]

        def recur(h):
            """h @ w_hh [2, B, 4H]; under a model axis this rank's gates,
            gathered before the nonlinearities (the regather GSPMD puts in
            the JAX scan, dwcgan_tpu/parallel/mesh.py:47-51)."""
            if mg is None:
                return torch.bmm(h, w_hh)
            return gather(torch.bmm(copy(h, mg), w_hh), -1, mg)

        proj_t = proj.unbind(2)
        valid = (torch.arange(steps, device=x.device)[:, None]
                 < lengths[None, :])[:, None, :, None].unbind(0)  # T x [1, B, 1]
        hid = self.hidden_size
        h = torch.zeros(2, b, hid, dtype=cd, device=x.device)
        c = torch.zeros_like(h)
        outs = []
        for t in range(steps):
            gates = proj_t[t] + recur(h)
            i, f, _, o = sigmoid(gates).chunk(4, -1)
            c_new = f * c + i * torch.tanh(gates[..., 2 * hid:3 * hid])
            h_new = o * torch.tanh(c_new)
            if t < lmin:          # every sequence is still running
                h, c = h_new, c_new
                outs.append(h_new)
            else:
                h = torch.where(valid[t], h_new, h)
                c = torch.where(valid[t], c_new, c)
                outs.append(torch.where(valid[t], h_new, 0.0))
        y = torch.stack(outs, 2)                                  # [2, B, T, H]
        out = torch.cat([y[0], reverse_padded(y[1], lengths)], -1)
        return out, h, c

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                rng: Optional[torch.Generator] = None, rows=None):
        """x: [B, T, D] in the compute dtype; lengths: [B] (>= 1), best on
        the host (on the kernel route, lengths on x's device run all T
        steps without a read back; module docstring).  The inter-layer
        dropout's mask is drawn from `rng` at the full length T (`rows`:
        this rank's rows of the global batch's).

        Returns (outputs [B, T, 2H], zero past each length; final h and c,
        each [num_layers, 2, B, H] with dim 1 the direction: 0 fwd, 1 bwd).
        """
        route = self.kernel_route(x.device)
        total = x.shape[1]
        if route and lengths.device == x.device:
            steps, lmin = total, 0
        else:
            lens_host = lengths.cpu()
            steps, lmin = int(lens_host.max()), int(lens_host.min())
        lengths = lengths.to(x.device, torch.int32 if route else torch.int64)
        out = x[:, :steps]
        hs, cs = [], []
        for layer in range(self.num_layers):
            if layer:
                out = dropout(out, self.dropout, self.training, rng, rows,
                              length=total)
            out, h, c = (self._layer_kernel(out, lengths, layer) if route
                         else self._layer(out, lengths, layer, lmin))
            hs.append(h)
            cs.append(c)
        if steps < total:
            out = torch.cat([out, out.new_zeros(out.shape[0], total - steps,
                                                out.shape[2])], 1)
        return out, torch.stack(hs), torch.stack(cs)
