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
loop stops at the longest length in the batch, which the caller gives on
the host (on the card it is read back once otherwise).  Parameter names are
`nn.LSTM`'s (`weight_ih_l0`, `weight_hh_l0_reverse`, ...), as in the
reference model; the bias is `bias_ih + bias_hh` (the JAX LSTM has one).
Inter-layer dropout draws its mask from the `rng` generator it is given.

Under a model axis (`parallel/rules.py`) `weight_ih_l*` and `weight_hh_l*`
hold this rank's slice of the 4H fused gates: the input projection is
computed on the slice and gathered once a layer, `h @ w_hh` on the slice
and gathered every step before the gate nonlinearities; the biases, `h`,
`c` and the dropout masks are whole on every rank.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from dwcgan_tpu_torch.ops.blocks import dropout, sigmoid
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


class MaskedBiLSTM(nn.LSTM):

    def __init__(self, input_size: int, hidden: int, num_layers: int = 1,
                 dropout: float = 0.0):
        super().__init__(input_size, hidden, num_layers=num_layers,
                         bidirectional=True, batch_first=True,
                         dropout=dropout if num_layers > 1 else 0.0)

    def flatten_parameters(self) -> None:
        """Nothing: the recurrence is the loop below, never cuDNN's, so the
        weights (this rank's gate slices under a model axis) are never
        packed into cuDNN's buffer (`nn.LSTM` calls this on `to` and on a
        deep copy)."""

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
        the host.  The inter-layer dropout's mask is drawn from `rng` at the
        full length T (`rows`: this rank's rows of the global batch's).

        Returns (outputs [B, T, 2H], zero past each length; final h and c,
        each [num_layers, 2, B, H] with dim 1 the direction: 0 fwd, 1 bwd).
        """
        lens_host = lengths.cpu()
        steps = int(lens_host.max())
        lmin = int(lens_host.min())
        lengths = lengths.to(x.device, torch.int64)
        total = x.shape[1]
        out = x[:, :steps]
        hs, cs = [], []
        for layer in range(self.num_layers):
            if layer:
                out = dropout(out, self.dropout, self.training, rng, rows,
                              length=total)
            out, h, c = self._layer(out, lengths, layer, lmin)
            hs.append(h)
            cs.append(c)
        if steps < total:
            out = torch.cat([out, out.new_zeros(out.shape[0], total - steps,
                                                out.shape[2])], 1)
        return out, torch.stack(hs), torch.stack(cs)
