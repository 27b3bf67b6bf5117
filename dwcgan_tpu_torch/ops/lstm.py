"""Masked multi-layer bidirectional LSTM (the counterpart of
`dwcgan_tpu/ops/lstm.py::MaskedBiLSTM`, lstm.py:157-196).

`nn.LSTM(bidirectional=True)` over a packed sequence: each sequence runs
only over its own length, the backward direction over its reversed valid
prefix, which is what the JAX masked scan computes (that scan is pinned
bit-equal to the packed torch LSTM, docs/PARITY.md C11).  Parameter names
are nn.LSTM's (`weight_ih_l0`, `weight_hh_l0_reverse`, ...), as in the
reference model.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence


class MaskedBiLSTM(nn.LSTM):

    def __init__(self, input_size: int, hidden: int, num_layers: int = 1,
                 dropout: float = 0.0):
        super().__init__(input_size, hidden, num_layers=num_layers,
                         bidirectional=True, batch_first=True,
                         dropout=dropout if num_layers > 1 else 0.0)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor):
        """x: [B, T, D]; lengths: [B] (>= 1).

        Returns (outputs [B, T, 2H], zero past each length; final h and c,
        each [num_layers, 2, B, H] with dim 1 the direction: 0 fwd, 1 bwd).
        """
        packed = pack_padded_sequence(x, lengths.to("cpu", torch.int64),
                                      batch_first=True, enforce_sorted=False)
        out, (h, c) = super().forward(packed)
        out, _ = pad_packed_sequence(out, batch_first=True,
                                     total_length=x.shape[1])
        shape = (self.num_layers, 2) + tuple(h.shape[1:])
        return out, h.reshape(shape), c.reshape(shape)
