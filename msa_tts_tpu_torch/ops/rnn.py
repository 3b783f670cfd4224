"""Recurrent cells and the masked BiLSTM (counterpart of
``msa_tts_tpu/ops/rnn.py``).

Parameters keep the torch layout (``weight_ih`` (4H, in), gates ordered
i, f, g, o), so ``nn.LSTMCell`` and ``nn.LSTM`` hold them under the
reference's keys.  The BiLSTM runs ``nn.LSTM`` over a packed sequence,
which gives the semantics the JAX package reproduces by carry masking:
the reverse direction starts at each row's last valid step and outputs
at padded positions are zero.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from .nn import uniform_


@torch.no_grad()
def init_lstm_(module: nn.Module, generator: torch.Generator):
    """U(±1/√H) on every weight and bias of an ``nn.LSTM(Cell)``."""
    a = 1.0 / math.sqrt(module.hidden_size)
    for p in module.parameters():
        uniform_(p, a, generator)
    return module


def lstm_cell(cell: nn.LSTMCell, x, hc):
    """One LSTM step. ``x``: (B, in); ``hc``: ((B, H), (B, H))."""
    h, c = hc
    gates = (
        x @ cell.weight_ih.T + h @ cell.weight_hh.T
        + cell.bias_ih + cell.bias_hh
    )
    i, f, g, o = gates.chunk(4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    c_new = f * c + i * torch.tanh(g)
    return o * torch.tanh(c_new), c_new


def bilstm(lstm: nn.LSTM, x, lengths):
    """Bidirectional masked LSTM: (B, T, D) → (B, T, 2H), zeros at
    padded positions.  ``lstm`` is a one-layer, batch-first,
    bidirectional ``nn.LSTM``."""
    T = x.shape[1]
    packed = pack_padded_sequence(
        x, lengths.to("cpu", torch.int64), batch_first=True,
        enforce_sorted=False,
    )
    out, _ = lstm(packed)
    out, _ = pad_packed_sequence(out, batch_first=True, total_length=T)
    return out
