"""Recurrent cells (LSTM, GRU) and the masked BiLSTM (counterpart of
``msa_tts_tpu/ops/rnn.py``).

Parameters keep the torch layout (``weight_ih`` (4H, in), gates ordered
i, f, g, o), so ``nn.LSTMCell`` and ``nn.LSTM`` hold them under the
reference's keys.  The BiLSTM runs ``nn.LSTM`` over a packed sequence,
which gives the semantics the JAX package reproduces by carry masking:
the reverse direction starts at each row's last valid step and outputs
at padded positions are zero.  Under :func:`twice_differentiable` it
runs as that masked scan in plain tensor ops instead, whose backward can
itself be differentiated (second-order meta-learning): cuDNN's RNN
backward, which ``nn.LSTM`` takes on a GPU, cannot.  Under
``parallel.tp.tp_products`` the gates are partitioned products joined
before they split, and the BiLSTM is the masked scan (``nn.LSTM`` cannot
take sharded weights).
"""

from __future__ import annotations

import contextlib
import contextvars
import math

import torch
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from .nn import _TP, uniform_


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
    tp = _TP.get()
    if tp is not None:
        gates = tp.lstm_gates(cell, x, h)
    else:
        gates = (
            x @ cell.weight_ih.T + h @ cell.weight_hh.T
            + cell.bias_ih + cell.bias_hh
        )
    i, f, g, o = gates.chunk(4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    c_new = f * c + i * torch.tanh(g)
    return o * torch.tanh(c_new), c_new


_TWICE = contextvars.ContextVar("twice_differentiable", default=False)


@contextlib.contextmanager
def twice_differentiable():
    """Within this context (of the calling thread only), :func:`bilstm`
    runs as a masked scan of plain tensor ops, so that the backward of a
    forward run here can be differentiated again."""
    token = _TWICE.set(True)
    try:
        yield
    finally:
        _TWICE.reset(token)


def _masked_lstm_scan(lstm: nn.LSTM, x, lengths, suffix: str):
    """One direction of :func:`bilstm` as the JAX package writes it: the
    input projection hoisted, then a step loop whose carry moves only at
    valid positions (blended by the 0/1 validity), outputs zero at
    padded ones; ``suffix`` ``""`` forward, ``"_reverse"`` backward."""
    B, T, _ = x.shape
    tp = _TP.get()
    if tp is not None:
        gates = tp.lstm_scan_gates(lstm, x, suffix)
    else:
        w_ih, w_hh, b_ih, b_hh = (getattr(lstm, f"{n}_l0{suffix}")
                                  for n in ("weight_ih", "weight_hh",
                                            "bias_ih", "bias_hh"))
        x_proj = x @ w_ih.T + b_ih + b_hh                  # (B, T, 4H)

        def gates(t, h):
            return x_proj[:, t] + h @ w_hh.T
    valid = (torch.arange(T, device=x.device)[None, :]
             < lengths.to(x.device)[:, None]).to(x.dtype)  # (B, T)
    h = c = x.new_zeros(B, lstm.hidden_size)
    out = [None] * T
    for t in (range(T - 1, -1, -1) if suffix else range(T)):
        i, f, g, o = gates(t, h).chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        v = valid[:, t, None]
        h = v * h_new + (1.0 - v) * h
        c = v * c_new + (1.0 - v) * c
        out[t] = h_new * v
    return torch.stack(out, dim=1)


def bilstm(lstm: nn.LSTM, x, lengths):
    """Bidirectional masked LSTM: (B, T, D) → (B, T, 2H), zeros at
    padded positions.  ``lstm`` is a one-layer, batch-first,
    bidirectional ``nn.LSTM``."""
    if _TWICE.get() or _TP.get() is not None:
        return torch.cat([_masked_lstm_scan(lstm, x, lengths, ""),
                          _masked_lstm_scan(lstm, x, lengths, "_reverse")],
                         dim=-1)
    T = x.shape[1]
    packed = pack_padded_sequence(
        x, lengths.to("cpu", torch.int64), batch_first=True,
        enforce_sorted=False,
    )
    out, _ = lstm(packed)
    out, _ = pad_packed_sequence(out, batch_first=True, total_length=T)
    return out


# ------------------------------------------------------------------- GRU

@torch.no_grad()
def init_gru_(module: nn.Module, generator: torch.Generator):
    """U(±1/√H) on every weight and bias of an ``nn.GRU(Cell)``, the
    JAX package's ``init_gru_cell`` distribution."""
    return init_lstm_(module, generator)


def _gru_update(gi, gh, h):
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h


def gru_cell(weight_ih, weight_hh, bias_ih, bias_hh, x, h):
    """One GRU step (torch gate order r, z, n).  ``x``: (B, in);
    ``h``: (B, H); weights in the torch (3H, in) layout."""
    return _gru_update(x @ weight_ih.T + bias_ih,
                       h @ weight_hh.T + bias_hh, h)


def gru(rnn: nn.GRU, x, h0=None):
    """Unidirectional GRU over (B, T, D) → (B, T, H) with one hoisted
    input projection, written out step by step as the JAX package's
    scan is.  ``rnn`` is a one-layer ``nn.GRU`` (its ``*_l0`` weights)."""
    B, T, _ = x.shape
    gi = x @ rnn.weight_ih_l0.T + rnn.bias_ih_l0           # (B, T, 3H)
    h = h0 if h0 is not None else x.new_zeros(B, rnn.hidden_size)
    outs = []
    for t in range(T):
        gh = h @ rnn.weight_hh_l0.T + rnn.bias_hh_l0
        h = _gru_update(gi[:, t], gh, h)
        outs.append(h)
    return torch.stack(outs, dim=1)
