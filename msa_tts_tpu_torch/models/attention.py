"""Attention for the Tacotron-2 decoder (counterpart of
``msa_tts_tpu/models/attention.py``), in plain PyTorch.

The modules hold the weights under the reference's keys; the step
functions are stateless and thread an explicit :class:`AttnState`, as
the JAX package does.  Two mechanisms:

  * ``ForwardAttention`` — location-sensitive attention with optional
    forward-attention recursion, transition agent, inference windowing
    and monotonic inference masking;
  * ``LSA`` — NVIDIA-style location-sensitive attention (the fixed
    variant the JAX package defines).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from ..ops import nn as N

MASK_VALUE = -1e30  # instead of -inf, as in the JAX package


class AttnState(NamedTuple):
    """Per-utterance attention state carried from step to step."""

    attention_weights: torch.Tensor      # (B, T_in) — α of previous step
    attention_weights_cum: torch.Tensor  # (B, T_in) — Σ alignments
    alpha: torch.Tensor                  # (B, T_in) — forward recursion
    u: torch.Tensor                      # (B, 1)    — transition agent
    win_idx: torch.Tensor                # (B,) int32 — window centre


def init_attn_state(batch: int, t_in: int, *, device,
                    dtype=torch.float32) -> AttnState:
    """α is 1 at t = 0 and 1e-7 elsewhere; u = 0.5."""
    alpha = torch.full((batch, t_in), 1e-7, dtype=dtype, device=device)
    alpha[:, 0] = 1.0
    return AttnState(
        attention_weights=torch.zeros(batch, t_in, dtype=dtype,
                                      device=device),
        attention_weights_cum=torch.zeros(batch, t_in, dtype=dtype,
                                          device=device),
        alpha=alpha,
        u=torch.full((batch, 1), 0.5, dtype=dtype, device=device),
        win_idx=torch.full((batch,), -1, dtype=torch.int32, device=device),
    )


# --------------------------------------------------------------------------
# Modules
# --------------------------------------------------------------------------

class LocationLayer(nn.Module):
    """ForwardAttention's location layer: ``location_conv1d`` (a plain
    ``nn.Conv1d``, no bias) and ``location_dense``."""

    def __init__(self, attention_dim: int, n_filters: int,
                 kernel_size: int, *, generator=None):
        super().__init__()
        self.location_conv1d = nn.Conv1d(
            2, n_filters, kernel_size, padding=(kernel_size - 1) // 2,
            bias=False,
        )
        self.location_dense = N.LinearNorm(
            n_filters, attention_dim, bias=False, w_init_gain="tanh",
            generator=generator,
        )
        if generator is not None:
            a = math.sqrt(6.0 / ((2 + n_filters) * kernel_size))
            N.uniform_(self.location_conv1d.weight, a, generator)

    @property
    def conv_weight(self):
        return self.location_conv1d.weight


class LSALocationLayer(nn.Module):
    """LSA's location layer: ``location_conv`` (a ``ConvNorm``) and
    ``location_dense``."""

    def __init__(self, attention_dim: int, n_filters: int,
                 kernel_size: int, *, generator=None):
        super().__init__()
        self.location_conv = N.ConvNorm(
            2, n_filters, kernel_size, bias=False, generator=generator,
        )
        self.location_dense = N.LinearNorm(
            n_filters, attention_dim, bias=False, w_init_gain="tanh",
            generator=generator,
        )

    @property
    def conv_weight(self):
        return self.location_conv.conv.weight


class ForwardAttention(nn.Module):
    def __init__(self, query_dim: int, embedding_dim: int,
                 attention_dim: int, *, location_attention: bool = True,
                 attention_location_n_filters: int = 32,
                 attention_location_kernel_size: int = 31,
                 trans_agent: bool = True, generator=None):
        super().__init__()
        self.query_layer = N.LinearNorm(
            query_dim, attention_dim, bias=False, w_init_gain="tanh",
            generator=generator,
        )
        self.inputs_layer = N.LinearNorm(
            embedding_dim, attention_dim, bias=False, w_init_gain="tanh",
            generator=generator,
        )
        self.v = N.LinearNorm(attention_dim, 1, bias=True,
                              generator=generator)
        if trans_agent:
            # a plain nn.Linear in the reference (default torch init)
            self.ta = nn.Linear(query_dim + embedding_dim, 1)
            if generator is not None:
                a = 1.0 / math.sqrt(query_dim + embedding_dim)
                N.uniform_(self.ta.weight, a, generator)
                N.uniform_(self.ta.bias, a, generator)
        if location_attention:
            self.location_layer = LocationLayer(
                attention_dim, attention_location_n_filters,
                attention_location_kernel_size, generator=generator,
            )


class LSA(nn.Module):
    def __init__(self, query_dim: int, embedding_dim: int,
                 attention_dim: int, n_filters: int, kernel_size: int, *,
                 generator=None):
        super().__init__()
        self.query_layer = N.LinearNorm(
            query_dim, attention_dim, bias=False, w_init_gain="tanh",
            generator=generator,
        )
        self.memory_layer = N.LinearNorm(
            embedding_dim, attention_dim, bias=False, w_init_gain="tanh",
            generator=generator,
        )
        self.v = N.LinearNorm(attention_dim, 1, bias=False,
                              generator=generator)
        self.location_layer = LSALocationLayer(
            attention_dim, n_filters, kernel_size, generator=generator,
        )


# --------------------------------------------------------------------------
# Application
# --------------------------------------------------------------------------

def preprocess_inputs(attn: ForwardAttention, inputs):
    """Project the encoder outputs once per utterance."""
    return attn.inputs_layer(inputs)


def preprocess_inputs_lsa(attn: LSA, inputs):
    return attn.memory_layer(inputs)


def _location_features(location_layer, state: AttnState, rnd=None):
    """The location convolution (float32) and its dense projection,
    whose input ``rnd`` rounds as the query's (see
    :func:`forward_attention`)."""
    attention_cat = torch.stack(
        [state.attention_weights, state.attention_weights_cum], dim=1
    )  # (B, 2, T)
    w = location_layer.conv_weight
    processed = N.conv1d(attention_cat, w, padding=(w.shape[-1] - 1) // 2)
    if rnd is not None:
        processed = rnd(processed)
    return location_layer.location_dense(processed.transpose(1, 2))


def _apply_windowing(attention, state: AttnState, *, win_back=2,
                     win_front=6):
    """The reference's inference-time attention window, per row."""
    T = attention.shape[1]
    pos = torch.arange(T, device=attention.device)[None, :]
    win = state.win_idx[:, None]
    first_step = win < 0
    window_mask = (pos >= win - win_back) & (pos < win + win_front)
    attention = torch.where(first_step | window_mask, attention,
                            MASK_VALUE)
    # "trick" on the first step: set position 0 to the max energy
    att0 = torch.where(
        first_step[:, 0], attention.max(dim=1).values, attention[:, 0]
    )
    attention = torch.cat([att0[:, None], attention[:, 1:]], dim=1)
    new_win_idx = attention.argmax(dim=1).to(torch.int32)
    return attention, new_win_idx


def _forward_attn_inference_mask(alpha, fwd_shifted_alpha):
    """Monotonic state masking: zero all states more than 3 ahead of the
    previous peak and all states before it, and leave a 0.01·max
    smoothing value two steps back."""
    T = alpha.shape[1]
    n = fwd_shifted_alpha.argmax(dim=1)[:, None]
    val = alpha.max(dim=1).values[:, None]
    pos = torch.arange(T, device=alpha.device)[None, :]
    out = torch.where(pos >= n + 3, 0.0, alpha)
    out = torch.where(pos < n - 1, 0.0, out)
    return torch.where(pos == n - 2, 0.01 * val, out)


def forward_attention(
    attn: ForwardAttention,
    query,
    inputs,
    processed_inputs,
    state: AttnState,
    mask=None,
    *,
    location_attention: bool = True,
    windowing: bool = False,
    norm: str = "softmax",
    forward_attn: bool = True,
    trans_agent: bool = True,
    forward_attn_mask: bool = False,
    training: bool = False,
    mask_energies: bool = False,
    rnd=None,
):
    """One attention step.

    Args:
      query: (B, query_dim) attention-RNN hidden state.
      inputs: (B, T_in, embedding_dim) encoder outputs (+ speaker cond.).
      processed_inputs: (B, T_in, attention_dim) from
        :func:`preprocess_inputs`.
      state: previous :class:`AttnState`.
      mask: optional (B, T_in) validity mask (True = valid).
      rnd: optional rounding of the inputs of the query projection, the
        location dense and the transition agent as those products see
        them (a bfloat16 decoder's, see ``decoder.compute_view``).

    Returns ``(context (B, D), alignment (B, T_in), new_state)``.
    """
    q_in = query if rnd is None else rnd(query)
    processed_query = attn.query_layer(q_in[:, None, :])
    if location_attention:
        pre = processed_query + _location_features(
            attn.location_layer, state, rnd
        ) + processed_inputs
    else:
        pre = processed_query + processed_inputs
    energies = attn.v(torch.tanh(pre))[..., 0]

    if mask_energies and mask is not None:
        energies = torch.where(mask, energies, MASK_VALUE)

    new_win_idx = state.win_idx
    if windowing and not training:
        energies, new_win_idx = _apply_windowing(energies, state)

    if norm == "softmax":
        alignment = torch.softmax(energies, dim=-1)
    elif norm == "sigmoid":
        sig = torch.sigmoid(energies)
        alignment = sig / sig.sum(dim=1, keepdim=True)
    else:
        raise ValueError(f"unknown attention norm: {norm}")

    new_cum = state.attention_weights_cum
    if location_attention:
        new_cum = new_cum + alignment

    new_alpha = state.alpha
    if forward_attn:
        fwd_shifted = torch.nn.functional.pad(state.alpha[:, :-1], (1, 0))
        alpha = (
            (1.0 - state.u) * state.alpha + state.u * fwd_shifted + 1e-8
        ) * alignment
        if forward_attn_mask and not training:
            alpha = _forward_attn_inference_mask(alpha, fwd_shifted)
        alignment = alpha / alpha.sum(dim=1, keepdim=True)
        new_alpha = alignment

    context = torch.einsum("bt,btd->bd", alignment, inputs)

    new_u = state.u
    if forward_attn and trans_agent:
        ta_in = torch.cat([context, query], dim=-1)
        new_u = torch.sigmoid(attn.ta(ta_in if rnd is None else rnd(ta_in)))

    new_state = AttnState(
        attention_weights=alignment,
        attention_weights_cum=new_cum,
        alpha=new_alpha,
        u=new_u,
        win_idx=new_win_idx,
    )
    return context, alignment, new_state


def lsa_attention(attn: LSA, query, inputs, processed_inputs,
                  state: AttnState, mask=None, *,
                  mask_energies: bool = True, rnd=None, **_unused):
    """NVIDIA-style location-sensitive attention step (``rnd`` as in
    :func:`forward_attention`)."""
    q_in = query if rnd is None else rnd(query)
    processed_query = attn.query_layer(q_in[:, None, :])
    processed_loc = _location_features(attn.location_layer, state, rnd)
    energies = attn.v(
        torch.tanh(processed_query + processed_loc + processed_inputs)
    )[..., 0]
    if mask_energies and mask is not None:
        energies = torch.where(mask, energies, MASK_VALUE)
    alignment = torch.softmax(energies, dim=-1)
    context = torch.einsum("bt,btd->bd", alignment, inputs)
    new_state = state._replace(
        attention_weights=alignment,
        attention_weights_cum=state.attention_weights_cum + alignment,
    )
    return context, alignment, new_state
