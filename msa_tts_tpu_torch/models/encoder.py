"""Tacotron-2 encoder: conv stack + masked BiLSTM (counterpart of
``msa_tts_tpu/models/encoder.py``), in eval and training mode."""

from __future__ import annotations

import torch
from torch import nn

from ..ops import nn as N
from ..ops import rnn as R

DROPOUT = 0.5  # after every convolution in training, fixed as in the reference


class Encoder(nn.Module):
    """N × (ConvNorm → BatchNorm1d → ReLU) then a one-layer BiLSTM, under
    the reference's keys (``convolutions.{i}.0.conv``,
    ``convolutions.{i}.1``, ``lstm``)."""

    def __init__(self, n_convolutions: int, embedding_dim: int,
                 kernel_size: int, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.kernel_size = kernel_size
        self.convolutions = nn.ModuleList(
            nn.Sequential(
                N.ConvNorm(embedding_dim, embedding_dim, kernel_size,
                           bias=True, w_init_gain="relu",
                           generator=generator),
                nn.BatchNorm1d(embedding_dim),
            )
            for _ in range(n_convolutions)
        )
        self.lstm = nn.LSTM(
            embedding_dim, embedding_dim // 2, num_layers=1,
            batch_first=True, bidirectional=True,
        )
        if generator is not None:
            R.init_lstm_(self.lstm, generator)


def encoder_apply(encoder: Encoder, x, input_lengths, *,
                  mask_pad: bool = False):
    """Apply the encoder in eval mode.

    Args:
      x: (B, C, T) embedded character sequence (channels-first).
      input_lengths: (B,) valid lengths.
      mask_pad: zero padded positions before and between the
        convolutions, so that the output at valid positions does not
        depend on the padded length (the serving paths rely on it).  Off
        by default, as in the reference.

    Returns ``outputs (B, T, C)``.
    """
    return encoder_forward(encoder, x, input_lengths, mask_pad=mask_pad)[0]


def encoder_forward(encoder: Encoder, x, input_lengths, masks=None, *,
                    mask_pad: bool = False):
    """:func:`encoder_apply` returning ``(outputs, new_state)``.  With
    ``masks`` (one (B, C, T) raw 0/1 mask per convolution) it runs in
    training mode: each batch norm normalises with the batch's
    statistics, each convolution's output goes through dropout (rate
    0.5, as in the reference), and ``new_state`` holds one
    ``(running_mean, running_var)`` per convolution (empty in eval
    mode)."""
    valid = None
    if mask_pad:
        T = x.shape[-1]
        valid = (
            torch.arange(T, device=x.device)[None, :]
            < input_lengths[:, None]
        )[:, None, :]  # (B, 1, T)
        x = torch.where(valid, x, 0.0)
    pad = (encoder.kernel_size - 1) // 2
    new_state = []
    for i, conv_bn in enumerate(encoder.convolutions):
        conv, bn = conv_bn[0].conv, conv_bn[1]
        x = N.conv1d_of(conv, x, padding=pad)
        if masks is None:
            x = torch.relu(N.batchnorm1d(bn, x))
        else:
            x, bn_state = N.batchnorm1d_train(bn, x)
            new_state.append(bn_state)
            x = N.dropout(torch.relu(x), masks[i], DROPOUT)
        if valid is not None:
            # conv bias + BN shift make pad positions nonzero again
            x = torch.where(valid, x, 0.0)
    return R.bilstm(encoder.lstm, x.transpose(1, 2), input_lengths), new_state
