"""Tacotron-2 encoder: conv stack + masked BiLSTM (counterpart of
``msa_tts_tpu/models/encoder.py``), eval mode."""

from __future__ import annotations

import torch
from torch import nn

from ..ops import nn as N
from ..ops import rnn as R


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
    valid = None
    if mask_pad:
        T = x.shape[-1]
        valid = (
            torch.arange(T, device=x.device)[None, :]
            < input_lengths[:, None]
        )[:, None, :]  # (B, 1, T)
        x = torch.where(valid, x, 0.0)
    pad = (encoder.kernel_size - 1) // 2
    for conv_bn in encoder.convolutions:
        conv, bn = conv_bn[0].conv, conv_bn[1]
        x = N.conv1d(x, conv.weight, conv.bias, padding=pad)
        x = torch.relu(N.batchnorm1d(bn, x))
        if valid is not None:
            # conv bias + BN shift make pad positions nonzero again
            x = torch.where(valid, x, 0.0)
    return R.bilstm(encoder.lstm, x.transpose(1, 2), input_lengths)
