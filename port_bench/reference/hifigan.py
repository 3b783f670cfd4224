"""HiFi-GAN generator inference (jik876/hifi-gan, ``resblock`` 1 or 2),
plain PyTorch: conv_pre, then per upsampling stage a leaky ReLU, the
transposed convolution and the mean of the multi-receptive-field
residual blocks, then a leaky ReLU, conv_post and tanh.  Weights are the
generator's ``state_dict`` with weight norm already folded in."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .precision import Precision

LRELU_SLOPE = 0.1


def _pad(k: int, d: int = 1) -> int:
    return (k * d - d) // 2


def _conv(p, sd, name, x, k, d=1):
    return F.conv1d(p.x(x), sd[f"{name}.weight"], sd[f"{name}.bias"],
                    padding=_pad(k, d), dilation=d)


def generate(p: Precision, sd: dict, h: dict, mel):
    """(B, n_mels, T) log-mel → waveform (B, T·hop)."""
    sd = p.params(sd)
    x = _conv(p, sd, "conv_pre", mel, 7)
    nk = len(h["resblock_kernel_sizes"])
    for i, (u, k) in enumerate(zip(h["upsample_rates"],
                                   h["upsample_kernel_sizes"])):
        x = F.conv_transpose1d(p.x(F.leaky_relu(x, LRELU_SLOPE)),
                               sd[f"ups.{i}.weight"], sd[f"ups.{i}.bias"],
                               stride=u, padding=(k - u) // 2)
        acc = None
        for j, (kk, dils) in enumerate(zip(h["resblock_kernel_sizes"],
                                           h["resblock_dilation_sizes"])):
            name = f"resblocks.{i * nk + j}"
            y = x
            for m, d in enumerate(dils):
                if h["resblock"] == "1":
                    t = _conv(p, sd, f"{name}.convs1.{m}",
                              F.leaky_relu(y, LRELU_SLOPE), kk, d)
                    t = _conv(p, sd, f"{name}.convs2.{m}",
                              F.leaky_relu(t, LRELU_SLOPE), kk)
                else:
                    t = _conv(p, sd, f"{name}.convs.{m}",
                              F.leaky_relu(y, LRELU_SLOPE), kk, d)
                y = t + y
            acc = y if acc is None else acc + y
        x = acc / nk
    x = _conv(p, sd, "conv_post", F.leaky_relu(x), 7)
    return torch.tanh(x)[:, 0, :]
