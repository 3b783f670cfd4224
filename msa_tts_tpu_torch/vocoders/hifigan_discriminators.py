"""HiFi-GAN's discriminators and GAN losses (counterpart of
``msa_tts_tpu/vocoders/hifigan_discriminators.py``), for the HiFi-GAN
trainer.

Multi-Period: periods 2/3/5/7/11, the audio folded to (T / p, p) and
five (5, 1) convolutions of 32-1024 channels striding 3 along time, then
a (3, 1) one.  Multi-Scale: the grouped 1-D convolutions of
:data:`MSD_SPECS` at three scales, each scale average-pooled (4, 2, pad
2, the padding counted as the JAX package divides by the kernel) from
the one before.  Leaky ReLU 0.1 after every convolution but the last of
each discriminator.  The LSGAN losses and feature matching.

The modules are named as the JAX package's trees nest, so a ``state_
dict`` key is the tree's path (``mpd.discriminators.0.convs.0.weight``;
``utils/convert.py``).  ``generator`` draws the JAX package's initial
distribution, U(±1/√fan_in) for weights and biases.  The MPD's reflect
padding is built from slices and ``flip`` (``ops.audio.reflect_pad``),
so that its backward repeats bit for bit on a GPU.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.audio import reflect_pad
from ..ops.nn import uniform_

LRELU_SLOPE = 0.1

MPD_PERIODS = (2, 3, 5, 7, 11)
MPD_CHANNELS = (32, 128, 512, 1024, 1024)
MSD_SPECS = [
    # (in, out, kernel, stride, groups)
    (1, 128, 15, 1, 1),
    (128, 128, 41, 2, 4),
    (128, 256, 41, 2, 16),
    (256, 512, 41, 4, 16),
    (512, 1024, 41, 4, 16),
    (1024, 1024, 41, 1, 16),
    (1024, 1024, 5, 1, 1),
]


@torch.no_grad()
def _init(module: nn.Module, generator: torch.Generator) -> None:
    for m in module.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d)):
            w = m.weight
            a = 1.0 / math.sqrt(w.shape[1] * math.prod(w.shape[2:]))
            uniform_(w, a, generator)
            uniform_(m.bias, a, generator)


class DiscriminatorP(nn.Module):
    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3):
        super().__init__()
        self.period = period
        chans = (1,) + MPD_CHANNELS
        pad = (kernel_size - 1) // 2
        self.convs = nn.ModuleList(
            nn.Conv2d(chans[i], chans[i + 1], (kernel_size, 1),
                      stride=(stride if i < 4 else 1, 1),
                      padding=(pad if i < 4 else 2, 0))
            for i in range(5))
        self.conv_post = nn.Conv2d(MPD_CHANNELS[-1], 1, (3, 1),
                                   padding=(1, 0))

    def forward(self, x):
        """x (B, 1, T) → (score (B, n), feature maps)."""
        B, C, T = x.shape
        if T % self.period:
            x = reflect_pad(x, 0, self.period - T % self.period)
        x = x.reshape(B, C, -1, self.period)
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.reshape(B, -1), fmap


class DiscriminatorS(nn.Module):
    def __init__(self):
        super().__init__()
        self.convs = nn.ModuleList(
            nn.Conv1d(ic, oc, k, stride=s, padding=k // 2, groups=g)
            for ic, oc, k, s, g in MSD_SPECS)
        self.conv_post = nn.Conv1d(1024, 1, 3, padding=1)

    def forward(self, x):
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.reshape(x.shape[0], -1), fmap


def _pair(discriminators, y, y_hat, scale=None):
    """Scores and feature maps of the real ``y`` and generated ``y_hat``
    through each discriminator (``scale`` between two of them):
    ``(real scores, generated scores, real fmaps, generated fmaps)``."""
    out = ([], [], [], [])
    for i, d in enumerate(discriminators):
        if scale is not None and i:
            y, y_hat = scale(y), scale(y_hat)
        s_r, f_r = d(y)
        s_g, f_g = d(y_hat)
        for lst, v in zip(out, (s_r, s_g, f_r, f_g)):
            lst.append(v)
    return out


def avg_pool1d(x):
    """Average pooling (4, 2, padding 2), the padding counted in the
    mean (the JAX package divides every window's sum by 4)."""
    return F.avg_pool1d(x, 4, 2, padding=2, count_include_pad=True)


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, generator: torch.Generator | None = None):
        super().__init__()
        self.discriminators = nn.ModuleList(
            DiscriminatorP(p) for p in MPD_PERIODS)
        if generator is not None:
            _init(self, generator)

    def forward(self, y, y_hat):
        return _pair(self.discriminators, y, y_hat)


class MultiScaleDiscriminator(nn.Module):
    def __init__(self, generator: torch.Generator | None = None):
        super().__init__()
        self.discriminators = nn.ModuleList(
            DiscriminatorS() for _ in range(3))
        if generator is not None:
            _init(self, generator)

    def forward(self, y, y_hat):
        return _pair(self.discriminators, y, y_hat, avg_pool1d)


class Discriminators(nn.Module):
    """Both discriminators, as the trainer holds them (``mpd``, ``msd``:
    the JAX package's ``{"mpd": ..., "msd": ...}``)."""

    def __init__(self, generator: torch.Generator | None = None):
        super().__init__()
        self.mpd = MultiPeriodDiscriminator(generator)
        self.msd = MultiScaleDiscriminator(generator)

    def forward(self, y, y_hat):
        """``(mpd outputs, msd outputs)``, each ``(real scores, generated
        scores, real fmaps, generated fmaps)``."""
        return self.mpd(y, y_hat), self.msd(y, y_hat)


# ------------------------------------------------------------------ losses

def feature_loss(fmap_r, fmap_g):
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + (rl - gl).abs().mean()
    return loss * 2.0


def discriminator_loss(disc_real_outputs, disc_generated_outputs):
    loss = 0.0
    r_losses, g_losses = [], []
    for dr, dg in zip(disc_real_outputs, disc_generated_outputs):
        r = ((1.0 - dr) ** 2).mean()
        g = (dg ** 2).mean()
        loss = loss + r + g
        r_losses.append(r)
        g_losses.append(g)
    return loss, r_losses, g_losses


def generator_loss(disc_outputs):
    loss = 0.0
    gen_losses = []
    for dg in disc_outputs:
        l_g = ((1.0 - dg) ** 2).mean()
        gen_losses.append(l_g)
        loss = loss + l_g
    return loss, gen_losses
