"""HiFi-GAN generator (inference vocoder), counterpart of
``msa_tts_tpu/vocoders/hifigan.py``.

conv_pre → [leaky-relu → transposed-conv upsample → multi-receptive-field
fusion of ResBlock1/2] × n → leaky-relu → conv_post → tanh.  A trained
checkpoint stores weight-normed convolutions (``weight_g``, ``weight_v``);
the importer fuses them (g·v/‖v‖) at load time, so :class:`Generator`
holds plain convolutions under the checkpoint's module names and
inference runs them as they are (cuDNN on a GPU).  The discriminators
and GAN losses are in ``hifigan_discriminators.py``; the trainer
(``trainers/hifigan_train.py``) trains the plain convolutions.

Config is the standard HiFi-GAN JSON (``resblock``, ``upsample_rates``,
``upsample_kernel_sizes``, ``upsample_initial_channel``,
``resblock_kernel_sizes``, ``resblock_dilation_sizes``).
"""

from __future__ import annotations

import json

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.backend import load_device
from ..utils.batching import pad_mel_batch, pow2_bucket
from . import Vocoder

LRELU_SLOPE = 0.1


class AttrDict(dict):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.__dict__ = self


def load_hifigan_config(path: str) -> AttrDict:
    with open(path) as f:
        return AttrDict(json.load(f))


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


def hop_length(h: dict) -> int:
    return int(np.prod(h["upsample_rates"]))


# --------------------------------------------------------------------------
# Modules
# --------------------------------------------------------------------------

def _conv(ch: int, k: int, d: int) -> nn.Conv1d:
    return nn.Conv1d(ch, ch, k, dilation=d, padding=get_padding(k, d))


class ResBlock1(nn.Module):
    def __init__(self, ch: int, k: int, dilations):
        super().__init__()
        self.convs1 = nn.ModuleList(_conv(ch, k, d) for d in dilations)
        self.convs2 = nn.ModuleList(_conv(ch, k, 1) for _ in dilations)


class ResBlock2(nn.Module):
    def __init__(self, ch: int, k: int, dilations):
        super().__init__()
        self.convs = nn.ModuleList(_conv(ch, k, d) for d in dilations)


class Generator(nn.Module):
    """The generator's (fused) convolutions under the checkpoint's names.
    ``generator`` draws the HiFi-GAN init: weights N(0, 0.01), zero
    biases."""

    def __init__(self, h: dict, n_mels: int = 80,
                 generator: torch.Generator | None = None):
        super().__init__()
        h = self.h = AttrDict(h)
        ch = h.upsample_initial_channel
        self.conv_pre = nn.Conv1d(n_mels, ch, 7, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        block = ResBlock1 if h.resblock == "1" else ResBlock2
        for i, (u, k) in enumerate(zip(h.upsample_rates,
                                       h.upsample_kernel_sizes)):
            ch = h.upsample_initial_channel // (2 ** (i + 1))
            self.ups.append(nn.ConvTranspose1d(
                2 * ch, ch, k, stride=u, padding=(k - u) // 2))
            for kk, d in zip(h.resblock_kernel_sizes,
                             h.resblock_dilation_sizes):
                self.resblocks.append(block(ch, kk, d))
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3)
        if generator is not None:
            with torch.no_grad():
                for name, p in self.named_parameters():
                    if name.endswith("bias"):
                        p.zero_()
                    else:
                        p.copy_(0.01 * torch.randn(
                            p.shape, generator=generator,
                            device=generator.device))

    def forward(self, mel):
        """(B, n_mels, T) log-mel → waveform (B, T·hop)."""
        return generator_apply(self, self.h, mel)


# --------------------------------------------------------------------------
# Apply
# --------------------------------------------------------------------------

def _resblock_apply(block, kind: str, x, mask=None):
    def m(t):
        return t if mask is None else torch.where(mask, t, 0.0)

    if kind == "1":
        for c1, c2 in zip(block.convs1, block.convs2):
            xt = m(c1(F.leaky_relu(x, LRELU_SLOPE)))
            xt = m(c2(F.leaky_relu(xt, LRELU_SLOPE)))
            x = xt + x
    else:
        for c in block.convs:
            x = m(c(F.leaky_relu(x, LRELU_SLOPE))) + x
    return x


def generator_apply(gen: Generator, h: dict, mel, lengths=None):
    """mel: (B, n_mels, T) log-mel → waveform (B, T·hop).

    ``lengths`` (B,) true frame counts make a padded batch give each row
    what it gives alone: zeroing every conv's output at frames at or past
    the (per-layer upsampled) true length reproduces the implicit zero
    padding the unpadded single-utterance run sees, layer by layer, also
    inside the resblocks, where a second conv would otherwise read the
    bias the first wrote into the padded region."""
    h = AttrDict(h)
    num_kernels = len(h.resblock_kernel_sizes)

    def mk_mask(T, lens):
        return (torch.arange(T, device=mel.device)[None, :]
                < lens[:, None])[:, None, :]

    mask = None if lengths is None else mk_mask(mel.shape[2], lengths)

    def m(t):
        return t if mask is None else torch.where(mask, t, 0.0)

    x = m(gen.conv_pre(mel))
    for i, u in enumerate(h.upsample_rates):
        x = gen.ups[i](F.leaky_relu(x, LRELU_SLOPE))
        if lengths is not None:
            lengths = lengths * u
            mask = mk_mask(x.shape[2], lengths)
        x = m(x)
        xs = None
        for j in range(num_kernels):
            y = _resblock_apply(gen.resblocks[i * num_kernels + j],
                                h.resblock, x, mask=mask)
            xs = y if xs is None else xs + y
        x = xs / num_kernels
    x = gen.conv_post(F.leaky_relu(x))       # default slope 0.01
    return torch.tanh(x)[:, 0, :]


# --------------------------------------------------------------------------
# Checkpoint import (with weight-norm fusion)
# --------------------------------------------------------------------------

def _fuse_weight_norm(sd: dict, key: str) -> np.ndarray:
    """weight = g · v / ‖v‖ with the norm over all dims except dim 0
    (the weight_norm default); a plain ``.weight`` passes through."""
    if key + ".weight" in sd:
        return np.asarray(sd[key + ".weight"], dtype=np.float32)
    g = np.asarray(sd[key + ".weight_g"], dtype=np.float32)
    v = np.asarray(sd[key + ".weight_v"], dtype=np.float32)
    axes = tuple(range(1, v.ndim))
    norm = np.sqrt(np.sum(v**2, axis=axes, keepdims=True))
    return g * v / np.maximum(norm, 1e-12)


def generator_params_from_state_dict(sd: dict, h: dict,
                                     n_mels: int | None = None) -> Generator:
    """A HiFi-GAN generator ``state_dict`` (weight-normed or plain;
    tensors or arrays) fused and loaded into a :class:`Generator` with
    ``strict=True``."""
    bases = sorted({k.rsplit(".", 1)[0] for k in sd})
    fused = {}
    for base in bases:
        fused[base + ".weight"] = torch.from_numpy(
            np.array(_fuse_weight_norm(sd, base), copy=True))
        if base + ".bias" in sd:
            fused[base + ".bias"] = torch.as_tensor(
                np.asarray(sd[base + ".bias"], np.float32))
    if n_mels is None:
        n_mels = fused["conv_pre.weight"].shape[1]
    gen = Generator(h, n_mels)
    gen.load_state_dict(fused, strict=True)
    return gen


def load_torch_generator(checkpoint_path: str, h: dict) -> Generator:
    """Load a HiFi-GAN generator checkpoint (the usual ``{"generator":
    state_dict}`` layout or a bare state_dict)."""
    raw = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
    sd = raw.get("generator", raw)
    return generator_params_from_state_dict(
        {k: v.numpy() for k, v in sd.items()}, h)


class HiFiGAN(Vocoder):
    """Reference-API wrapper: config JSON + checkpoint →
    ``inference(mel)``."""

    name = "hifigan"

    def __init__(self, config_path: str, checkpoint_path: str,
                 device="cuda"):
        """Loads onto the GPU unless ``device="cpu"`` is asked for;
        without a CUDA device the default raises."""
        device = load_device(device)
        self.h = load_hifigan_config(config_path)
        self._set(load_torch_generator(checkpoint_path, self.h), device)

    @classmethod
    def from_params(cls, gen: Generator, h: dict, device=None) -> "HiFiGAN":
        """Wrap an in-memory generator without a checkpoint file."""
        obj = cls.__new__(cls)
        obj.h = AttrDict(h)
        obj._set(gen, device)
        return obj

    def _set(self, gen: Generator, device) -> None:
        self.device = torch.device(
            device if device is not None
            else next(gen.parameters()).device)
        self.gen = gen.to(self.device).eval()

    def to(self, device) -> "HiFiGAN":
        self._set(self.gen, device)
        return self

    def _mel(self, mel) -> torch.Tensor:
        return torch.as_tensor(mel, dtype=torch.float32).to(self.device)

    @torch.no_grad()
    def inference(self, mel) -> torch.Tensor:
        """(n_mels, T) or (1, n_mels, T) log-mel → waveform (T·hop,) on
        the generator's device."""
        mel = self._mel(mel)
        if mel.dim() == 2:
            mel = mel[None]
        return generator_apply(self.gen, self.h, mel)[0]

    @torch.no_grad()
    def inference_batch(self, mels) -> list:
        """ONE generator pass for variably-sized mels: zero-filled to a
        common quantized shape, each waveform cut back to its own
        frames·hop samples.  The zero fill and the per-layer length
        masking of :func:`generator_apply` make row i equal
        ``inference(mels[i])`` whatever the batch holds."""
        mels = [self._mel(m) for m in mels]
        hop = hop_length(self.h)
        if len(mels) == 1:
            return [self.inference(mels[0])]
        n = [m.shape[1] for m in mels]
        lens = torch.tensor(n + [n[-1]] * (pow2_bucket(len(n)) - len(n)),
                            dtype=torch.int64, device=self.device)
        wavs = generator_apply(self.gen, self.h,
                               pad_mel_batch(mels, fill="zero"), lens)
        return [wavs[i, : t * hop] for i, t in enumerate(n)]

    def vocode(self, mels, generator=None, *, phase=None, noise=None):
        return self.inference_batch(mels)
