"""Griffin-Lim on the vocoder seam (``vocoders/__init__.py``):
``ops.audio.griffinlim_logmelspec`` over the model's ``audio_params``."""

import functools
import math

import torch

from ..ops.audio import griffinlim_logmelspec
from ..utils.batching import pad_mel_batch
from . import Vocoder


class GriffinLim(Vocoder):
    name = "griffinlim"
    tail_frames = 1

    def __init__(self, audio_params: dict, device="cpu"):
        self.ap = audio_params
        self.to(device)

    def to(self, device) -> "GriffinLim":
        self.device = torch.device(device)
        return self

    def vocode(self, mels, generator=None, *, phase=None, noise=None):
        """``phase``: (n_freqs, F), F the magnitude's frames.  Several
        mels are one inversion (padded as ``pad_mel_batch`` pads, as the
        JAX package does), each waveform cut to the (T_i − 1)·hop samples
        it gives alone."""
        if phase is not None:
            phase = torch.as_tensor(phase, dtype=torch.float32,
                                    device=self.device)
        if len(mels) == 1:
            return [griffinlim_logmelspec(mels[0], self.ap, init_phase=phase,
                                          generator=generator)]
        wavs = griffinlim_logmelspec(pad_mel_batch(mels)[: len(mels)],
                                     self.ap, init_phase=phase,
                                     generator=generator)
        hop = self.ap["hop_length"]
        return [wavs[i, : (m.shape[1] - 1) * hop] for i, m in enumerate(mels)]

    def stream_noise(self, seed: int, *, phase=None, noise=None):
        """Every window of a width starts from one phase, made once:
        ``phase`` (a tensor, or a callable ``(n_freqs, n_frames) ->
        phase``), else U(−π, π) from a generator seeded with ``seed`` (the
        JAX package uses one key)."""
        n_freqs = self.ap["n_fft"] // 2 + 1
        min_frames = self.ap["n_fft"] // self.ap["hop_length"] + 1

        @functools.cache
        def phase_for(n: int) -> torch.Tensor:
            ph = phase(n_freqs, n) if callable(phase) else phase
            if ph is None:
                g = torch.Generator().manual_seed(seed)
                ph = (torch.rand((n_freqs, n), generator=g) * (2.0 * math.pi)
                      - math.pi)
            return torch.as_tensor(ph, dtype=torch.float32, device=self.device)

        return lambda width: (None, phase_for(max(width, min_frames)), None)
