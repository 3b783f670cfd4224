"""Audio DSP for the serving path (counterpart of
``msa_tts_tpu/ops/audio.py``): STFT/ISTFT, the HTK mel filterbank and its
pseudo-inverse, Griffin-Lim, and wav output.

The transforms follow the JAX package's formulation (framing + rfft;
overlap-add with squared-window normalisation) rather than
``torch.stft``/``torch.istft``, so both packages compute the same
function.  Every transform takes leading batch dimensions.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_length: int, *, device=None, dtype=torch.float32):
    """Periodic Hann window (matches ``torch.hann_window``)."""
    n = torch.arange(win_length, dtype=dtype, device=device)
    return 0.5 * (1.0 - torch.cos(2.0 * math.pi * n / win_length))


def _padded_window(n_fft: int, win_length: int, device):
    window = hann_window(win_length, device=device)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = F.pad(window, (lpad, n_fft - win_length - lpad))
    return window


def stft(x, n_fft: int, win_length: int, hop_length: int, *,
         center: bool = True, power: float | None = 2.0):
    """Short-time Fourier transform over the last axis: a ``win_length``
    Hann window centred in ``n_fft``, optional reflect padding of
    ``n_fft // 2``.  Returns the complex STFT ``(..., n_freqs,
    n_frames)`` when ``power`` is None, else ``|STFT| ** power``."""
    window = _padded_window(n_fft, win_length, x.device)
    if center:
        pad = n_fft // 2
        lead = x.shape[:-1]
        x = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad),
                  mode="reflect").reshape(*lead, -1)
    if 1 + (x.shape[-1] - n_fft) // hop_length <= 0:
        raise ValueError(
            f"signal too short to frame: {x.shape[-1]} samples < "
            f"frame_length {n_fft} (after any padding)"
        )
    frames = x.unfold(-1, n_fft, hop_length) * window
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1).transpose(-1, -2)
    if power is None:
        return spec
    mag = spec.abs()
    return mag if power == 1.0 else mag ** power


def istft(spec, n_fft: int, win_length: int, hop_length: int, *,
          center: bool = True, length: int | None = None):
    """Inverse STFT of a complex ``(..., n_freqs, n_frames)`` spectrum
    by overlap-add with squared-window normalisation."""
    window = _padded_window(n_fft, win_length, spec.device)
    frames = torch.fft.irfft(spec.transpose(-1, -2), n=n_fft, dim=-1)
    frames = frames * window
    n_frames = frames.shape[-2]
    out_len = n_fft + hop_length * (n_frames - 1)
    lead = frames.shape[:-2]
    idx = (
        torch.arange(n_frames, device=spec.device)[:, None] * hop_length
        + torch.arange(n_fft, device=spec.device)[None, :]
    ).reshape(-1)
    out = torch.zeros(*lead, out_len, dtype=frames.dtype,
                      device=spec.device)
    out.index_add_(-1, idx, frames.reshape(*lead, -1))
    norm = torch.zeros(out_len, dtype=frames.dtype, device=spec.device)
    norm.index_add_(0, idx, (window ** 2).repeat(n_frames))
    out = out / torch.clamp_min(norm, 1e-11)
    if center:
        pad = n_fft // 2
        stop = out_len - pad if length is None else min(pad + length,
                                                        out_len)
        out = out[..., pad:stop]
    if length is not None:
        if out.shape[-1] < length:
            out = F.pad(out, (0, length - out.shape[-1]))
        out = out[..., :length]
    return out


# --------------------------------------------------------------------------
# Mel filterbank (host numpy, cached)
# --------------------------------------------------------------------------

def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


@lru_cache(maxsize=16)
def mel_filterbank(n_freqs: int, f_min: float, f_max: float, n_mels: int,
                   sample_rate: int) -> np.ndarray:
    """HTK-scale triangular mel filterbank without norm, ``(n_freqs,
    n_mels)`` float32 (torchaudio's default, the "ap" frontend's)."""
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(_hz_to_mel_htk(f_min), _hz_to_mel_htk(f_max),
                        n_mels + 2)
    f_pts = _mel_to_hz_htk(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


@lru_cache(maxsize=16)
def _mel_fbank_pinv(n_freqs, f_min, f_max, n_mels, sample_rate):
    """Pseudo-inverse of the HTK filterbank, ``(n_freqs, n_mels)``, host
    numpy; callers move it to their device."""
    fb = mel_filterbank(n_freqs, f_min, f_max, n_mels, sample_rate)
    return np.linalg.pinv(fb.T)


# --------------------------------------------------------------------------
# Griffin-Lim
# --------------------------------------------------------------------------

def griffin_lim(spec, n_fft: int, win_length: int, hop_length: int,
                n_iter: int = 60, power: float = 2.0,
                momentum: float = 0.99, *, init_phase=None,
                generator: torch.Generator | None = None,
                length: int | None = None):
    """Momentum-accelerated Griffin-Lim on a non-negative spectrogram
    ``(..., n_freqs, n_frames)`` in the given ``power`` scale.

    ``init_phase`` (radians, broadcastable to ``spec``) is the starting
    phase; without it a ``(n_freqs, n_frames)`` phase is drawn
    U(-π, π) from ``generator`` (a generator seeded 0 when None) and
    shared by every leading row."""
    S = spec ** (1.0 / power)
    if init_phase is None:
        g = generator if generator is not None else (
            torch.Generator().manual_seed(0)
        )
        u = torch.rand(S.shape[-2:], generator=g, device=g.device)
        init_phase = (u * (2.0 * math.pi) - math.pi).to(S.device)
    angles = torch.polar(torch.ones_like(init_phase), init_phase)
    angles = angles.to(S.device).expand(S.shape)
    mom = momentum / (1.0 + momentum)
    tprev = torch.zeros_like(angles)
    for _ in range(n_iter):
        inverse = istft(S * angles, n_fft, win_length, hop_length)
        rebuilt = stft(inverse, n_fft, win_length, hop_length, power=None)
        na = rebuilt - mom * tprev
        angles = na / torch.clamp_min(na.abs(), 1e-16)
        tprev = rebuilt
    return istft(S * angles, n_fft, win_length, hop_length, length=length)


def griffinlim_logmelspec(log_melspec, audio_params: dict, *,
                          init_phase=None,
                          generator: torch.Generator | None = None):
    """Invert a log10-mel spectrogram ``(..., n_mels, T)`` ("ap" flavour)
    to waveforms: ``10**logmel`` → pseudo-inverse of the HTK filterbank →
    Griffin-Lim.  Spectra shorter than ``n_fft // hop + 1`` frames are
    edge-padded to that length first."""
    p = audio_params
    mel = 10.0 ** log_melspec
    inv = torch.from_numpy(_mel_fbank_pinv(
        p["n_fft"] // 2 + 1, p["f_min"], p["f_max"], p["n_mels"],
        p["sample_rate"],
    )).to(mel.device)
    spec = torch.clamp_min(inv @ mel, 1e-10)
    min_frames = p["n_fft"] // p["hop_length"] + 1
    if spec.shape[-1] < min_frames:
        edge = spec[..., -1:].expand(
            *spec.shape[:-1], min_frames - spec.shape[-1]
        )
        spec = torch.cat([spec, edge], dim=-1)
    return griffin_lim(
        spec, p["n_fft"], p["win_length"], p["hop_length"],
        n_iter=p.get("griffinlim_iters", 60), power=2.0,
        init_phase=init_phase, generator=generator,
    )


def save_wav(path: str, wav, sample_rate: int) -> None:
    """Write a 16-bit PCM wav, peak-normalised when it would clip."""
    from scipy.io import wavfile

    wav = np.asarray(wav, dtype=np.float32)
    peak = np.max(np.abs(wav))
    if peak > 1.0:
        wav = wav / peak
    wavfile.write(path, sample_rate, (wav * 32767.0).astype(np.int16))
