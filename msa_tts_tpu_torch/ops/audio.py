"""Audio DSP (counterpart of ``msa_tts_tpu/ops/audio.py``): STFT/ISTFT,
the mel filterbanks and the HTK one's pseudo-inverse, Griffin-Lim, the
"ap" and "ap2" log-mel frontends and silence trimming (host numpy, for
datasets and adaptation clips), MFCCs and a differentiable "ap2" log-mel
on the device (the HiFi-GAN trainer's mel loss), and wav input and
output (resampling through the host library of ``native/``).

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
# Mel filterbanks (host numpy, cached)
# --------------------------------------------------------------------------

def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


_F_SP, _MIN_LOG_HZ, _LOGSTEP = 200.0 / 3, 1000.0, np.log(6.4) / 27.0


def _hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    min_log_mel = _MIN_LOG_HZ / _F_SP
    return np.where(
        f >= _MIN_LOG_HZ,
        min_log_mel + np.log(np.maximum(f, _MIN_LOG_HZ) / _MIN_LOG_HZ)
        / _LOGSTEP,
        f / _F_SP,
    )


def _mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    min_log_mel = _MIN_LOG_HZ / _F_SP
    return np.where(m >= min_log_mel,
                    _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - min_log_mel)),
                    _F_SP * m)


@lru_cache(maxsize=16)
def mel_filterbank(n_freqs: int, f_min: float, f_max: float, n_mels: int,
                   sample_rate: int, mel_scale: str = "htk",
                   norm: str | None = None) -> np.ndarray:
    """Triangular mel filterbank ``(n_freqs, n_mels)`` float32:
    ``mel_scale="htk", norm=None`` is torchaudio's default (the "ap"
    frontend's), ``mel_scale="slaney", norm="slaney"`` librosa's (the
    "ap2" / HiFi-GAN frontend's)."""
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    if mel_scale == "htk":
        to_mel, to_hz = _hz_to_mel_htk, _mel_to_hz_htk
    elif mel_scale == "slaney":
        to_mel, to_hz = _hz_to_mel_slaney, _mel_to_hz_slaney
    else:
        raise ValueError(f"unknown mel_scale: {mel_scale}")
    f_pts = to_hz(np.linspace(to_mel(f_min), to_mel(f_max), n_mels + 2))
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    if norm == "slaney":
        fb = fb * (2.0 / (f_pts[2: n_mels + 2] - f_pts[:n_mels]))[None, :]
    elif norm is not None:
        raise ValueError(f"unknown norm: {norm}")
    return fb.astype(np.float32)


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


# --------------------------------------------------------------------------
# Log-mel features and silence trimming (host numpy, as the JAX
# package's ``xp=np`` path computes them)
# --------------------------------------------------------------------------

def _stft_np(x: np.ndarray, n_fft: int, win_length: int, hop_length: int,
             *, center: bool) -> np.ndarray:
    """Complex STFT ``(..., n_freqs, n_frames)`` of float32 ``x`` in
    numpy: :func:`stft`'s framing and window."""
    n = np.arange(win_length, dtype=np.float32)
    window = 0.5 * (1.0 - np.cos(2.0 * math.pi * n / win_length))
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = np.pad(window, (lpad, n_fft - win_length - lpad))
    if center:
        pad = n_fft // 2
        x = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)],
                   mode="reflect")
    n_frames = 1 + (x.shape[-1] - n_fft) // hop_length
    if n_frames <= 0:
        raise ValueError(
            f"signal too short to frame: {x.shape[-1]} samples < "
            f"frame_length {n_fft} (after any padding)"
        )
    idx = (np.arange(n_frames)[:, None] * hop_length
           + np.arange(n_fft)[None, :])
    spec = np.fft.rfft(x[..., idx] * window, n=n_fft, axis=-1)
    return np.swapaxes(spec, -1, -2)


def melspec_ap(wav: np.ndarray, audio_params: dict) -> np.ndarray:
    """The "ap" frontend's log-mel ``(..., n_mels, n_frames)``: power
    STFT → HTK mel → ``log10(max(., 1e-10))``."""
    p = audio_params
    spec = np.abs(_stft_np(wav, p["n_fft"], p["win_length"],
                           p["hop_length"], center=True)) ** 2.0
    fb = mel_filterbank(p["n_fft"] // 2 + 1, p["f_min"], p["f_max"],
                        p["n_mels"], p["sample_rate"])
    mel = np.swapaxes(np.swapaxes(spec, -1, -2) @ fb, -1, -2)
    return np.log10(np.maximum(mel, 1e-10))


def dynamic_range_compression(x, C: float = 1.0, clip_val: float = 1e-5):
    return np.log(np.maximum(x, clip_val) * C)


def melspec_ap2(wav: np.ndarray, audio_params: dict) -> np.ndarray:
    """The "ap2" (HiFi-GAN) frontend's log-mel ``(..., n_mels,
    n_frames)``: reflect pad by ``(n_fft - hop) / 2``, magnitude STFT
    with a 1e-9 floor, Slaney mel, natural log clamped at 1e-5."""
    p = audio_params
    n_fft, hop, win = p["n_fft"], p["hop_size"], p["win_size"]
    pad = (n_fft - hop) // 2
    wav = np.pad(wav, [(0, 0)] * (wav.ndim - 1) + [(pad, pad)],
                 mode="reflect")
    spec = _stft_np(wav, n_fft, win, hop, center=bool(p.get("center",
                                                            False)))
    mag = np.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-9)
    fb = mel_filterbank(n_fft // 2 + 1, p["fmin"], p["fmax"], p["n_mels"],
                        p["sample_rate"], mel_scale="slaney", norm="slaney")
    mel = np.swapaxes(np.swapaxes(mag, -1, -2) @ fb, -1, -2)
    return dynamic_range_compression(mel)


def mfcc(wav, audio_params: dict):
    """MFCCs ``(..., n_mfcc, n_frames)`` of a waveform tensor on its
    device: the "ap" power mel (:func:`stft`, HTK filterbank), ``log(mel
    + 1e-6)``, then an orthonormal DCT-II over the mel axis."""
    p = audio_params
    spec = stft(wav, p["n_fft"], p["win_length"], p["hop_length"],
                center=True, power=2.0)
    fb = torch.from_numpy(mel_filterbank(
        p["n_fft"] // 2 + 1, p["f_min"], p["f_max"], p["n_mels"],
        p["sample_rate"])).to(wav.device)
    log_mel = torch.log((spec.transpose(-1, -2) @ fb).transpose(-1, -2)
                        + 1e-6)
    n_mels, n_mfcc = p["n_mels"], p["n_mfcc"]
    n, k = np.arange(n_mels), np.arange(n_mfcc)
    dct = np.cos(math.pi / n_mels * (n[None, :] + 0.5) * k[:, None])
    dct *= math.sqrt(2.0 / n_mels)
    dct[0] *= 1.0 / math.sqrt(2.0)
    dct = torch.from_numpy(dct.astype(np.float32)).to(wav.device)
    return torch.einsum("km,...mt->...kt", dct, log_mel)


# --------------------------------------------------------------------------
# The "ap2" log-mel on the device, differentiable (the HiFi-GAN trainer's
# mel loss of generated audio)
# --------------------------------------------------------------------------

def reflect_pad(x, left: int, right: int):
    """Reflect padding of the last axis (``np.pad(mode="reflect")``), from
    slices and ``flip``: its backward is a gather-free sum of slices,
    where ``F.pad(mode="reflect")``'s CUDA backward accumulates with
    atomics and so does not repeat bit for bit."""
    parts = [x]
    if left:
        parts.insert(0, x[..., 1: left + 1].flip(-1))
    if right:
        parts.append(x[..., -right - 1: -1].flip(-1))
    return torch.cat(parts, dim=-1)


def melspec_ap2_torch(wav, audio_params: dict):
    """:func:`melspec_ap2` of a waveform tensor ``(..., T)`` on its
    device, differentiable: reflect pad by ``(n_fft - hop) / 2``, the
    STFT without centring (``center: true`` pads once more, as the numpy
    path does), ``sqrt(re² + im² + 1e-9)`` (the 1e-9 keeps the gradient
    finite at a zero bin), the Slaney filterbank, ``log(max(., 1e-5))``."""
    p = audio_params
    n_fft, hop, win = p["n_fft"], p["hop_size"], p["win_size"]
    pad = (n_fft - hop) // 2
    wav = reflect_pad(wav, pad, pad)
    if p.get("center", False):
        wav = reflect_pad(wav, n_fft // 2, n_fft // 2)
    spec = stft(wav, n_fft, win, hop, center=False, power=None)
    mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-9)
    fb = torch.from_numpy(mel_filterbank(
        n_fft // 2 + 1, p["fmin"], p["fmax"], p["n_mels"],
        p["sample_rate"], mel_scale="slaney", norm="slaney")).to(wav.device)
    mel = (mag.transpose(-1, -2) @ fb).transpose(-1, -2)
    return torch.log(torch.clamp_min(mel, 1e-5))


def trim_margin_silence_slice(wav: np.ndarray, ref_level_db: float = 26,
                              frame_length: int = 1024,
                              hop_length: int = 256) -> tuple[int, int]:
    """Bounds ``(start, end)`` of :func:`trim_margin_silence`'s slice."""
    wav = np.asarray(wav)
    if wav.size == 0:
        return 0, 0
    pad = frame_length // 2
    padded = np.pad(wav, (pad, pad))
    n_frames = 1 + (padded.shape[-1] - frame_length) // hop_length
    idx = (np.arange(n_frames)[:, None] * hop_length
           + np.arange(frame_length)[None, :])
    power = np.mean(padded[idx] ** 2, axis=-1)
    ref = np.max(power)
    if ref <= 0:
        return 0, int(wav.shape[-1])
    db = 10.0 * np.log10(np.maximum(power, 1e-20) / ref)
    nz = np.flatnonzero(db > -ref_level_db)
    if nz.size == 0:
        return 0, 0
    start = int(nz[0]) * hop_length
    end = min(int(wav.shape[-1]), int(nz[-1] + 1) * hop_length)
    return start, end


def trim_margin_silence(wav: np.ndarray, ref_level_db: float = 26,
                        frame_length: int = 1024,
                        hop_length: int = 256) -> np.ndarray:
    """Trim leading and trailing frames more than ``ref_level_db`` below
    the peak frame power (librosa.effects.trim semantics)."""
    wav = np.asarray(wav)
    start, end = trim_margin_silence_slice(wav, ref_level_db, frame_length,
                                           hop_length)
    return wav[start:end]


def load_wav(path: str, target_sample_rate: int | None = None) -> np.ndarray:
    """Load a wav file's first channel, normalised to peak 1.0, resampled
    when its rate differs from ``target_sample_rate``: by the host
    library's polyphase engine (``native.resample``), or by
    ``scipy.signal.resample_poly`` (the same filter) without it."""
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    data = np.asarray(data, dtype=np.float32)
    if data.ndim == 2:
        data = data[:, 0]
    peak = np.max(np.abs(data))
    if peak > 0:
        data = data / peak
    if target_sample_rate is not None and sr != target_sample_rate:
        from ..native import resample

        out = resample(data, int(sr), int(target_sample_rate))
        if out is None:
            from scipy.signal import resample_poly

            g = math.gcd(int(target_sample_rate), int(sr))
            out = resample_poly(
                data, int(target_sample_rate) // g, int(sr) // g
            ).astype(np.float32)
        data = out
    return data


def save_wav(path: str, wav, sample_rate: int) -> None:
    """Write a 16-bit PCM wav, peak-normalised when it would clip."""
    from scipy.io import wavfile

    wav = np.asarray(wav, dtype=np.float32)
    peak = np.max(np.abs(wav))
    if peak > 1.0:
        wav = wav / peak
    wavfile.write(path, sample_rate, (wav * 32767.0).astype(np.int16))
