"""Spectral-gating audio denoiser (noisereduce-style).

Counterpart of ``msa_tts_tpu/vocoders/denoiser.py`` on the port's
``ops.audio`` STFT (float32 on the CPU; the statistics and the mask are
numpy).  Per-frequency noise statistics from a noise-profile clip, dB
threshold mean + n_std·std, a
time/frequency-smoothed binary mask, masked STFT resynthesis.  Applied
after WaveRNN vocoding (reference infer.py:321-323) with the profile's
parameters (n_fft 1024, hop 275, n_std 0.8, freq smoothing 4).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.audio import istft, stft


def _stft(x: np.ndarray, n_fft: int, win_length: int, hop_length: int):
    return stft(torch.from_numpy(np.asarray(x, np.float32)), n_fft,
                win_length, hop_length, power=None).numpy()


def _amp_to_db(x):
    return 20.0 * np.log10(np.maximum(np.abs(x), 1e-20))


def _db_to_amp(x):
    return 10.0 ** (x / 20.0)


def _smoothing_filter(n_grad_freq: int, n_grad_time: int) -> np.ndarray:
    """Triangular ramp filter over (freq, time), normalized to sum 1."""
    f = np.concatenate(
        [
            np.linspace(0, 1, n_grad_freq + 1, endpoint=False),
            np.linspace(1, 0, n_grad_freq + 2),
        ]
    )[1:-1]
    t = np.concatenate(
        [
            np.linspace(0, 1, n_grad_time + 1, endpoint=False),
            np.linspace(1, 0, n_grad_time + 2),
        ]
    )[1:-1]
    kernel = np.outer(f, t)
    return kernel / kernel.sum()


def _convolve2d(x: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    from scipy.signal import fftconvolve

    return fftconvolve(x, kernel, mode="same")


def reduce_noise(
    audio_clip: np.ndarray,
    noise_clip: np.ndarray,
    n_grad_freq: int = 2,
    n_grad_time: int = 4,
    n_fft: int = 2048,
    win_length: int = 2048,
    hop_length: int = 512,
    n_std_thresh: float = 1.5,
    prop_decrease: float = 1.0,
    pad_clipping: bool = True,
) -> np.ndarray:
    """Subtract the noise profile from ``audio_clip`` by spectral gating."""
    noise_stft = _stft(noise_clip, n_fft, win_length, hop_length)
    noise_db = _amp_to_db(noise_stft)
    noise_thresh = (
        noise_db.mean(axis=1) + noise_db.std(axis=1) * n_std_thresh
    )

    nsamp = len(audio_clip)
    sig = np.asarray(audio_clip, np.float32)
    if pad_clipping:
        sig = np.pad(sig, (0, hop_length))

    sig_stft = _stft(sig, n_fft, win_length, hop_length)
    sig_db = _amp_to_db(sig_stft)

    mask = (sig_db < noise_thresh[:, None]).astype(np.float64)
    if n_grad_freq > 0 or n_grad_time > 0:
        mask = _convolve2d(
            mask, _smoothing_filter(max(n_grad_freq, 0), max(n_grad_time, 0))
        )
    mask = np.clip(mask, 0.0, 1.0) * prop_decrease

    gain_db = np.min(sig_db)
    masked_db = sig_db * (1.0 - mask) + gain_db * mask
    phase = np.angle(sig_stft)
    masked = _db_to_amp(masked_db) * np.exp(1j * phase)

    return istft(torch.from_numpy(masked.astype(np.complex64)), n_fft,
                 win_length, hop_length, length=nsamp).numpy()


class AudioDenoiser:
    """Reference-API wrapper: noise profile wav → ``denoise(wav)``
    (reference audio_denoiser.py:280-296 parameterization)."""

    def __init__(self, noise_profile_path: str):
        from ..ops.audio import load_wav

        self.noise_clip = load_wav(noise_profile_path)

    def denoise(self, wav: np.ndarray) -> np.ndarray:
        return reduce_noise(
            wav,
            self.noise_clip,
            n_grad_freq=4,
            n_grad_time=0,
            n_fft=1024,
            win_length=1024,
            hop_length=275,
            n_std_thresh=0.8,
            prop_decrease=1.0,
            pad_clipping=True,
        )
