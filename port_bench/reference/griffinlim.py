"""Griffin-Lim inversion of a log-mel, plain PyTorch.

The magnitude as the port states it (the "ap" frontend's inverse):
``10 ** logmel``, the pseudo-inverse of the HTK mel filterbank
(torchaudio's default: no normalisation) applied, floored at 1e-10, and
edge-padded to ``n_fft // hop + 1`` frames; then momentum Griffin-Lim,
the fast Griffin-Lim of Perraudin, Balazs and Søndergaard (2013) as
torchaudio writes it (momentum α enters as α / (1 + α); α = 0.99), for
``griffinlim_iters`` iterations from a given starting phase, and a last
inverse STFT.  The STFT is centred with reflect padding and a periodic
Hann window of ``win_length`` centred in ``n_fft``.

Departures from the port's algorithm, none of which changes the
function:
- the transforms are ``torch.stft`` / ``torch.istft``, where the port
  frames, windows and transforms by hand (``ops/audio.py``); the sums
  run in another order;
- the filterbank's pseudo-inverse is taken in float64 and rounded to
  float32, where the port takes it in float32;
- ``torch.istft`` refuses a window envelope under 1e-11 where the port
  floors it at 1e-11; with ``hop <= win_length / 2`` the envelope inside
  the kept samples is far above it.

``Precision`` rounds the operands of the product and the input of every
transform (a complex one's real and imaginary parts each); all else is
float32.
"""

from __future__ import annotations

import numpy as np
import torch

from .precision import Precision

MOMENTUM = 0.99


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + f / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (m / 2595.0) - 1.0)


def mel_filterbank(n_freqs: int, f_min: float, f_max: float, n_mels: int,
                   sample_rate: int) -> np.ndarray:
    """(n_freqs, n_mels) triangular HTK-scale filters, unnormalised,
    float64."""
    freqs = np.linspace(0.0, sample_rate // 2, n_freqs)
    pts = _mel_to_hz(np.linspace(_hz_to_mel(float(f_min)),
                                 _hz_to_mel(float(f_max)), n_mels + 2))
    lo, mid, hi = pts[:-2], pts[1:-1], pts[2:]
    up = (freqs[:, None] - lo[None, :]) / (mid - lo)[None, :]
    down = (hi[None, :] - freqs[:, None]) / (hi - mid)[None, :]
    return np.maximum(0.0, np.minimum(up, down))


def magnitude(p: Precision, ap: dict, mel: torch.Tensor) -> torch.Tensor:
    """(n_freqs, F) linear magnitude (the power's square root) of a
    (n_mels, T) log10-mel, F = max(T, n_fft // hop + 1)."""
    n_freqs = ap["n_fft"] // 2 + 1
    fb = mel_filterbank(n_freqs, ap["f_min"], ap["f_max"], ap["n_mels"],
                        ap["sample_rate"]).astype(np.float32)
    inv = torch.as_tensor(np.linalg.pinv(fb.T.astype(np.float64)),
                          dtype=torch.float32, device=mel.device)
    power = torch.clamp_min(p.w(inv) @ p.x(10.0 ** mel), 1e-10)
    short = ap["n_fft"] // ap["hop_length"] + 1 - power.shape[-1]
    if short > 0:
        power = torch.cat([power, power[:, -1:].expand(-1, short)], 1)
    return power ** 0.5


def _cx(p: Precision, z: torch.Tensor) -> torch.Tensor:
    return z if p.name == "float32" else torch.complex(p.x(z.real),
                                                       p.x(z.imag))


def invert(p: Precision, ap: dict, mel: torch.Tensor, phase: torch.Tensor,
           pad_to: int | None = None) -> np.ndarray:
    """The float64 waveform of a (n_mels, T) log10-mel from the starting
    phase ``phase`` (n_freqs, F), radians.  ``pad_to``: the mel padded
    with its own minimum to that many frames first, and the waveform cut
    to (T − 1)·hop samples, as a batch's row is; else all
    (F − 1)·hop samples."""
    T = mel.shape[-1]
    if pad_to is not None:
        mel = torch.cat([mel, mel.min().expand(mel.shape[0], pad_to - T)], 1)
    S = magnitude(p, ap, mel.float())
    n_fft, hop, win = ap["n_fft"], ap["hop_length"], ap["win_length"]
    window = torch.hann_window(win, periodic=True, device=S.device)

    def istft(z):
        return torch.istft(_cx(p, z), n_fft, hop, win, window, center=True)

    def stft(x):
        return torch.stft(p.x(x), n_fft, hop, win, window, center=True,
                          pad_mode="reflect", return_complex=True)

    angles = torch.polar(torch.ones_like(phase), phase.float())
    mom = MOMENTUM / (1.0 + MOMENTUM)
    prev = torch.zeros_like(angles)
    for _ in range(ap.get("griffinlim_iters", 60)):
        rebuilt = stft(istft(S * angles))
        step = rebuilt - mom * prev
        angles = step / torch.clamp_min(step.abs(), 1e-16)
        prev = rebuilt
    wave = istft(S * angles).double().cpu().numpy()
    return wave if pad_to is None else wave[: (T - 1) * hop]

