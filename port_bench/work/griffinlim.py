"""Griffin-Lim's operations from shapes: the pseudo-inverse of the mel
filterbank applied once, then in each iteration an inverse and a forward
real FFT of ``n_fft`` points a frame, and a last inverse; a real FFT of
N points counted as 2.5·N·log2(N) operations (half the usual 5·N·log2(N)
of a complex one), the windows and the phase updates not counted."""

from __future__ import annotations

import math


def ops(ap: dict, rows: int, frames: int) -> float:
    n_fft = ap["n_fft"]
    F = max(frames, n_fft // ap["hop_length"] + 1)
    product = 2.0 * (n_fft // 2 + 1) * ap["n_mels"] * F
    transforms = ((2 * ap.get("griffinlim_iters", 60) + 1) * F
                  * 2.5 * n_fft * math.log2(n_fft))
    return rows * (product + transforms)
