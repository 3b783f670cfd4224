"""Mel cepstral distortion (counterpart of ``msa_tts_tpu/ops/metrics.py``,
its numpy path): the reference's constant ``K = 10/ln(10)·sqrt(2)``,
each utterance averaged over its valid frames, then over the batch.
The functions take numpy arrays or tensors (moved to the host)."""

from __future__ import annotations

import math

import numpy as np

MCD_K = 10.0 / math.log(10.0) * math.sqrt(2.0)


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def mcd(C, C_hat) -> float:
    """MCD between two (T, D) mel-cepstra."""
    C, C_hat = _np(C), _np(C_hat)
    return float(MCD_K * np.mean(np.sqrt(np.sum((C - C_hat) ** 2,
                                                axis=-1))))


def mcd_batch(output, mel, mel_len) -> float:
    """Masked batch MCD of (B, T, D) ``output`` against ``mel`` with
    (B,) valid lengths ``mel_len``."""
    output, mel, mel_len = _np(output), _np(mel), _np(mel_len)
    T = output.shape[1]
    valid = (np.arange(T)[None, :] < mel_len[:, None]).astype(output.dtype)
    dist = np.sqrt(np.sum((mel - output) ** 2, axis=-1))          # (B, T)
    per_item = np.sum(dist * valid, axis=1) / np.maximum(
        mel_len.astype(output.dtype), 1.0)
    return float(MCD_K * np.mean(per_item))
