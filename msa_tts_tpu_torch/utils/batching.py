"""Batch-shape quantization shared by the serving vocoder paths
(counterpart of ``msa_tts_tpu/utils/batching.py``), on tensors that stay
on their device."""

from __future__ import annotations

import torch


def pow2_bucket(n: int) -> int:
    """Smallest power of two >= n."""
    return 1 << (max(n, 1) - 1).bit_length()


def pad_mel_batch(mels, frame_multiple: int = 32,
                  fill: str = "floor") -> torch.Tensor:
    """Stack variably-sized ``(n_mels, T_i)`` mels into one
    ``(Bp, n_mels, T_max)`` tensor: frame counts quantized to
    ``frame_multiple``, batch rows padded to a power-of-two bucket by
    repeating the last mel.  Callers slice row ``i`` of the result back
    to its own length.

    ``fill``: ``"floor"`` pads each mel with its own silence floor (right
    for Griffin-Lim); ``"zero"`` pads with zeros, which makes a purely
    convolutional consumer's padded run match its unpadded run (the
    conv's implicit zero padding and the explicit zero frames are the
    same numbers: ``HiFiGAN.inference_batch``)."""
    if fill not in ("floor", "zero"):
        raise ValueError(f"unknown fill {fill!r}: expected 'floor' or 'zero'")
    mels = [torch.as_tensor(m) for m in mels]
    t_max = max(m.shape[1] for m in mels)
    t_max = -(-t_max // frame_multiple) * frame_multiple
    padded = []
    for m in mels:
        # the floor stays a device scalar: no host synchronisation
        pad = (m.new_zeros(()) if fill == "zero" else m.min()).expand(
            m.shape[0], t_max - m.shape[1])
        padded.append(torch.cat([m, pad], dim=1))
    padded += [padded[-1]] * (pow2_bucket(len(mels)) - len(mels))
    return torch.stack(padded)
