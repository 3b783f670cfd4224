"""WaveGlow's operations and least bytes, from shapes (NVIDIA/waveglow
``glow.py``).

One multiply-add is two operations.  At each group position every flow
applies its ``start`` (n_half → C), its conditioning (n_mel · n_group →
2 · C · n_layers), each layer's dilated convolution (C → 2C, ``kernel``
taps) and res/skip (C → 2C, the last C → C), its ``end`` (C → 2 ·
n_half) and its invertible convolution (n_rem²); the upsampler applies
n_mel × n_mel × 1,024 taps to each input frame.  The least bytes are
the weights once (bfloat16) and the mel, the noise and the waveform
once (float32).
"""

from __future__ import annotations

UPSAMPLE_KERNEL = 1024
HOP = 256


def flows(v: dict) -> list:
    """(n_half, n_rem) of each flow, in the published order."""
    n_half, n_rem, out = v["n_group"] // 2, v["n_group"], []
    for k in range(v["n_flows"]):
        if k % v["n_early_every"] == 0 and k > 0:
            n_half -= v["n_early_size"] // 2
            n_rem -= v["n_early_size"]
        out.append((n_half, n_rem))
    return out


def position_macs(v: dict, n_mels: int) -> list:
    """Multiply-adds of each flow at one group position."""
    w = v["WN_config"]
    C, n, k = w["n_channels"], w["n_layers"], w["kernel_size"]
    wn = (n_mels * v["n_group"] * 2 * C * n          # conditioning
          + n * C * 2 * C * k                        # dilated
          + (n - 1) * C * 2 * C + C * C)             # res/skip
    return [wn + h * C + C * 2 * h + r * r for h, r in flows(v)]


def frames(v: dict, positions: int) -> float:
    return positions * v["n_group"] / HOP


def ops(v: dict, n_mels: int, positions: int) -> float:
    """Operations of one pass over ``positions`` group positions (summed
    over the rows)."""
    up = n_mels * n_mels * UPSAMPLE_KERNEL * frames(v, positions)
    return 2.0 * (up + sum(position_macs(v, n_mels)) * positions)


def weights(v: dict, n_mels: int) -> int:
    """The model's weights and biases."""
    w = v["WN_config"]
    C, n, k = w["n_channels"], w["n_layers"], w["kernel_size"]
    cond = n_mels * v["n_group"]
    total = n_mels * n_mels * UPSAMPLE_KERNEL + n_mels
    for h, r in flows(v):
        total += (h + 1) * C + (C + 1) * 2 * h + (cond + 1) * 2 * C * n
        total += n * (C * k + 1) * 2 * C
        total += (n - 1) * (C + 1) * 2 * C + (C + 1) * C + r * r
    return total


def least_bytes(v: dict, n_mels: int, positions: int) -> float:
    """Weights in bfloat16, and the mel, the noise and the waveform in
    float32, each once."""
    samples = positions * v["n_group"]
    return (2.0 * weights(v, n_mels)
            + 4.0 * (n_mels * frames(v, positions) + 2 * samples))
