"""HiFi-GAN generator operations from shapes: every convolution's
multiply-adds at its output length; a transposed convolution's at its
input length (each input sample meets every tap once)."""

from __future__ import annotations


def ops(h: dict, n_mels: int, rows: int, frames: int) -> float:
    ch = h["upsample_initial_channel"]
    t = frames
    macs = n_mels * ch * 7 * t
    for i, (u, k) in enumerate(zip(h["upsample_rates"],
                                   h["upsample_kernel_sizes"])):
        c = ch // 2 ** (i + 1)
        macs += 2 * c * c * k * t
        t *= u
        for kk, dils in zip(h["resblock_kernel_sizes"],
                            h["resblock_dilation_sizes"]):
            per = 2 if h["resblock"] == "1" else 1
            macs += per * len(dils) * c * c * kk * t
    macs += (ch // 2 ** len(h["upsample_rates"])) * 7 * t
    return 2.0 * rows * macs
