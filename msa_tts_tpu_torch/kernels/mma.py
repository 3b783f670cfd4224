"""Layouts of the tensor-core instruction the bfloat16 kernels use
(``mma.sync.m16n8k16``), shared by the packings of the decoder kernels
(``models/cuda_decoder.py``) and the sample-loop kernel
(``vocoders/cuda_gen.py``)."""

from __future__ import annotations

import numpy as np


def frag_index(half: bool):
    """(row, column) inside a 16 x 16 weight tile (8 x 16 for ``half``)
    of each of a lane's bf16 values, in the order the A operand of
    ``mma.sync.m16n8k16`` holds them: lane = 4·group + t, registers a0-a3
    = rows group / group + 8, columns 2t, 2t+1 / + 8.  A half tile keeps
    a0 and a2 (rows 0-7)."""
    lane = np.arange(32)[:, None]
    e = np.arange(4 if half else 8)[None, :]
    g, tig, reg, hi = lane >> 2, lane & 3, e >> 1, e & 1
    if half:
        return g + 0 * e, 2 * tig + hi + 8 * reg
    return g + 8 * (reg & 1), 2 * tig + hi + 8 * (reg >> 1)
