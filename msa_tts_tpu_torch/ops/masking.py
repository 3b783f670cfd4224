"""Sequence masks and host-side padding (counterpart of
``msa_tts_tpu/ops/masking.py``)."""

from __future__ import annotations

import numpy as np
import torch


def sequence_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """Boolean mask ``(B, max_len)``; True for valid positions
    ``t < len``."""
    ids = torch.arange(max_len, device=lengths.device)
    return ids[None, :] < lengths[:, None]


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = -1,
                    value: float = 0.0) -> np.ndarray:
    """Pad ``axis`` of a numpy array up to the next multiple of
    ``multiple``."""
    size = x.shape[axis]
    return pad_axis_to(x, -(-size // multiple) * multiple, axis, value)


def pad_axis_to(x: np.ndarray, target: int, axis: int = -1,
                value: float = 0.0) -> np.ndarray:
    """Pad ``axis`` of a numpy array up to exactly ``target`` elements."""
    size = x.shape[axis]
    if size > target:
        raise ValueError(f"axis size {size} exceeds target {target}")
    if size == target:
        return x
    pads = [(0, 0)] * x.ndim
    pads[axis if axis >= 0 else x.ndim + axis] = (0, target - size)
    return np.pad(x, pads, constant_values=value)
