"""Sequence masks (counterpart of ``msa_tts_tpu/ops/masking.py``)."""

from __future__ import annotations

import torch


def sequence_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """Boolean mask ``(B, max_len)``; True for valid positions
    ``t < len``."""
    ids = torch.arange(max_len, device=lengths.device)
    return ids[None, :] < lengths[:, None]
