"""What a run records of each request and each device call."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass
class Request:
    idx: int
    text: str
    n_phonemes: int
    seed: int                   # its masks' and noise's seed
    pinned: bool = False        # its WaveRNN mixture choice pinned
    t_due: float = 0.0          # host clock, s
    t_done: float | None = None
    wav: np.ndarray | None = None
    mel: torch.Tensor | None = None   # its vocoder's input, where kept
    folds: torch.Tensor | None = None  # WaveRNN's raw folds, where kept
    error: str | None = None

    @property
    def latency_s(self) -> float:
        return float("inf") if self.t_done is None else self.t_done - self.t_due


@dataclass
class Call:
    """One call into the served system's decode: the rows it decoded
    (``rows``: the padded row count), the requests in row order, the
    vocoder, and where its prenet masks came from."""
    vocoder: str
    requests: list = field(default_factory=list)
    rows: int = 1
    mask_seed: int | None = None   # None: the served system's own draw
    t_start: float = 0.0
    t_end: float | None = None


def span(name: str):
    """A host span in the profiler's trace (a no-op when none runs)."""
    return torch.profiler.record_function(f"pb.{name}")

