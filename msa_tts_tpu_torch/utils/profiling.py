"""Profiling hooks (counterpart of ``msa_tts_tpu/utils/profiling.py``;
the reference has none).

Usage:
  * ``with trace("outdir", device):`` — capture a ``torch.profiler``
    trace (the host's ops, and the GPU's kernels when the device is a
    GPU), written for TensorBoard's profiler plugin
    (``tensorboard_trace_handler``).
  * the joint trainer takes ``profile_dir`` in its params: epoch
    ``profile_epoch`` runs under :func:`trace`.
  * ``with annotate("name"):`` — a named region in that trace
    (``torch.profiler.record_function``).
  * :class:`StepTimer` — a wall-clock accumulator whose ``stop`` can force
    a device→host read (``float()``) first, so a time covers the
    device's asynchronous work.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str, device):
    """Profile the block into ``log_dir``: CPU activity, and CUDA
    activity when ``device`` (the run's) is a GPU.  Yields the
    ``torch.profiler.profile``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)) as prof:
        yield prof


@contextlib.contextmanager
def annotate(name: str):
    """Named trace region (shows up in the profiler timeline)."""
    with torch.profiler.record_function(name):
        yield


class StepTimer:
    """Wall-clock timer with an optional forced sync; keeps a running
    summary."""

    def __init__(self):
        self.times: list[float] = []
        self._t0: float | None = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, sync_value=None) -> float:
        if sync_value is not None:
            float(sync_value)  # a device→host read waits for the device
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    @property
    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)

    def summary(self) -> dict:
        import numpy as np

        arr = np.asarray(self.times or [0.0])
        return {
            "n": len(self.times),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p95_s": float(np.percentile(arr, 95)),
        }
