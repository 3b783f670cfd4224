"""Reproducible training steps on the card.

The JAX package's steps are deterministic by construction: XLA fixes
every reduction order when it compiles.  On a CUDA device the same
PyTorch step can add its gradient contributions in another order from
one call to the next: the autograd engine runs a CUDA backward on a
worker thread of its own, the nodes that a backward with
``create_graph=True`` records there are numbered by that thread's
counter, and the engine orders nodes that are ready together by those
numbers, so a second-order step's summation order depended on how many
steps the worker thread had run before (the same meta-step came out
differently as a process's first step and as a later one).
:func:`make_reproducible` runs the backward on the calling thread
instead, where every node of a step is numbered in the order the step
records it, and keeps cuDNN on its deterministic algorithms and cuBLAS
on a fixed workspace; the trainers call it when they start on a CUDA
device.
"""

from __future__ import annotations

import os

import torch


def make_reproducible(device) -> None:
    """Make every later training step on ``device`` repeat bit for bit
    from the same state (a no-op on the CPU, whose backward already runs
    on the calling thread).  Thread-local for the backward's thread; the
    cuDNN and cuBLAS settings are the process's."""
    if torch.device(device).type != "cuda":
        return
    torch.autograd.set_multithreading_enabled(False)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    # cuBLAS repeats a product bit for bit with a fixed workspace per
    # stream (read when a stream's workspace is first made)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
