"""Profiling hooks and the port's span recorder (counterpart of
``msa_tts_tpu/utils/profiling.py``; the reference has none).

Usage:
  * ``with trace("outdir", device):`` — capture a ``torch.profiler``
    trace (the host's ops, and the GPU's kernels when the device is a
    GPU), written for TensorBoard's profiler plugin
    (``tensorboard_trace_handler``).
  * the joint trainer takes ``profile_dir`` in its params: epoch
    ``profile_epoch`` runs under :func:`trace`.
  * ``with annotate("name"):`` — a span of the program, kept by
    :data:`RECORDER` while a ``torch.profiler`` session runs and a
    no-op otherwise.

The recorder is on exactly while ``torch.autograd.profiler`` says a
session is active (its process-wide flag, which every thread reads).
Off, :func:`annotate` reads that flag and returns a shared null context:
no ``record_function``, nothing kept.  On, each span keeps its name,
start and end on the trace's host clock (``time.time_ns``: Unix-epoch
nanoseconds, as the profiler's events), its thread, its parent (the
innermost span open on that thread when it opened) and an optional
request or batch id and row count.  On the thread that runs the
profiler a span also opens a ``record_function`` range of its name: the
profiler keeps the ranges of that thread only, so a worker thread's
spans live in the recorder alone.  A span that crosses threads (a
request's wait in a queue) is added with its start and end
(:meth:`Recorder.add`).  While it is on, the decoder-loop and sample-loop
kernels also pass their clock-stamp buffers to :meth:`Recorder.stamp`,
and WaveGlow its calls' CUDA events; they stay on the device until a
reader asks for them (:meth:`Recorder.stamps`).
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler

# stamp buffers kept at most, so that a long session cannot fill the
# device (a decoder launch's is 18 int64 a step)
MAX_STAMPED = 4096


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


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    thread: int | None          # None: a span that crosses threads
    sid: int
    parent: int | None          # the enclosing span's sid on its thread
    ident: int | None = None    # a request's or a batch's id
    rows: int | None = None     # a batch's requests


class Stamps(NamedTuple):
    kind: str                   # "k1" (decoder loop), "k3" (sample loop)
    #                             or "waveglow" (a call's flows)
    t_ns: int                   # the launch, on the trace's clock
    steps: int                  # the steps (WaveGlow: marks) it stamped
    us: dict                    # the phase breakdown, µs a step (a call)
    info: dict | None = None    # the call's shape (WaveGlow: rows,
    #                             positions)


def on() -> bool:
    """True while a ``torch.profiler`` session is active (any thread)."""
    return _autograd_profiler._is_profiler_enabled


class Recorder:
    """The spans and kernel stamps of the sessions so far (see the
    module's docstring); ``clear`` drops them."""

    def __init__(self):
        self.spans: list[Span] = []
        self._stamped: list = []
        self._reduced: list[Stamps] = []
        self._ids = itertools.count(1)
        self._local = threading.local()

    def clear(self) -> None:
        self.spans, self._stamped, self._reduced = [], [], []

    def add(self, name: str, start_ns: int, end_ns: int, *,
            ident: int | None = None) -> None:
        """A span that crosses threads, with its own start and end."""
        self.spans.append(Span(name, start_ns, end_ns, None,
                               next(self._ids), None, ident))

    def stamp(self, kind: str, buf, steps, reduce,
              info: dict | None = None) -> None:
        """Keep a launch's clock-stamp buffer ``buf`` (left on the
        device; or a call's list of marks) with its step count (an int
        or a one-element device tensor), the kernel's ``reduce(stamps)
        -> dict`` and the call's shape ``info``."""
        if len(self._stamped) < MAX_STAMPED:
            self._stamped.append((kind, time.time_ns(), buf, steps, reduce,
                                  info))

    def stamps(self, kind: str) -> list[Stamps]:
        """The kept launches of ``kind``, reduced (this reads the
        device, once per launch)."""
        for k, t, buf, steps, reduce, info in self._stamped:
            n = int(steps)
            self._reduced.append(Stamps(k, t, n, reduce(buf[:n]), info))
        self._stamped = []
        return [s for s in self._reduced if s.kind == kind]

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st


class _Open:
    __slots__ = ("rec", "name", "ident", "rows", "sid", "parent", "t0",
                 "rf")

    def __init__(self, rec: Recorder, name: str, ident, rows):
        self.rec, self.name, self.ident, self.rows = rec, name, ident, rows

    def __enter__(self):
        st = self.rec._stack()
        self.parent = st[-1] if st else None
        self.sid = next(self.rec._ids)
        st.append(self.sid)
        self.rf = None
        # the profiler's own thread-local state: True on its thread only
        if torch._C._autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.rec._stack().pop()
        self.rec.spans.append(Span(self.name, self.t0, t1,
                                   threading.get_ident(), self.sid,
                                   self.parent, self.ident, self.rows))
        return False


RECORDER = Recorder()
_OFF = contextlib.nullcontext()


def annotate(name: str, ident: int | None = None, rows: int | None = None):
    """A span of the program named ``name`` (see the module's
    docstring): kept by :data:`RECORDER` while a profiler session runs,
    else a shared null context."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Open(RECORDER, name, ident, rows)
