"""Preemption handling and stall detection (the port's own copy of
``msa_tts_tpu/utils/preemption.py``).

* **Preemption.** Preemptible machines receive SIGTERM a short grace
  period before eviction.  :class:`PreemptionGuard` converts the signal
  into a cooperative stop flag; trainers poll it at safe boundaries
  (epoch end, and mid-epoch step boundaries for a prompt exit), persist
  their atomic resume state, and return cleanly.  A rerun with
  ``resume: true`` then continues from the last saved state.

* **Stalls.**  A wedged device or a hung collective manifests as a train
  step that never returns — invisible to any exception handler.
  :class:`StallWatchdog` is a daemon thread fed a heartbeat every step;
  after ``timeout_s`` without progress it dumps every thread's stack via
  :mod:`faulthandler` to a log file for the post-mortem and invokes an
  optional callback.  It detects and reports; it never kills the
  process.

Both are pure-host subsystems: enabling them costs one
``Event.is_set()`` / ``time.monotonic()`` per step.
"""

from __future__ import annotations

import faulthandler
import os
import signal
import threading
import time
from typing import Callable, Iterable

_DEFAULT_SIGNALS = (signal.SIGTERM,)


class PreemptionGuard:
    """Cooperative stop flag driven by OS signals.

    Use the process-wide :meth:`shared` instance in trainers — signal
    handlers are per-process, and a single shared event lets any number
    of sequentially-run trainers (tests run many) observe the same
    preemption notice without re-installing handlers.

    The previous handler for each signal is chained, so embedding
    applications keep their own SIGTERM behavior.

    A SECOND signal after the stop flag is already set escalates: the
    guard restores the previous disposition and re-delivers, so a
    trainer wedged between poll boundaries (the stall case) remains
    killable by a repeated graceful TERM instead of requiring KILL.
    """

    _shared: "PreemptionGuard | None" = None
    _shared_lock = threading.Lock()

    def __init__(self, signals: Iterable[signal.Signals] = _DEFAULT_SIGNALS):
        self._signals = tuple(signals)
        self._stop = threading.Event()
        self._prev: dict = {}
        self.installed = False

    # ------------------------------------------------------------ setup
    @classmethod
    def shared(cls) -> "PreemptionGuard":
        """Process-wide guard, installed on first use (thread-safe)."""
        with cls._shared_lock:
            if cls._shared is None:
                cls._shared = cls().install()
            return cls._shared

    def install(self) -> "PreemptionGuard":
        """Install signal handlers.  Outside the main thread (where
        Python forbids ``signal.signal``) the guard still works for
        programmatic :meth:`request_stop`, it just cannot observe real
        signals."""
        if self.installed:
            return self
        try:
            for sig in self._signals:
                self._prev[sig] = signal.signal(sig, self._handler)
            self.installed = True
        except ValueError:  # not in the main thread
            pass
        return self

    def uninstall(self) -> None:
        if not self.installed:
            return
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev.clear()
        self.installed = False

    def _handler(self, signum, frame):
        if self._stop.is_set():
            # Second notice: the cooperative stop was already requested
            # and the process is still here — either the trainer is
            # between poll boundaries or it is wedged (the stall case).
            # Escalate like every graceful-shutdown convention does:
            # restore the previous disposition and re-deliver, so a
            # repeated SIGTERM actually terminates instead of being
            # swallowed forever.
            self.uninstall()
            signal.raise_signal(signum)
            return
        self._stop.set()
        prev = self._prev.get(signum)
        if callable(prev):
            prev(signum, frame)

    # ------------------------------------------------------------ state
    def request_stop(self) -> None:
        """Programmatic preemption (tests, external schedulers)."""
        self._stop.set()

    def clear(self) -> None:
        """Reset after a handled preemption.  The guard deliberately
        stays set once a notice arrives — a process running several
        trainers back-to-back must stop ALL of them, not just the one
        that observed the signal.  An orchestrator that instead
        relaunches a trainer *in the same process* (``resume: true``)
        must call ``PreemptionGuard.shared().clear()`` between runs, or
        the relaunch exits at its first poll."""
        self._stop.clear()

    @property
    def should_stop(self) -> bool:
        return self._stop.is_set()

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()


class StallWatchdog:
    """Detects a train loop that stopped making progress.

    Feed :meth:`beat` once per step; if ``timeout_s`` elapses without a
    beat, the watchdog (once per stall episode):

    1. writes a timestamped all-thread stack dump to ``dump_path``
       (``faulthandler.dump_traceback``) — the artifact a hung-collective
       post-mortem actually needs;
    2. sets :attr:`stalled` and calls ``callback()`` if given.

    A subsequent beat re-arms it, so intermittent stalls are each
    reported.  The thread is a daemon: it never blocks interpreter
    exit and never kills the process itself.
    """

    def __init__(
        self,
        timeout_s: float,
        dump_path: str | None = None,
        callback: Callable[[], None] | None = None,
        poll_s: float | None = None,
    ):
        self.timeout_s = float(timeout_s)
        self.dump_path = dump_path
        self.callback = callback
        self.poll_s = poll_s if poll_s is not None else max(
            0.05, self.timeout_s / 4.0
        )
        self.stalled = False
        self.n_stalls = 0
        self._last = time.monotonic()
        self._fired = False
        self._done = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "StallWatchdog":
        self._last = time.monotonic()
        self._thread = threading.Thread(
            target=self._loop, name="msa-tts-stall-watchdog", daemon=True
        )
        self._thread.start()
        return self

    def beat(self) -> None:
        self._last = time.monotonic()
        self._fired = False  # re-arm after recovered progress

    def stop(self) -> None:
        self._done.set()
        if self._thread is not None:
            self._thread.join(timeout=self.poll_s * 4 + 1.0)
            self._thread = None

    # ----------------------------------------------------------- worker
    def _loop(self) -> None:
        while not self._done.wait(self.poll_s):
            idle = time.monotonic() - self._last
            if idle >= self.timeout_s and not self._fired:
                self._fired = True
                self.stalled = True
                self.n_stalls += 1
                self._report(idle)

    def _report(self, idle: float) -> None:
        msg = (
            f"[stall-watchdog] no step progress for {idle:.1f}s "
            f"(timeout {self.timeout_s:.1f}s)"
        )
        print(msg, flush=True)
        if self.dump_path:
            try:
                os.makedirs(
                    os.path.dirname(self.dump_path) or ".", exist_ok=True
                )
                with open(self.dump_path, "a") as f:
                    f.write(f"{msg} at {time.strftime('%F %T')}\n")
                    faulthandler.dump_traceback(file=f, all_threads=True)
                    f.write("\n")
            except OSError:
                pass
        if self.callback is not None:
            self.callback()

    def __enter__(self) -> "StallWatchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
