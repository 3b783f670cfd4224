"""The readers of the program's own spans and kernel stamps on synthetic
spans and device intervals, and each one's silence where the served
system carries no recorder (as before the program recorded any)."""

from types import SimpleNamespace
from typing import NamedTuple

import pytest

import harness
import pbtrace as T

NEW = ("queue_wait_p95_ms.latency", "window_idle_pct.latency",
       "host_idle_pct.latency", "k1_barrier_pct.latency",
       "k3_stage_pct.wavernn")


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    thread: int | None
    sid: int
    parent: int | None
    ident: int | None = None
    rows: int | None = None


class Stamps(NamedTuple):
    kind: str
    t_ns: int
    steps: int
    us: dict


class Recorder:
    def __init__(self, spans, stamps):
        self.spans, self._stamps = spans, stamps

    def stamps(self, kind):
        return [s for s in self._stamps if s.kind == kind]


def run(rec=None):
    """Window [0, 100] ns, the device busy in [10, 20] and [50, 60]; a
    batcher thread (1) and a caller (2)."""
    spans = [
        Span("serve.idle", 0, 15, 1, 1, None),
        Span("serve.window", 15, 25, 1, 2, None),
        Span("serve.batch", 25, 70, 1, 3, None, 1, 2),
        Span("tts.g2p", 25, 30, 1, 4, 3),
        Span("tts.sync", 40, 55, 1, 5, 3),
        Span("tts.to_host", 60, 65, 1, 6, 3),
        Span("serve.idle", 70, 130, 1, 7, None),
        Span("serve.submit", 12, 13, 2, 8, None),
        Span("serve.submit", 80, 81, 2, 9, None),
        Span("serve.queue", 12, 25, None, 10, None, 1),
        Span("serve.queue", 80, 100, None, 11, None, 2),
        Span("serve.queue", -30, 5, None, 12, None, 0),   # before the window
    ]
    k3 = {"gru1": {"stage": 2.0, "products": 1.0, "rest": 1.0,
                   "barrier": 0.0},
          "fc3+sample": {"stage": 0.0, "products": 1.0, "rest": 0.0,
                         "barrier": 1.0}}
    stamps = [Stamps("k1", 5, 10, {"barriers": 3.0, "step": 10.0}),
              Stamps("k1", 50, 30, {"barriers": 6.0, "step": 12.0}),
              Stamps("k1", 200, 30, {"barriers": 99.0, "step": 100.0}),
              Stamps("k3", 60, 100, k3)]
    tts = SimpleNamespace()
    if rec is not False:
        tts.recorder = rec or Recorder(spans, stamps)
    tr = T.Trace(0, 100, [(10, 20, "k"), (50, 60, "k")], [])
    return SimpleNamespace(trace=tr, gen=SimpleNamespace(
        ctx=SimpleNamespace(tts=tts)))


def read(name, r):
    return harness.metric_reader(name)(r)


def test_host_idle_is_host_work_with_the_device_idle():
    # host work: the submits, g2p and the batch's own time less its
    # children ([25, 40], [55, 60], [65, 70], [12, 13], [80, 81]); of it
    # the device is idle in [25, 40], [65, 70] and [80, 81]
    assert read("host_idle_pct.latency", run()) == pytest.approx(21.0)


def test_window_idle_leaves_host_work_out():
    # the window [15, 25] with the device idle from 20
    assert read("window_idle_pct.latency", run()) == pytest.approx(5.0)
    total = 100.0 * (1 - T.busy_ns(run().trace) / 100)
    assert (read("window_idle_pct.latency", run())
            + read("host_idle_pct.latency", run())) <= total


def test_queue_wait_p95_of_the_windows_requests():
    # the waits of the two requests submitted in the window: 13 and 20 ns
    assert read("queue_wait_p95_ms.latency", run()) == pytest.approx(
        1e3 * (13 + 0.95 * 7) * 1e-9)


def test_k1_barrier_share_of_the_windows_launches():
    assert read("k1_barrier_pct.latency", run()) == pytest.approx(
        100.0 * (3 * 10 + 6 * 30) / (10 * 10 + 12 * 30))


def test_k3_stage_share():
    assert read("k3_stage_pct.wavernn", run()) == pytest.approx(100 / 3)


@pytest.mark.parametrize("name", NEW)
def test_silent_without_a_recorder(name):
    assert read(name, run(rec=False)) is None
    assert read(name, run(rec=Recorder([], []))) in (None, 0.0)
