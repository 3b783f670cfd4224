"""The port's span recorder (``msa_tts_tpu_torch/utils/profiling.py``)
on the CPU: off, a span is a shared null context; on, spans from every
thread are kept with their ids and parents on the profiler's clock; the
decoder kernel's clock stamps reduce by phase.  The batcher's spans
against ``/stats`` are in ``test_torch_server.py``."""

import statistics
import threading

import pytest
import torch

from msa_tts_tpu_torch.models import cuda_decoder as CD
from msa_tts_tpu_torch.utils import profiling as P

CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def _empty():
    P.RECORDER.clear()
    yield
    P.RECORDER.clear()


def test_span_off_records_nothing(monkeypatch):
    def refused(*a, **kw):
        raise AssertionError("record_function opened with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    assert not P.on()
    a, b = P.annotate("tts.g2p"), P.annotate("serve.batch", 3, 2)
    assert a is b                         # one shared null context
    with a:
        with b:
            pass
    assert P.RECORDER.spans == []


def test_spans_of_a_thread_started_before_the_session():
    """A worker thread started before the profiler: its spans are kept
    (the profiler drops its ranges), with ids and parents; the caller's
    thread also gets its ranges into the profiler's trace."""
    go, done = threading.Event(), threading.Event()
    tid = []

    def worker():
        tid.append(threading.get_ident())
        go.wait(10)
        with P.annotate("serve.batch", 7, 3):
            with P.annotate("tts.decode"):
                pass
            with P.annotate("tts.sync"):
                pass
        P.RECORDER.add("serve.queue", 10, 20, ident=41)
        done.set()

    t = threading.Thread(target=worker)
    t.start()
    with torch.profiler.profile(activities=CPU) as prof:
        assert P.on()
        with P.annotate("tts.g2p"):
            go.set()
            assert done.wait(10)
    t.join(10)
    assert not P.on()
    by = {s.name: s for s in P.RECORDER.spans}
    assert set(by) == {"serve.batch", "tts.decode", "tts.sync",
                       "serve.queue", "tts.g2p"}
    batch = by["serve.batch"]
    assert (batch.thread, batch.ident, batch.rows) == (tid[0], 7, 3)
    assert batch.parent is None
    for name in ("tts.decode", "tts.sync"):
        s = by[name]
        assert s.parent == batch.sid and s.thread == tid[0]
        assert batch.start_ns <= s.start_ns <= s.end_ns <= batch.end_ns
    assert by["tts.decode"].end_ns <= by["tts.sync"].start_ns
    q = by["serve.queue"]
    assert (q.start_ns, q.end_ns, q.thread, q.ident) == (10, 20, None, 41)
    assert by["tts.g2p"].thread == threading.get_ident()
    ranges = {e.name() for e in prof.profiler.kineto_results.events()
              if e.is_user_annotation()}
    assert "tts.g2p" in ranges and "serve.batch" not in ranges


def test_span_start_on_the_traces_clock():
    """On the profiler's thread a span's start and the profiler's record
    of its range agree within 50 µs (median over 100 spans)."""
    with torch.profiler.profile(activities=CPU) as prof:
        for i in range(100):
            with P.annotate(f"s{i}"):
                pass
    ours = {s.name: s.start_ns for s in P.RECORDER.spans}
    theirs = {e.name(): e.start_ns()
              for e in prof.profiler.kineto_results.events()
              if e.is_user_annotation()}
    diffs = [abs(ours[f"s{i}"] - theirs[f"s{i}"]) for i in range(100)]
    assert statistics.median(diffs) < 50_000, statistics.median(diffs)


def test_k1_phase_breakdown_of_synthetic_stamps():
    """Per step: each interval a known length; two steps stamped, the
    third left at zero (past the launch's last step)."""
    step = torch.arange(CD.N_STAMPS - 1, dtype=torch.int64) + 1   # ns
    rows = []
    t = 1_000_000
    for k in (1, 3):                       # the second step k times longer
        row = [t]
        for d in (step * 1000 * k).tolist():
            row.append(row[-1] + d)
        rows.append(row)
        t = row[-1] + 500
    ns = torch.tensor(rows + [[0] * CD.N_STAMPS], dtype=torch.int64)
    bd = CD.phase_breakdown(ns)
    for i, ph in enumerate(CD.PHASES):
        assert bd[ph] == pytest.approx(2.0 * (i + 1))      # µs, mean of 1, 3
    barriers = [i + 1 for i, ph in enumerate(CD.PHASES)
                if ph.startswith("barrier")]
    assert len(barriers) == 6
    assert bd["barriers"] == pytest.approx(2.0 * sum(barriers))
    assert bd["step"] == pytest.approx(2.0 * sum(range(1, CD.N_STAMPS)))
    # the recorder keeps the buffer and reduces it when asked
    P.RECORDER.stamp("k1", ns, torch.tensor([2], dtype=torch.int32),
                     CD.phase_breakdown)
    (got,) = P.RECORDER.stamps("k1")
    assert got.steps == 2 and got.us == bd and P.RECORDER.stamps("k3") == []
