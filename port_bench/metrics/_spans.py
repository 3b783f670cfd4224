"""What the readers of the program's own spans and kernel stamps share:
the recorder the served system carries (``run.gen.ctx.tts.recorder``,
None where the program has none) and interval arithmetic over sorted
disjoint (start, end) pairs on the trace's clock."""

from __future__ import annotations

import collections

import pbtrace as T

# the program's spans in which it only waits: for a first request, for
# the batcher's window, in the queue, for the device (mel lengths,
# waveforms)
WAITS = ("serve.idle", "serve.window", "serve.queue", "tts.sync",
         "tts.to_host")


def recorder(run):
    tts = getattr(getattr(run.gen, "ctx", None), "tts", None)
    return getattr(tts, "recorder", None)


def length(a) -> int:
    return sum(e - s for s, e in a)


def intersect(a, b) -> list:
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(a, b) -> list:
    """``a`` less ``b``."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > s:
                out.append((s, b[k][0]))
            s = max(s, b[k][1])
            k += 1
        if e > s:
            out.append((s, e))
    return out


def named(spans, name: str, lo: int, hi: int) -> list:
    """The union of the spans called ``name``, clipped to [lo, hi]."""
    return T.union([(s.start_ns, s.end_ns) for s in spans if s.name == name],
                   lo, hi)


def host_work(spans, lo: int, hi: int) -> list:
    """The stretches of [lo, hi] in which some thread's innermost open
    span of the program is not one of ``WAITS``: each such span less its
    children, on every thread."""
    kids = collections.defaultdict(list)
    for s in spans:
        if s.parent is not None:
            kids[s.parent].append((s.start_ns, s.end_ns))
    work = []
    for s in spans:
        if s.thread is None or s.name in WAITS:
            continue
        own = T.union([(s.start_ns, s.end_ns)], lo, hi)
        work += subtract(own, T.union(kids[s.sid], lo, hi))
    return T.union(work, lo, hi)


def idle(tr) -> list:
    """The window's stretches with nothing on the device, in order."""
    return sorted(T.idle_gaps(tr))


def pct(tr, intervals) -> float:
    return 100.0 * length(intervals) / (tr.t1_ns - tr.t0_ns)
