"""The profiler's trace reduced to what the per-layer metrics read:
device intervals by kernel name, their union over the window, the idle
gaps, and the host spans (the benchmark's own ``record_function``
ranges) that were open during each gap."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Trace:
    t0_ns: int                  # the window, host clock (ns)
    t1_ns: int
    device: list                # (start_ns, end_ns, name) on the device
    spans: list                 # (start_ns, end_ns, name) host ranges

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) * 1e-9

    def kernels(self, name: str) -> list:
        """Device intervals whose name contains ``name``."""
        return [iv for iv in self.device if name in iv[2]]


def from_profiler(prof, t0_ns: int, t1_ns: int) -> Trace:
    """A finished ``torch.profiler.profile``: device events that are not
    annotations, and host user annotations, with the window given on the
    profiler's clock."""
    device, spans = [], []
    for e in prof.profiler.kineto_results.events():
        kind = str(e.device_type())
        iv = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
        if e.is_user_annotation():
            if "CPU" in kind:
                spans.append(iv)
        elif "CUDA" in kind:
            device.append(iv)
    device.sort()
    return Trace(t0_ns, t1_ns, device, spans)


def union(intervals, lo: int, hi: int) -> list:
    """The union of (start, end, ...) intervals clipped to [lo, hi], as
    sorted disjoint (start, end) pairs."""
    out = []
    for iv in sorted(intervals):
        s, e = max(iv[0], lo), min(iv[1], hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def busy_ns(tr: Trace) -> int:
    return sum(e - s for s, e in union(tr.device, tr.t0_ns, tr.t1_ns))


def idle_gaps(tr: Trace) -> list:
    """(start, end) stretches of the window in which nothing ran on the
    device, longest first."""
    gaps, t = [], tr.t0_ns
    for s, e in union(tr.device, tr.t0_ns, tr.t1_ns):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if tr.t1_ns > t:
        gaps.append((t, tr.t1_ns))
    return sorted(gaps, key=lambda g: g[0] - g[1])


# spans in which the client only waits (for an arrival, for answers, for
# the window): a gap is put down to one of them only where no thread was
# in any other span
WAITS = ("pb.sleep", "pb.drain", "pb.window")


def host_label(tr: Trace, t_ns: int) -> str:
    """The host span open at ``t_ns`` (on any thread): the innermost of
    those that are not a client's wait, else the innermost wait, else
    ``host (no span)``."""
    open_ = [(name in WAITS, e - s, name) for s, e, name in tr.spans
             if s <= t_ns < e]
    return min(open_)[2] if open_ else "host (no span)"


def breakdown(tr: Trace, n: int = 10) -> dict:
    """The device operations that took most time (seconds summed by
    name) and the longest idle gaps by what the host was doing
    (seconds summed by span name)."""
    by_op: dict = {}
    for s, e, name in tr.device:
        s, e = max(s, tr.t0_ns), min(e, tr.t1_ns)
        if e > s:
            by_op[name] = by_op.get(name, 0) + (e - s)
    by_gap: dict = {}
    for s, e in idle_gaps(tr):
        label = host_label(tr, (s + e) // 2)
        by_gap[label] = by_gap.get(label, 0) + (e - s)
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:n]
    gaps = sorted(by_gap.items(), key=lambda kv: -kv[1])[:n]
    return {"device_ops": [[k[:120], v * 1e-9] for k, v in top],
            "idle_gaps": [[k, v * 1e-9] for k, v in gaps]}
