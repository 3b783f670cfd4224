"""The 95th percentile of the server's queue wait, from a request's
submit to the start of the batch that serves it (the program's
``serve.queue`` spans of the requests submitted in the traced window),
in ms.  None where the program records none."""

from harness import percentile
from metrics import _spans as S


def read(run):
    rec = S.recorder(run)
    if rec is None:
        return None
    lo, hi = run.trace.t0_ns, run.trace.t1_ns
    waits = [(s.end_ns - s.start_ns) * 1e-9 for s in rec.spans
             if s.name == "serve.queue" and lo <= s.start_ns < hi]
    return 1e3 * percentile(waits, 95) if waits else None
