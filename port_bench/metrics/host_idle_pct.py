"""The share of the traced window in which nothing ran on the device
while some thread of the program was in host work: its innermost open
span (``utils/profiling.py``) not a wait (``metrics/_spans.py``), in %.
None where the program records no spans."""

from metrics import _spans as S


def read(run):
    rec = S.recorder(run)
    if rec is None or not run.trace.device:
        return None
    tr = run.trace
    work = S.host_work(rec.spans, tr.t0_ns, tr.t1_ns)
    return S.pct(tr, S.intersect(S.idle(tr), work))
