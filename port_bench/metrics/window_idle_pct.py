"""The share of the traced window in which nothing ran on the device
while the server's batcher held its window open (``serve.window``) and
no thread of the program was in host work (so that it and
``host_idle_pct`` never overlap), in %.  None where the program records
no batcher window."""

from metrics import _spans as S


def read(run):
    rec = S.recorder(run)
    if rec is None or not run.trace.device:
        return None
    tr = run.trace
    win = S.named(rec.spans, "serve.window", tr.t0_ns, tr.t1_ns)
    if not win:
        return None
    work = S.host_work(rec.spans, tr.t0_ns, tr.t1_ns)
    return S.pct(tr, S.subtract(S.intersect(S.idle(tr), win), work))
