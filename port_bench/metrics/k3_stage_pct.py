"""K3, the sample-loop kernel: block 0's time staging each phase's
inputs into shared memory (the ``stage`` part of
``cuda_gen.phase_breakdown``) over its step time, from the clock stamps
the program keeps of each launch in the traced window, summed over the
launches' steps, in %.  None where the program keeps none."""

from metrics import _spans as S


def read(run):
    rec = S.recorder(run)
    if rec is None:
        return None
    lo, hi = run.trace.t0_ns, run.trace.t1_ns
    ls = [s for s in rec.stamps("k3") if lo <= s.t_ns <= hi]
    step = sum(sum(sum(p.values()) for p in s.us.values()) * s.steps
               for s in ls)
    if not step:
        return None
    return 100.0 * sum(sum(p["stage"] for p in s.us.values()) * s.steps
                       for s in ls) / step
