"""K1, the decoder-loop kernel: block 0's time in the step's six grid
barriers over its step time, from the clock stamps the program keeps of
each launch in the traced window (``cuda_decoder.phase_breakdown``),
summed over the launches' steps, in %.  None where the program keeps
none."""

from metrics import _spans as S


def read(run):
    rec = S.recorder(run)
    if rec is None:
        return None
    lo, hi = run.trace.t0_ns, run.trace.t1_ns
    ls = [s for s in rec.stamps("k1") if lo <= s.t_ns <= hi]
    step = sum(s.us["step"] * s.steps for s in ls)
    if not step:
        return None
    return 100.0 * sum(s.us["barriers"] * s.steps for s in ls) / step
