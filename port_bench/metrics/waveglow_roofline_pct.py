"""WaveGlow: the least time its calls in the traced window need (the
larger of their operations at the bf16 peak and their least bytes at
the memory rate, ``work/waveglow.py``, for each call's rows and real
group positions) over their stamped device time (each call's first
mark to its last, summed), in %.  None where the program stamps no
WaveGlow call."""

from metrics import _spans as S
from work import peaks
from work import waveglow as WW


def stamped(run) -> list:
    """The program's WaveGlow stamps of the calls in the traced window."""
    rec = S.recorder(run)
    if rec is None:
        return []
    lo, hi = run.trace.t0_ns, run.trace.t1_ns
    return [s for s in rec.stamps("waveglow") if lo <= s.t_ns <= hi]


def read(run):
    st = stamped(run)
    device_s = sum(s.us["total"] for s in st) * 1e-6
    if not device_s:
        return None
    v = run.cfg["vocoders"]["waveglow"]
    n_mels = run.cfg["audio_params"]["n_mels"]
    bound = sum(peaks.bound_s(WW.least_bytes(v, n_mels, s.info["positions"]),
                              WW.ops(v, n_mels, s.info["positions"]),
                              "bfloat16")[0] for s in st)
    return 100.0 * bound / device_s
