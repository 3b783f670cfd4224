"""K3, the sample-loop kernel: the least time its launches need (bytes
over the memory rate or operations over the matrices' type's peak,
``work/wavernn.py``; every request's real folds, each fold's sample
steps) over their device time in the trace, in %."""

from metrics._common import real_requests, wavernn_folds
from work import peaks
from work import wavernn as WW


def read(run):
    ks = run.trace.kernels("wavernn_loop_kernel")
    calls = [c for c in run.calls if c.vocoder == "wavernn"]
    if not ks or len(ks) != len(calls):
        return None
    v = run.cfg["vocoders"]["wavernn"]
    dtype = v["gen_dtype"]
    n, L = wavernn_folds(run.cfg)
    bound = 0.0
    for c in calls:
        rows = n * len(real_requests(c))
        bound += peaks.bound_s(
            WW.loop_launch_bytes(v, rows, L, 2 if dtype == "bfloat16" else 4),
            WW.loop_ops(v, rows, L), dtype)[0]
    return 100.0 * bound / (sum(e - s for s, e, _ in ks) * 1e-9)
