"""K1, the decoder-loop kernel: the least time its launches need (the
larger of their bytes over the memory rate and their operations over the
weights' type's peak; ``work/tacotron.py``) over their device time in
the trace, in %.  Each served request's row counts with its own text
length; the launches are matched one to one with the device calls."""

from metrics._common import real_requests, steps
from weights import model_params
from work import peaks
from work import tacotron as WT


def read(run):
    ks = run.trace.kernels("decoder_loop_kernel")
    if not ks or len(ks) != len(run.calls):
        return None
    m = model_params(run.cfg)
    dtype = run.cfg["infer_dtype"]
    wb = 2 if dtype == "bfloat16" else 4
    bound = 0.0
    for c in run.calls:
        t_ins = [r.n_phonemes for r in real_requests(c)]
        ops = sum(WT.decoder_ops(m, 1, t, steps(run.cfg)) for t in t_ins)
        nb = WT.decoder_launch_bytes(m, t_ins, steps(run.cfg), wb)
        bound += peaks.bound_s(nb, ops, dtype)[0]
    device_s = sum(e - s for s, e, _ in ks) * 1e-9
    return 100.0 * bound / device_s
