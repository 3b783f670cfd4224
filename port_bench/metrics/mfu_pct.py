"""The model step's share of the chip's peak: the least time the chip
needs for the model operations of every request completed in the window
(encoder, decoder steps, postnet, vocoder, counted from the shapes,
each type's operations over its peak: ``metrics/_common.py``) over the
traced window, in %."""

from metrics._common import request_seconds_at_peak


def read(run):
    done = [r for r in run.requests
            if r.t_done is not None and r.t_done <= run.t1]
    if not done:
        return None
    return 100.0 * sum(request_seconds_at_peak(run, r)
                       for r in done) / run.trace.window_s
