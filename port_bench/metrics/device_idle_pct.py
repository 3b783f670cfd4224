"""The share of the traced window in which nothing ran on the device
(the union of the device's intervals, ``trace.py``), in %."""

import pbtrace as T


def read(run):
    if not run.trace.device:
        return None
    return 100.0 * (1.0 - T.busy_ns(run.trace) * 1e-9 / run.trace.window_s)
