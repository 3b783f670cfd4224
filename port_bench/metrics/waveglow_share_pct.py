"""WaveGlow's stamped device time (each call's first mark to its last,
summed over the calls in the traced window) over the traced window, in
%.  None where the program stamps no WaveGlow call."""

from metrics.waveglow_roofline_pct import stamped


def read(run):
    device_s = sum(s.us["total"] for s in stamped(run)) * 1e-6
    if not device_s:
        return None
    return 100.0 * device_s / run.trace.window_s
