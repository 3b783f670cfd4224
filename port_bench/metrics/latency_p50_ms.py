"""The median latency of the requests that ``latency_p95_ms`` covers
(from due time to waveform on the host), in ms."""

import statistics


def read(run):
    lat = [r.latency_s for r in run.requests]
    return 1e3 * statistics.median(lat) if lat else None
