"""The idle-share and breakdown arithmetic on synthetic intervals."""

import pbtrace as T


def tr():
    dev = [(10, 20, "k1"), (15, 30, "k2"), (50, 60, "k1"), (95, 120, "k3")]
    spans = [(0, 100, "pb.window"), (30, 50, "pb.inputs"),
             (60, 95, "pb.synthesize"), (70, 80, "pb.wait")]
    return T.Trace(0, 100, dev, spans)


def test_union_and_busy():
    t = tr()
    assert T.union(t.device, 0, 100) == [(10, 30), (50, 60), (95, 100)]
    assert T.busy_ns(t) == 35


def test_idle_gaps_longest_first():
    assert T.idle_gaps(tr()) == [(60, 95), (30, 50), (0, 10)]


def test_breakdown_names_the_host_span():
    b = T.breakdown(tr())
    assert b["device_ops"][0] == ["k1", 20e-9]
    labels = dict(b["idle_gaps"])
    assert labels["pb.wait"] == 35e-9       # the innermost at the midpoint
    assert labels["pb.inputs"] == 20e-9
    assert labels["pb.window"] == 10e-9


def test_kernels_by_substring():
    t = tr()
    assert len(t.kernels("k1")) == 2 and abs(t.window_s - 100e-9) < 1e-18
