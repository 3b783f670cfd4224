"""The open-loop cells' rate sweep, on the chip: the cell's system built
once, then for each offered rate one window of the cell's traffic at
that rate.  Prints one JSON line a rate: requests offered and completed
in time, the latency's median and 95th percentile, how far the last
third's median latency rose over the first third's (a backlog that grows
through the window), and the rows per batch.  The highest rate whose
backlog does not grow is what the system sustains; the cell's mix offers
about four fifths of it.

    python3 port_bench/sweep.py --workload <cell> --rates 10,20,30 --seconds 15 --seed 1
"""

import argparse
import copy
import json
import os
import statistics
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--seed", type=int, default=1)
    a = ap.parse_args(argv)
    import torch

    import harness
    import system as S
    import weights as W
    from traffic.text import sub_seed

    if not torch.cuda.is_available():
        return 2
    bench = harness.benchmark()
    c = harness.cell(bench, a.workload)
    cfg = harness.load_json(harness.config_file(bench, c["config"]))
    base = harness.load_json(HERE, "traffic", f"{c['traffic']}.json")
    dev = torch.device("cuda:0")
    with torch.no_grad():
        sysm = S.System(cfg, W.all_weights(cfg, sub_seed(a.seed, "weights"),
                                           dev), dev)
    path = os.path.join(HERE, "traffic", f"{base['kind']}.py")
    for rate in [float(x) for x in a.rates.split(",")]:
        traffic = copy.deepcopy(base)
        traffic["rate_per_s"] = rate
        ctx = harness.Ctx(cfg, traffic, a.seed, sysm, dev)
        gen = harness.module(path, "pb_sweep").Workload(ctx)
        gen.warmup()
        reqs, calls, t0, t1 = gen.run(a.seconds)
        lat = [r.latency_s for r in reqs]
        third = max(len(lat) // 3, 1)
        done = [r for r in reqs if r.t_done is not None]
        print(json.dumps({
            "rate_per_s": rate, "offered": len(reqs),
            "completed_in_window": sum(r.t_done <= t1 for r in done),
            "failed": len(reqs) - len(done),
            "p50_ms": 1e3 * statistics.median(lat),
            "p95_ms": 1e3 * harness.percentile(lat, 95),
            "first_third_p50_ms": 1e3 * statistics.median(lat[:third]),
            "last_third_p50_ms": 1e3 * statistics.median(lat[-third:]),
            "batch_rows": gen.batch_rows,
            "drain_s": max(r.t_done for r in done) - t1 if done else None}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
