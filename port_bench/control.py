"""Readings for the limits of ``checks/<cell>.json``, on the chip at the
cell's own size: for each seed, one short run of the cell (the served
system at the stated precisions, a window long enough to finish the
mix's longest requests) whose sample is compared with the reference,
and the controls (``check.controls``), the reference one precision step
lower in the served system's place, each judged by the rule that decides
``correct``.  Several seeds run in one process.

    python3 port_bench/control.py --workload <cell> --seeds 1,2,3 --seconds 8

Prints one JSON line per seed: the program's verdict and readings, and
each control's.  Exits with 1 unless every control comes out not
correct on every seed.  The benchmark's own runs do not run the
controls.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--requests", type=int, default=0,
                    help="requests compared a run (default: the cell's)")
    a = ap.parse_args(argv)
    import torch

    import harness

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    bench = harness.benchmark()
    c = harness.cell(bench, a.workload)
    limits = harness.load_json(HERE, "checks", f"{a.workload}.json")
    if a.requests:
        limits["requests"] = a.requests
    controls_passed = []
    for s in a.seeds.split(","):
        t = time.perf_counter()
        res = harness.run_cell(a.workload, int(s), a.seconds, False,
                               device="cuda:0", bench=bench, limits=limits,
                               control=True,
                               log=lambda m: print(m, file=sys.stderr))
        print(json.dumps({"workload": a.workload, "seed": int(s),
                          "correct": res["correct"],
                          "attempted": res["attempted"],
                          "readings": res["readings"],
                          "controls": res["controls"],
                          "metrics": res["metrics"],
                          "s": time.perf_counter() - t}), flush=True)
        controls_passed += [f"{s}:{k}" for k, c in res["controls"].items()
                            if c["correct"]]
        torch.cuda.reset_peak_memory_stats()
    if controls_passed:
        print(f"controls that came out correct: {controls_passed}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
