"""The benchmark of the PyTorch and CUDA port (``msa_tts_tpu_torch``).

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on this machine's GPU and prints, as
the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device`` and, traced,
``breakdown``; then ``compared``, each number the check compared with its
limit.  Exits with 2 and prints no result without a GPU, and with 3 if a
JAX module was loaded.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.insert(1, ROOT)
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
# every build cache at a fixed path inside the checkout (the port builds
# its kernels into build/kernels/ there by itself)
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(ROOT, "build", "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))


def log(msg: str) -> None:
    """A line of the run's account, on both streams (the result stays the
    last line of standard output)."""
    print(msg, file=sys.stderr, flush=True)
    print(msg, flush=True)


def gpu_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi: not available"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    import torch

    import harness

    bench = harness.benchmark()
    cell = harness.cell(bench, a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"{a.workload} needs {cell['chips']} CUDA device(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    log(f"card: {gpu_line()}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    res = harness.run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                           device="cuda:0", t_process=T_PROCESS, bench=bench,
                           log=log)
    bad = harness.forbidden_modules()
    if bad:
        log(f"refused: the process loaded {bad}")
        return 3
    for k, v in res["compared"].items():
        print(f"compared {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
