#!/usr/bin/env python3
"""Time the WaveRNN sample-loop kernel (K3) on one CUDA GPU.

    python3 tools/bench_gen_kernel.py [--rows 1,8,44,80,320] [--steps 3850]
        [--types f32,bf16] [--root DIR] [--out build/bench_gen_kernel.json]
        [--save build/k3_samples.pt] [--compare build/k3_samples.pt]

At the default WaveRNN width, from seeded random weights, conditioning
and noise: microseconds per sample step for f32 and bf16 weight
matrices at each batch of fold rows (mixture-of-logistics output, and
the Gaussian output at 44 rows), each launch timed with CUDA events
after one warm launch.  Where the kernel offers them (this tree's does):
the step's time by phase and part from the kernel's clock stamps
(``cuda_gen.phase_breakdown``: block 0's staging, products, the rest of
its work, and its time in the phase's barrier) and the cost of one grid
barrier alone.

``--root DIR`` imports ``msa_tts_tpu_torch`` from another checkout (for
example the parent commit unpacked under ``build/``), so that two
versions of the kernel are timed in one run on one card; only what
both versions offer is measured there.  ``--check N`` also holds the
first N steps of each launch against the plain PyTorch loop.
``--save`` keeps every launch's samples; ``--compare`` holds each launch
bit for bit to the samples another run saved (for example the parent
commit's, with ``--root``) and exits 1 if any differ.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", default="1,8,44,80,320")
    ap.add_argument("--steps", type=int, default=3850)
    ap.add_argument("--root", default=None)
    ap.add_argument("--check", type=int, default=0)
    ap.add_argument("--types", default="f32,bf16")
    ap.add_argument("--save", default=None)
    ap.add_argument("--compare", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), ".."))
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        print("bench_gen_kernel: needs a CUDA device", file=sys.stderr)
        return 1
    from msa_tts_tpu_torch.kernels import build
    from msa_tts_tpu_torch.vocoders import cuda_gen as G
    from msa_tts_tpu_torch.vocoders import wavernn as W

    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"{gpu}; package from {root}")
    device = torch.device("cuda", 0)
    T = args.steps
    rows = [int(r) for r in args.rows.split(",")]
    has_stamps = "phase_ns" in inspect.signature(G.cuda_generate).parameters
    res = {"gpu": gpu, "root": root, "steps": T, "us_per_step": {},
           "phase_us": {}, "barrier_us": None}
    saved, theirs = {}, (torch.load(args.compare) if args.compare else {})

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, 1e3 * start.elapsed_time(end) / T

    cases = [("MOL", b) for b in rows] + [("GAUSS", 44)]
    b_max = max(b for _, b in cases)
    for mode in ("MOL", "GAUSS"):
        cfg = W.WaveRNNConfig(mode=mode)
        g = torch.Generator().manual_seed(0)
        model = W.WaveRNNModel(cfg, g).to(device)
        mels_up = torch.randn(b_max, T, cfg.n_mels, generator=g).to(device)
        aux = torch.randn(b_max, T, cfg.res_out_dims, generator=g).to(device)
        n1, n2 = W.generation_noise(cfg, g, T, b_max, device=device)
        for tag, dtype in (("f32", None), ("bf16", torch.bfloat16)):
            if tag not in args.types.split(","):
                continue
            gp = W.cast_generation_params(model, dtype)
            w = G.kernel_weights(gp, cfg)
            ist, ar = W.hoisted_inputs(gp, cfg, mels_up, aux)
            for m, B in cases:
                if m != mode:
                    continue
                inp = [x[:, :B].contiguous() for x in (ist, ar, n1, n2)]
                key = f"{mode} {tag} B={B}"
                out, us = timed(lambda: G.cuda_generate(w, cfg, *inp))
                line = f"{key}: {us:.2f} us/step"
                res["us_per_step"][key] = us
                saved[key] = out.cpu()
                if key in theirs:
                    same = torch.equal(saved[key], theirs[key])
                    line += "; bit for bit as compared" if same else \
                        "; DIFFERS from the compared samples"
                    res.setdefault("compared", {})[key] = same
                if has_stamps and mode == "MOL":
                    st = torch.zeros(T, G.N_STAMPS, dtype=torch.int64,
                                     device=device)
                    G.cuda_generate(w, cfg, *inp, phase_ns=st)
                    torch.cuda.synchronize()
                    bd = G.phase_breakdown(st)
                    res["phase_us"][key] = bd
                    line += "; " + "/".join(G.PARTS) + " us: " + ", ".join(
                        f"{ph} " + "/".join(f"{v:.2f}" for v in d.values())
                        for ph, d in bd.items())
                if args.check:
                    n = min(args.check, T)
                    plain = W.sample_loop(gp, cfg, *(x[:n] for x in inp))
                    d = (out[:, :n] - plain).abs()
                    line += (f"; vs plain over {n} steps: max|d| "
                             f"{float(d.max()):.2e}, share beyond 1e-3 "
                             f"{float((d > 1e-3).float().mean()):.2e}")
                print(line, flush=True)
    if hasattr(G, "barrier_us"):
        res["barrier_us"] = G.barrier_us(device=device)
        print(f"one grid barrier alone: {res['barrier_us']:.3f} us")
    for name, (sec, log) in build.build_log.items():
        print(f"nvcc {name}: {sec:.1f} s")
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln:
                print("   ", ln.strip())
    if args.save:
        torch.save(saved, args.save)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0 if all(res.get("compared", {}).values()) else 1


if __name__ == "__main__":
    sys.exit(main())
