#!/usr/bin/env python3
"""Time a bfloat16 WaveGlow call at NVIDIA's published width on one CUDA
GPU.

    python3 tools/bench_waveglow.py [--root DIR] [--save F | --compare F]

From seeded weights (:func:`published_waveglow`), mels and latent noise:
``infer_batch`` over the benchmark cell's 16 rows of 1,000 frames
(32,000 group positions a row), each of 6 calls timed with CUDA events
after one warm call (milliseconds: least and median), then one call
under ``torch.profiler`` with its device time by class of kernel (cuBLAS
products, cuDNN convolutions, the WN passes, eager elementwise ops, the
rest) and its top kernels.  ``chip_smoke.py`` phase 18 times each WN
pass alone.

``--root DIR`` imports ``msa_tts_tpu_torch`` from another checkout (for
example the parent commit unpacked under ``build/``), so that two
versions are timed in one run on one card.  ``--save`` keeps the
waveforms; ``--compare`` holds them bit for bit to those another run
saved and exits 1 if any differ.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys

ROWS, FRAMES, CALLS = 16, 1000, 6
# first match wins: cuDNN's implicit-GEMM convolutions name "gemm" too
CLASSES = (("wn passes", ("wn_gate_kernel", "wn_residual_kernel")),
           ("cudnn", ("cudnn", "fprop", "dgrad", "conv")),
           ("cublas", ("gemm", "nvjet")),
           ("elementwise", ("elementwise",)))


def kernel_class(name: str) -> str:
    low = name.lower()
    for cls, keys in CLASSES:
        if any(k in low for k in keys):
            return cls
    return "other"


def published_waveglow(seed: int, WaveGlow=None):
    """NVIDIA's ``config.json`` widths (12 flows, 8 layers of 256
    channels), weights U(±1/√fan_in), each invertible convolution the
    channel reversal plus U(±0.1).  ``WaveGlow``: the class to build
    (another checkout's), by default this package's."""
    import torch

    if WaveGlow is None:
        from msa_tts_tpu_torch.vocoders.waveglow import WaveGlow
    model = WaveGlow(80, 12, 8, 4, 2, {"n_layers": 8, "n_channels": 256,
                                       "kernel_size": 3})
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            u = 2 * torch.rand(p.shape, generator=g) - 1
            if "convinv" in name:
                p.copy_(torch.eye(p.shape[0]).flip(1)[..., None] + 0.1 * u)
            elif p.dim() == 3:
                p.copy_(u / (p.shape[1] * p.shape[2]) ** 0.5)
            else:
                p.copy_(0.1 * u)
    return model


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=None)
    ap.add_argument("--save", default=None)
    ap.add_argument("--compare", default=None)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), ".."))
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        print("bench_waveglow: needs a CUDA device", file=sys.stderr)
        return 1
    from msa_tts_tpu_torch.vocoders import waveglow as WG
    try:
        from msa_tts_tpu_torch.vocoders import cuda_wn as CW
    except ImportError:
        CW = None

    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"{gpu}; package from {root}")
    device = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(1)
    mels = [torch.randn((80, FRAMES), generator=g) for _ in range(ROWS)]
    noise = [torch.randn((8, FRAMES * 32), generator=g) for _ in range(ROWS)]
    voc = WG.WaveGlowVocoder(published_waveglow(0, WG.WaveGlow),
                             dtype="bfloat16", device=device)
    out = voc.infer_batch(mels, noise)            # warm
    ms = []
    for _ in range(CALLS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = voc.infer_batch(mels, noise)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    line = (f"a call {min(ms):.2f} ms least, {statistics.median(ms):.2f} "
            f"median of {len(ms)}")
    if CW is not None:
        before = CW.WN_LAUNCHES
        voc.infer_batch(mels, noise)
        line += f"; {CW.WN_LAUNCHES - before} WN launches a call"
    waves = torch.stack([w.cpu() for w in out])
    same = True
    if args.compare:
        theirs = torch.load(args.compare)
        same = torch.equal(waves, theirs)
        line += ("; waveforms bit for bit as compared" if same else
                 f"; {int((waves != theirs).sum())} samples DIFFER from the "
                 "compared waveforms")
    print(line, flush=True)
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        voc.infer_batch(mels, noise)
        torch.cuda.synchronize()
    by_kernel = {}
    for e in prof.profiler.kineto_results.events():
        if "CUDA" in str(e.device_type()) and not e.is_user_annotation():
            by_kernel[e.name()] = (by_kernel.get(e.name(), 0.0)
                                   + e.duration_ns() * 1e-6)
    by_class = {}
    for k, t in by_kernel.items():
        by_class[kernel_class(k)] = by_class.get(kernel_class(k), 0) + t
    print("one profiled call, device ms by class: " + ", ".join(
        f"{c} {t:.1f}" for c, t in sorted(by_class.items(),
                                          key=lambda kv: -kv[1])))
    for k, t in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {t:8.2f} ms  {k[:90]}")
    if args.save:
        torch.save(waves, args.save)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
