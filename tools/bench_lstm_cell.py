#!/usr/bin/env python3
"""Time the LSTM-cell kernel (K4) on one CUDA GPU, on the device apart
from the host.

    python3 tools/bench_lstm_cell.py [--batch 16] [--hidden 1024]
        [--steps 400] [--turns 5] [--root DIR]
        [--out build/bench_lstm_cell.json]

At B = 16, H = 1024 with seeded random inputs and f32 and bf16
``w_hh_t``, it prints, each as the median of ``--turns`` turns with the
min-max (the kernel and the library pair alternate inside every turn):

(a) ``cold``: device time of one launch with the L2 flushed before it
    (a 256 MB buffer read, which leaves the L2 full of clean lines, then
    a spin of ~0.1 ms that keeps the device busy while the host enqueues
    the launch between two CUDA events), the median of 20 launches;
(b) ``in_scan``: device time per step inside a ``--steps``-step scan
    without the host: the scan's launches (``lstm_scan`` for the kernel)
    captured once in a ``torch.cuda.CUDAGraph`` and replayed between two
    events, divided by the steps; cross-checked by ``torch.profiler``
    over one replay: the time from the first kernel's start to the last
    one's end over the steps, and the kernels' own times summed (which
    count twice where a scan's launches overlap: a step starts, fetching
    its weights, while the one before ends).  The graph is only the
    measuring instrument here; no product path replays one;
(c) the same (a) and (b) for the library pair that computes the same
    function, ``torch.mm(h, w_hh_t)`` then
    ``aten._thnn_fused_lstm_cell`` (f32 only: the pair has no bf16
    weight path with f32 state);
(d) ``scan_wall``: ``lstm_scan``'s time per step between two events with
    the host launching (as chip_smoke's phase 10 reads it), and
    ``scan_host`` the host's own time per step to enqueue it; the same
    for the scan as one ``cuda_lstm_cell`` call a step (``per_call``)
    and for the plain scan (``backend="torch"``);
(e) the bound: the larger of the bytes (``w_hh_t``, x_proj, h, c read
    once, h' and c' written once) over 3.35 TB/s and 8·H²·B operations
    over the type's peak (67 TFLOP/s f32, 989 bf16);
(f) agreement: one launch against ``lstm_cell_reference`` in both
    types, the f32 scan against the plain scan.

Beside them, ``copy``: (a) and (b) of one small kernel (h copied, 64 KB),
the floor of the method itself (launch and event latency).
``measure`` is what chip_smoke's phase 10 calls.

Only the package's public functions are called (``cuda_lstm_cell``,
``lstm_scan``, ``lstm_cell_reference``), so ``--root DIR`` can import
``msa_tts_tpu_torch`` from another checkout (for example the parent
commit unpacked under ``build/``): run the two in turns (parent, change,
change, parent) in one call to compare them on one card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HBM_BPS = 3.35e12
PEAK = {"f32": 67e12, "bf16": 989e12}


def measure(C, B: int = 16, H: int = 1024, T: int = 400, turns: int = 5,
            seed: int = 0) -> dict:
    """(a)-(f) above for the cell module ``C`` (``cuda_lstm_cell`` of
    whichever checkout) on CUDA device 0; µs, each a dict of median, min
    and max over ``turns``."""
    import torch

    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(seed)
    xs = torch.randn(T, B, 4 * H, generator=g).to(dev)
    w32 = (torch.randn(H, 4 * H, generator=g) / H ** 0.5).to(dev)
    h0, c0 = (torch.randn(B, H, generator=g).to(dev) for _ in range(2))
    weights = {"f32": w32, "bf16": w32.to(torch.bfloat16)}
    flush = torch.ones(64 * 2 ** 20, dtype=torch.float32, device=dev)
    res = {"B": B, "H": H, "steps": T}

    def library_cell(x_proj, h, c, w, out=None):
        hy, cy, _ = torch.ops.aten._thnn_fused_lstm_cell(
            x_proj, torch.mm(h, w), c)
        return hy, cy

    def kernel_cell(x_proj, h, c, w, out=None):
        return C.cuda_lstm_cell(x_proj, h, c, w, out=out)

    def copy_cell(x_proj, h, c, w, out=None):
        """One small kernel (h copied): the method's floor."""
        out = out or (torch.empty_like(h), torch.empty_like(c))
        out[0].copy_(h)
        return out[0], c

    cells = {"kernel": kernel_cell, "library": library_cell,
             "copy": copy_cell}

    def cold_us(cell, w, n=20):
        """Median device µs of one launch after an L2 flush."""
        out = (torch.empty_like(h0), torch.empty_like(c0))
        times = []
        for _ in range(n):
            flush.sum()
            torch.cuda._sleep(200_000)     # ~0.1 ms: the host's margin
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            cell(xs[0], h0, c0, w, out)
            e.record()
            torch.cuda.synchronize()
            times.append(1e3 * s.elapsed_time(e))
        return sorted(times)[n // 2]

    def scan_graph(who, w):
        """A CUDA graph of a T-step scan: ``lstm_scan`` for the kernel
        (its launches as a product scan makes them), else ``cell`` a
        step with the state fed back."""
        hs = torch.empty(T, B, H, device=dev)
        cs = torch.empty(2, B, H, device=dev)
        hp, cp = h0.clone(), c0.clone()

        def body():
            if who == "kernel":
                C.lstm_scan(xs, hp, cp, w)
                return
            h, c = hp, cp
            for t in range(T):
                h, c = cells[who](xs[t], h, c, w, (hs[t], cs[t & 1]))

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            body()                      # warm: packing, workspaces
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            body()
        return graph

    def replay_us(graph):
        graph.replay()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        torch.cuda.synchronize()
        return 1e3 * s.elapsed_time(e) / T

    def profiled(graph):
        """The device kernels of one replay: ({name: (µs total, count)},
        µs from the first kernel's start to the last one's end)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        graph.replay()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            graph.replay()
            torch.cuda.synchronize()
        by, t0, t1 = {}, float("inf"), 0.0
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA:
                tot, n = by.get(ev.name, (0.0, 0))
                by[ev.name] = (tot + ev.time_range.elapsed_us(), n + 1)
                t0 = min(t0, ev.time_range.start)
                t1 = max(t1, ev.time_range.end)
        return by, max(t1 - t0, 0.0)

    def wall_us(fn):
        """(µs per step between two events, µs per step the host took
        to enqueue) of ``fn``, a T-step scan."""
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.record()
        fn()
        host = time.perf_counter() - t0
        e.record()
        torch.cuda.synchronize()
        return 1e3 * s.elapsed_time(e) / T, 1e6 * host / T

    def per_call_scan(w):
        """The scan as one ``cuda_lstm_cell`` call a step (its arguments
        checked and built at every step)."""
        hs = torch.empty(T, B, H, device=dev)
        cs = torch.empty(2, B, H, device=dev)
        h, c = h0, c0
        for t in range(T):
            h, c = C.cuda_lstm_cell(xs[t], h, c, w, out=(hs[t], cs[t & 1]))

    def stat(v):
        v = sorted(v)
        return {"median": v[len(v) // 2], "min": v[0], "max": v[-1]}

    # (f) agreement, before any timing
    for tag, w in weights.items():
        hk, ck = kernel_cell(xs[0], h0, c0, w)
        torch.cuda.synchronize()
        hr, cr = C.lstm_cell_reference(xs[0], h0, c0, w)
        res[f"max_abs_err_{tag}"] = max(float((hk - hr).abs().max()),
                                        float((ck - cr).abs().max()))
    hl, cl = library_cell(xs[0], h0, c0, w32)
    hr, cr = C.lstm_cell_reference(xs[0], h0, c0, w32)
    res["library_max_abs_err"] = max(float((hl - hr).abs().max()),
                                     float((cl - cr).abs().max()))
    with torch.no_grad():
        hs, _ = C.lstm_scan(xs, h0, c0, w32)
        hp, _ = C.lstm_scan(xs, h0, c0, w32, backend="torch")
    res["scan_max_abs_err_f32"] = float((hs - hp).abs().max())

    for tag, w in weights.items():
        n_bytes = (w.numel() * w.element_size()
                   + 4 * (xs[0].numel() + 4 * B * H))
        t_b, t_o = n_bytes / HBM_BPS, 8.0 * H * H * B / PEAK[tag]
        res[f"bound_us_{tag}"] = 1e6 * max(t_b, t_o)
        res[f"bound_by_{tag}"] = "bytes" if t_b >= t_o else "operations"

    cases = [("kernel", "f32"), ("kernel", "bf16"), ("library", "f32"),
             ("copy", "f32")]
    graphs = {case: scan_graph(case[0], weights[case[1]])
              for case in cases}
    series: dict[str, list] = {}
    with torch.no_grad():
        for _ in range(turns):
            for (who, tag), graph in graphs.items():
                series.setdefault(f"{who}_{tag}_cold", []).append(
                    cold_us(cells[who], weights[tag]))
                series.setdefault(f"{who}_{tag}_in_scan", []).append(
                    replay_us(graph))
            scans = {f"kernel_{tag}": (lambda w=w: C.lstm_scan(xs, h0, c0, w))
                     for tag, w in weights.items()}
            scans["kernel_f32_per_call"] = lambda: per_call_scan(w32)
            scans["plain_f32"] = lambda: C.lstm_scan(xs, h0, c0, w32,
                                                     backend="torch")
            for name, fn in scans.items():
                wall, host = wall_us(fn)
                series.setdefault(f"{name}_scan_wall", []).append(wall)
                series.setdefault(f"{name}_scan_host", []).append(host)
    res["us"] = {k: stat(v) for k, v in series.items()}
    res["profiler"] = {}
    for (who, tag), graph in graphs.items():
        by, span = profiled(graph)
        res["profiler"][f"{who}_{tag}"] = {
            "us_per_step": span / T,
            "kernel_us_per_step": sum(t for t, _ in by.values()) / T,
            "kernels": {name: {"us": t, "count": n}
                        for name, (t, n) in by.items()}}
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--hidden", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--turns", type=int, default=5)
    ap.add_argument("--root", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), ".."))
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        print("bench_lstm_cell: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from msa_tts_tpu_torch.experimental import cuda_lstm_cell as C

    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"{gpu}; package from {root}")
    res = dict(measure(C, args.batch, args.hidden, args.steps, args.turns),
               gpu=gpu, root=root)
    print(f"agreement: one step f32 {res['max_abs_err_f32']:.3e}, bf16 "
          f"{res['max_abs_err_bf16']:.3e}; library pair "
          f"{res['library_max_abs_err']:.3e}; {args.steps}-step f32 scan "
          f"{res['scan_max_abs_err_f32']:.3e}")
    print(f"B {args.batch}, H {args.hidden}, {args.steps}-step scans; µs, "
          f"median of {args.turns} turns [min-max]")
    for k, s in res["us"].items():
        print(f"  {k:24s} {s['median']:8.2f} [{s['min']:.2f}-"
              f"{s['max']:.2f}]")
    for k, p in res["profiler"].items():
        names = "; ".join(f"{n[:60]} x{v['count']}"
                          for n, v in p["kernels"].items())
        print(f"  profiler {k}: {p['us_per_step']:.2f} µs/step from the "
              f"first kernel's start to the last one's end, kernels' own "
              f"{p['kernel_us_per_step']:.2f} ({names})")
    for tag in ("f32", "bf16"):
        print(f"  bound {tag}: {res[f'bound_us_{tag}']:.2f} µs by "
              f"{res[f'bound_by_{tag}']}")
    print(gpu)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
