"""One run of one cell: build the system from the cell's configuration
and weights from the seed, warm up the cell's shapes, measure for the
given seconds (traced or not), read the metrics, free the system, and
judge a sample of what the window produced against the reference."""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import os
import statistics
import sys
import time
from types import SimpleNamespace

import torch

import check
import inputs
import pbtrace as T
import weights as W
from records import span
from traffic.text import sub_seed

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "msa_tts_tpu")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark(path: str | None = None) -> dict:
    return load_json(path or os.path.join(ROOT, "BENCHMARK.json"))


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def config_file(bench: dict, name: str) -> str:
    for c in bench["configs"]:
        if c["name"] == name:
            return os.path.join(ROOT, c["file"])
    raise SystemExit(f"no config {name!r} in BENCHMARK.json")


def module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """``metrics/<name>.py``, else ``metrics/<name before the first
    dot>.py``: its ``read(run) -> float | None``."""
    for stem in (name, name.split(".")[0]):
        path = os.path.join(HERE, "metrics", f"{stem}.py")
        if os.path.exists(path):
            return module(path, f"pb_metric_{stem.replace('.', '_')}").read
    raise SystemExit(f"no reader for metric {name!r} under metrics/")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


class Ctx:
    """What a traffic generator drives and records into.  A generator
    sets ``current`` to the call it is about to make into the system, so
    that the vocoder's input mels of the requests the check may sample
    (``check.Keeper``) are kept, and whatever the mix's vocoder part keeps
    besides (``part.hook``); ``part.call_inputs`` gives a call's inputs of
    the vocoder's own."""

    def __init__(self, cfg, traffic, seed, system, device, keeper):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.system, self.tts = system, system.tts
        self.device = torch.device(device)
        self.spk_emb = inputs.speaker_vector(cfg, seed)
        self.current = None
        self.keeper = keeper
        if traffic["vocoder"] not in system.parts:
            raise SystemExit(f"the mix's vocoder {traffic['vocoder']!r} is "
                             f"not among the configuration's "
                             f"{sorted(system.parts)}")
        self.part = system.parts[traffic["vocoder"]]
        inner = self.tts._vocode

        def keep(mels, *a, **kw):
            # a device copy of each wanted row's mel, before the vocoder
            call = self.current
            for r, m in zip(call.requests if call else [], mels):
                if self.keeper.wants(r):
                    r.mel = m.detach().clone()
            return inner(mels, *a, **kw)

        self.tts._vocode = keep
        self.part.hook(self)

    def pinned(self, s: int) -> bool:
        share = float(self.traffic.get("pinned_share", 0.0))
        return (s % 10_000) < share * 10_000



def percentile(values, q: float) -> float:
    """The q-th percentile by linear interpolation (inf where a request
    failed)."""
    v = sorted(values)
    if not v:
        return float("nan")
    x = (len(v) - 1) * q / 100.0
    lo, hi = math.floor(x), math.ceil(x)
    if math.isinf(v[hi]) or math.isinf(v[lo]):
        return v[hi]
    return v[lo] + (v[hi] - v[lo]) * (x - lo)


def end_to_end(bench, cell_name, requests, t0, t1, cfg) -> dict:
    sr = cfg["audio_params"]["sample_rate"]
    out = {}
    for m in bench["end_to_end"]:
        if "workloads" in m and cell_name not in m["workloads"]:
            continue
        # a metric split by cells is the quantity before the first dot
        kind = m["name"].split(".")[0]
        if kind == "audio_s_per_s":
            done = [r for r in requests if r.wav is not None]
            out[m["name"]] = sum(len(r.wav) for r in done) / sr / (t1 - t0)
        elif kind == "latency_p95_ms":
            out[m["name"]] = 1e3 * percentile(
                [r.latency_s for r in requests], 95)
    return out


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", t_process: float | None = None,
             bench: dict | None = None, cfg: dict | None = None,
             traffic: dict | None = None, limits: dict | None = None,
             log=print, control: bool = False) -> dict:
    t_process = time.perf_counter() if t_process is None else t_process
    bench = bench or benchmark()
    c = cell(bench, cell_name)
    cfg = cfg or load_json(config_file(bench, c["config"]))
    traffic = traffic or load_json(HERE, "traffic", f"{c['traffic']}.json")
    limits = limits or load_json(HERE, "checks", f"{cell_name}.json")
    device = torch.device(device)
    cuda = device.type == "cuda"
    log(f"flags: cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32}, "
        f"matmul.allow_tf32 {torch.backends.cuda.matmul.allow_tf32}")

    import system as S
    with torch.no_grad():
        wts = W.all_weights(cfg, sub_seed(seed, "weights"), device)
        sysm = S.System(cfg, wts, device)
    del wts
    ctx = Ctx(cfg, traffic, seed, sysm, device, check.Keeper(traffic, limits))
    gen = module(os.path.join(HERE, "traffic", f"{traffic['kind']}.py"),
                 f"pb_traffic_{traffic['kind']}").Workload(ctx)
    gen.warmup()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_process
    g2p = sysm.g2p_backend()
    log(f"g2p backend: {g2p}")

    c0 = sysm.counters()
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    # an open loop spans its arrival window itself
    with (span("window") if traffic["kind"] != "open_poisson"
          else contextlib.nullcontext()):
        requests, calls, t0, t1 = gen.run(seconds)
        if cuda:
            torch.cuda.synchronize()
    if prof is not None:
        prof.__exit__(None, None, None)
    c1 = sysm.counters()
    counts = {k: c1[k] - c0[k] for k in c0}
    log(f"launches in the window: "
        f"{', '.join(f'{k} {v}' for k, v in counts.items())}; "
        f"requests {len(requests)}, device calls {len(calls)}")
    metrics = {}
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    if not trace:
        metrics = end_to_end(bench, cell_name, requests, t0, t1, cfg)
        metrics["setup_s"] = setup_s
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                "count": 1,
                "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                      if cuda else 0)}
    breakdown = None
    if trace:
        tr = T.from_profiler(prof, *_window(prof))
        # what the metric readers read
        run = SimpleNamespace(
            trace=tr, calls=calls, requests=requests, cfg=cfg,
            traffic=traffic, part=ctx.part, gen=gen, t0=t0, t1=t1,
            cudnn_tf32=torch.backends.cudnn.allow_tf32,
            matmul_tf32=torch.backends.cuda.matmul.allow_tf32)
        for m in bench["per_layer"]:
            if "workloads" in m and cell_name not in m["workloads"]:
                continue
            v = metric_reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = v
        dev_info["busy_s"] = T.busy_ns(tr) * 1e-9
        dev_info["window_s"] = tr.window_s
        breakdown = T.breakdown(tr)
        del prof
    # the served system's state is freed before the reference runs
    late = getattr(gen, "late_s", None)
    part = ctx.part
    ctx.tts = ctx.system = None
    del gen, sysm
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    attempted = len(requests)
    failed = sum(r.error is not None or r.wav is None for r in requests)
    got, ctl = check.judge(cfg, traffic, limits, seed, requests, calls,
                           device, part, log=log,
                           backend="espeak" if g2p == "espeak" else "rules",
                           control=control)
    numbers = check.limited(got, limits)
    correct = failed == 0 and check.passes(numbers)
    if late:
        log(f"open loop: {len(late)} arrivals, submitted late by median "
            f"{1e3 * statistics.median(late):.3f} ms, max "
            f"{1e3 * max(late):.3f} ms")
    res = {"correct": bool(correct), "attempted": attempted, "failed": failed,
           "metrics": {k: {"value": float(v), "unit": units[k]}
                       for k, v in metrics.items()},
           "device": dev_info}
    if breakdown is not None:
        res["breakdown"] = breakdown
    if control:
        # every reading, and each control judged by the same rule
        res["readings"] = got
        res["controls"] = {
            name: {"correct": check.passes(check.limited(r, limits)),
                   "readings": r} for name, r in ctl.items()}
    res["compared"] = {k: {"value": v, "limit": lim}
                       for k, (v, lim) in numbers.items()}
    return res


def _window(prof) -> tuple:
    """The ``pb.window`` span's bounds on the trace's clock."""
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation() and e.name() == "pb.window" \
                and "CPU" in str(e.device_type()):
            return e.start_ns(), e.start_ns() + e.duration_ns()
    raise RuntimeError("the trace holds no pb.window span")
