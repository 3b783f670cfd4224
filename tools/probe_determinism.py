#!/usr/bin/env python3
"""Is a bfloat16 training step reproducible on the card, and if not, what
makes it differ?

    python3 tools/probe_determinism.py [--modes a,b,...] [--out build/determinism.json]

Each mode runs in a fresh process.  There the step (``--kind plain``:
the gradient of the training loss, B 8, T_in 48, T_mel 160; ``maml2`` /
``maml1``: a second- / first-order MAML meta-step of two tasks of B 4,
T_in 32, T_mel 112, one inner step, SGD outer of lr 1, the clip at 1) of
the
shipped model (``chip_smoke.SHIPPED_MODEL`` at full width,
``compute_dtype: bfloat16`` as ``TrainerBase._loss_for_batch`` computes
it, fixed dropout masks) is taken on one batch as the process's first
step, then again after four steps on a larger
batch, then once more.  For each pair the largest difference of the loss,
the gradients and the new batch-norm statistics is printed, with the
parameters whose gradients differ most; a SHA-1 of the last step's
results lets two processes be compared, and the last step's wall time
is printed.

Modes (each sets what its name says before the first step):
  default       nothing
  cudnn_det     torch.backends.cudnn.deterministic
  det           cudnn_det + torch.use_deterministic_algorithms and
                CUBLAS_WORKSPACE_CONFIG=:4096:8
  det_v7        det + TORCH_CUDNN_V8_API_DISABLED=1
  det_nocudnn   det + torch.backends.cudnn.enabled = False
  det_prewarm   det + 8 GiB allocated and freed before the first step
  det_noreduce  det + no bf16 reduced-precision reductions in cuBLAS
  det_nolt      det + DISABLE_ADDMM_CUDA_LT=1 (no cuBLASLt for addmm)
  det_lt        det + preferred_blas_library("cublaslt")
  det_unified   det + TORCH_CUBLASLT_UNIFIED_WORKSPACE=1
  det_ltws      det + CUBLASLT_WORKSPACE_SIZE=32768
  det_warm_bwd  det + a small double backward before the first step
  det_warm_full det + one step on the larger batch before the first
  repro_warm_full  repro + one step on the larger batch before the first
  cost          repro's settings, the step timed with the backward on the
                engine's worker thread and on the calling thread, in turns
``--kind ops`` instead takes Hessian-vector products of the decoder's
pieces alone (location convolution and dense, energies and softmax, the
context, an LSTM cell, a biased linear layer) at their shipped shapes:
first, after the allocator's cached blocks were refilled, and again.
  repro         what ``utils.determinism.make_reproducible`` sets
  f32_det       det with compute_dtype float32 (the control)
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

MODES = ["default", "cudnn_det", "det", "det_v7", "det_nocudnn",
         "det_prewarm", "det_noreduce", "repro", "f32_det"]


ENV = {"det_v7": {"TORCH_CUDNN_V8_API_DISABLED": "1"},
       "det_nolt": {"DISABLE_ADDMM_CUDA_LT": "1"},
       "det_unified": {"TORCH_CUBLASLT_UNIFIED_WORKSPACE": "1"},
       "det_ltws": {"CUBLASLT_WORKSPACE_SIZE": "32768"}}


def child(mode: str, kind: str, over: dict) -> dict:
    if mode.startswith("det") or mode == "f32_det":
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    os.environ.update(ENV.get(mode, {}))
    import torch

    import chip_smoke
    from msa_tts_tpu_torch.models.loss import tacotron2_loss
    from msa_tts_tpu_torch.models.tacotron2nv import (
        Tacotron2NV,
        config_from_params,
        dropout_masks,
    )
    from msa_tts_tpu_torch.serving import N_SYMBOLS

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if mode != "default" and not mode.startswith("repro"):
        torch.backends.cudnn.deterministic = True
    if mode.startswith("det") or mode == "f32_det":
        torch.use_deterministic_algorithms(True)
    if mode == "det_nocudnn":
        torch.backends.cudnn.enabled = False
    if mode == "det_lt":
        torch.backends.cuda.preferred_blas_library("cublaslt")
    if mode == "det_noreduce":
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = (
            False)
    if mode.startswith("repro"):
        from msa_tts_tpu_torch.utils.determinism import make_reproducible

        make_reproducible(dev)
    if mode == "det_prewarm":
        x = torch.empty(8 << 30, dtype=torch.uint8, device=dev)
        del x
    if mode == "det_warm_bwd":
        # a small double backward first: the backward's library state
        for dt in (torch.float32, torch.bfloat16):
            w = torch.randn(64, 64, device=dev, dtype=dt, requires_grad=True)
            b = torch.randn(64, device=dev, dtype=dt, requires_grad=True)
            x = torch.randn(8, 64, device=dev, dtype=dt)
            y = torch.nn.functional.linear(x, w, b).tanh().sum()
            g, = torch.autograd.grad(y, w, create_graph=True)
            g.float().sum().backward()
        torch.cuda.synchronize(dev)
    bf16 = mode != "f32_det"

    mp = dict(chip_smoke.SHIPPED_MODEL, n_symbols=N_SYMBOLS,
              n_mel_channels=80, num_speakers=1, **over)
    cfg = config_from_params(mp)
    sd = Tacotron2NV(cfg, generator=torch.Generator().manual_seed(0)) \
        .state_dict()
    with torch.device("meta"):
        model = Tacotron2NV(cfg)
    names = [k for k, _ in model.named_parameters()]
    params = {k: sd[k].to(dev) for k in names}
    state = {k: v.to(dev) for k, v in sd.items() if k not in params}

    def batch(B, T_in, T_mel, seed):
        g = torch.Generator().manual_seed(seed)
        lens = torch.randint(T_in // 2, T_in + 1, (B,), generator=g)
        lens[0] = T_in
        lens = lens.sort(descending=True).values
        mlens = torch.randint(T_mel // 2, T_mel + 1, (B,), generator=g)
        ids = torch.randint(1, 60, (B, T_in), generator=g)
        ids = ids * (torch.arange(T_in)[None] < lens[:, None])
        stop = (torch.arange(T_mel)[None] >= mlens[:, None] - 1).float()
        return {
            "inputs": ids.to(dev), "input_lengths": lens.to(dev),
            "melspecs": torch.randn(B, 80, T_mel, generator=g).to(dev),
            "melspec_lengths": mlens.to(dev),
            "speaker_vecs": torch.randn(B, 256, generator=g).to(dev),
            "stop_labels": stop.to(dev),
        }, {k: ([x.to(dev) for x in v] if isinstance(v, list) else
                v.to(dev))
            for k, v in dropout_masks(cfg, B, T_in, T_mel, g,
                                      device="cpu").items()}

    def forward_loss(p, ms_f32, b, masks):
        q, ms, bb = p, ms_f32, dict(b)
        if bf16:
            q = {k: v.to(torch.bfloat16) for k, v in p.items()}
            ms = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
                  for k, v in ms_f32.items()}
            for k in ("melspecs", "speaker_vecs"):
                bb[k] = bb[k].to(torch.bfloat16)
        outs, new = torch.func.functional_call(
            model, {**q, **ms},
            (bb["inputs"], bb["input_lengths"], bb["melspecs"],
             bb["melspec_lengths"], bb["speaker_vecs"], masks))
        outs = [o.float() for o in outs]
        loss = tacotron2_loss(outs, (b["melspecs"], b["stop_labels"]),
                              b["melspec_lengths"],
                              n_frames_per_step=cfg.n_frames_per_step,
                              reduction="none", pos_weight=6.0)
        return loss, {**ms_f32, **{k: v.float() for k, v in new.items()}}

    if kind == "plain":
        def step(b, masks):
            p = {k: v.detach().requires_grad_() for k, v in params.items()}
            loss, new = forward_loss(p, state, b, masks)
            grads = torch.autograd.grad(loss, [p[k] for k in names])
            torch.cuda.synchronize(dev)
            return {"loss": loss.detach().float().cpu(),
                    **{"g." + k: g.float().cpu()
                       for k, g in zip(names, grads)},
                    **{"s." + k: v.detach().float().cpu()
                       for k, v in new.items()}}
    else:
        from msa_tts_tpu_torch.meta.maml import make_maml_step
        from msa_tts_tpu_torch.optim import TrainState, make_optimizer

        # SGD with lr 1: the new weights carry the clipped meta-gradient
        outer = make_optimizer({"optimizer_type": "SGD", "lr": "1.0"})
        maml = make_maml_step(
            forward_loss, make_optimizer({"optimizer_type": "SGD",
                                          "lr": "1e-2"}),
            outer, 1, second_order=kind == "maml2", clip_thresh=1.0)
        ts = TrainState(params, state, outer.init(params), 0)

        def step(b, masks):
            # two tasks: the batch and its mirror, support = query
            sup = {k: torch.stack([v, v.flip(0)]) for k, v in b.items()}
            m = [[masks, masks], [masks, masks]]
            new, met = maml(ts, sup, sup, m)
            torch.cuda.synchronize(dev)
            return {"loss": met.loss.float().cpu(),
                    "grad_norm": met.grad_norm.float().cpu(),
                    **{"w." + k: v.float().cpu()
                       for k, v in new.params.items()},
                    **{"s." + k: v.float().cpu()
                       for k, v in new.model_state.items()}}

    def diff(a, b):
        d = {k: float((a[k] - b[k]).abs().max()) for k in a}
        worst = sorted(((v, k) for k, v in d.items() if v > 0),
                       reverse=True)[:6]
        return {"max": max(d.values()), "loss": d["loss"],
                "n_differ": sum(v > 0 for v in d.values()),
                "worst": [[k, v] for v, k in worst]}

    def sha(r):
        h = hashlib.sha1()
        for k in sorted(r):
            h.update(r[k].numpy().tobytes())
        return h.hexdigest()[:16]

    small = kind != "plain"
    A, mA = batch(4 if small else 8, 32 if small else 48,
                  112 if small else 160, 1)
    big, mbig = batch(8 if small else 16, 48 if small else 64,
                      160 if small else 224, 2)
    if mode == "cost":
        return {"mode": mode, "kind": kind, **_cost(step, A, mA)}
    if mode.endswith("warm_full"):
        step(big, mbig)
    first = step(A, mA)
    for _ in range(4):
        step(big, mbig)
    second = step(A, mA)
    t0 = time.perf_counter()
    third = step(A, mA)
    warm_s = time.perf_counter() - t0
    return {"mode": mode, "kind": kind, "over": over,
            "torch": torch.__version__,
            "cudnn": torch.backends.cudnn.version(),
            "first_vs_later": diff(first, second),
            "later_vs_later": diff(second, third),
            "sha_first": sha(first), "sha_later": sha(third),
            "loss": float(first["loss"]), "warm_step_s": warm_s}


def _cost(step, A, mA) -> dict:
    """The warm step's wall time with the backward on the engine's worker
    thread (on) and on the calling thread (off), in turns in one process
    (on, off, off, on, ...), after two warm-up steps."""
    import statistics

    import torch

    from msa_tts_tpu_torch.utils.determinism import make_reproducible

    make_reproducible(torch.device("cuda", 0))
    for _ in range(2):
        step(A, mA)
    times = {True: [], False: []}
    for mt in (True, False, False, True, True, False, False, True):
        torch.autograd.set_multithreading_enabled(mt)
        t0 = time.perf_counter()
        step(A, mA)
        times[mt].append(time.perf_counter() - t0)
    torch.autograd.set_multithreading_enabled(False)
    return {"worker_thread_s": times[True], "calling_thread_s": times[False],
            "median_worker": statistics.median(times[True]),
            "median_calling": statistics.median(times[False])}


def ops_child(mode: str) -> dict:
    """Hessian-vector products of the decoder's pieces, each taken at its
    teacher-forced shapes (B 4, T_in 32, the shipped widths) three times:
    first, then after the allocator's cached blocks were filled with
    other values, then again."""
    if mode.startswith("det"):
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    os.environ.update(ENV.get(mode, {}))
    import torch
    import torch.nn.functional as F

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if mode.startswith("det"):
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True)
    if mode == "det_nocudnn":
        torch.backends.cudnn.enabled = False
    g = torch.Generator().manual_seed(0)
    B, T, E, A, H, F_, K = 4, 32, 768, 128, 1024, 32, 31

    def r(*shape):
        return torch.randn(*shape, generator=g).to(dev)

    consts = {"x_loc": r(B, 2, T).softmax(-1), "mem": r(B, T, E),
              "q": r(B, A), "x_in": r(B, 256 + E), "h0": r(B, H),
              "c0": r(B, H)}
    w_loc, w_dense = r(F_, 2, K) * 0.1, r(A, F_) * 0.1
    w_mem, v = r(A, E) * 0.05, r(1, A) * 0.1
    w_ih, w_hh, b = r(4 * H, 256 + E) * 0.03, r(4 * H, H) * 0.03, r(4 * H)
    cases = {
        "location_conv": (lambda p, c: F.conv1d(c["x_loc"], p[0],
                                                padding=K // 2)
                          .tanh().square().sum(), [w_loc]),
        "location_dense": (lambda p, c: (F.conv1d(
            c["x_loc"], p[0], padding=K // 2).transpose(1, 2) @ p[1].T)
            .tanh().square().sum(), [w_loc, w_dense]),
        "energies_softmax": (lambda p, c: torch.softmax(
            (torch.tanh(c["mem"] @ p[0].T + c["q"][:, None]) @ p[1].T)
            [..., 0], -1).square().sum(), [w_mem, v]),
        "context_einsum": (lambda p, c: torch.einsum(
            "bt,btd->bd", torch.softmax((c["mem"] @ p[0].T)[..., 0], -1),
            c["mem"]).tanh().square().sum(), [w_mem[:1]]),
        "lstm_cell": (lambda p, c: _cell(c["x_in"], c["h0"], c["c0"], *p)
                      .square().sum(), [w_ih, w_hh, b]),
        "linear_bias": (lambda p, c: F.linear(c["x_in"], p[0], p[1])
                        .tanh().square().sum(), [w_ih[:160], b[:160]]),
    }
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, (f, ps) in cases.items():
            def hvp():
                p = [t.to(dtype).detach().requires_grad_() for t in ps]
                c = {k: t.to(dtype) for k, t in consts.items()}
                gr = torch.autograd.grad(f(p, c).float(), p,
                                         create_graph=True)
                vec = sum((gi.float() * torch.cos(
                    torch.arange(gi.numel(), device=dev, dtype=torch.float32)
                ).reshape(gi.shape)).sum() for gi in gr)
                hv = torch.autograd.grad(vec, p)
                torch.cuda.synchronize(dev)
                return [x.float().cpu() for x in gr] + [
                    x.float().cpu() for x in hv]

            first = hvp()
            for n in (1 << 20, 1 << 24, 3 << 22):
                junk = torch.full((n,), 7.5, device=dev)
                del junk
            second = hvp()
            third = hvp()
            d = lambda a, b: max(float((x - y).abs().max())  # noqa: E731
                                 for x, y in zip(a, b))
            out[f"{name}/{str(dtype)[6:]}"] = [d(first, second),
                                               d(second, third)]
    return {"mode": mode, "kind": "ops", "diffs": out}


def _cell(x, h, c, w_ih, w_hh, b):
    i, f, gg, o = (x @ w_ih.T + h @ w_hh.T + b).chunk(4, -1)
    c = f.sigmoid() * c + i.sigmoid() * gg.tanh()
    return o.sigmoid() * c.tanh()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--modes", default=",".join(MODES))
    ap.add_argument("--out", default=str(ROOT / "build" / "determinism.json"))
    ap.add_argument("--child", default=None)
    ap.add_argument("--over", default="{}",
                    help="JSON entries over the model's params (e.g. the "
                         "freeze_* flags)")
    ap.add_argument("--kind", default="plain",
                    help="plain (a training step), maml2 or maml1 (a "
                         "second- or first-order meta-step of two tasks)")
    a = ap.parse_args()
    if a.child:
        print("RESULT " + json.dumps(
            ops_child(a.child) if a.kind == "ops"
            else child(a.child, a.kind, json.loads(a.over))))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("probe_determinism: no CUDA device", file=sys.stderr)
        return 1
    out = []
    for mode in a.modes.split(","):
        drop = {"CUBLAS_WORKSPACE_CONFIG"} | {k for e in ENV.values()
                                              for k in e}
        env = {k: v for k, v in os.environ.items() if k not in drop}
        res = subprocess.run([sys.executable, __file__, "--child", mode,
                              "--kind", a.kind, "--over", a.over],
                             capture_output=True, text=True, env=env,
                             timeout=600)
        line = [ln for ln in res.stdout.splitlines()
                if ln.startswith("RESULT ")]
        if res.returncode or not line:
            print(f"{mode}: failed\n{res.stderr[-2000:]}")
            out.append({"mode": mode, "error": res.stderr[-2000:]})
            continue
        r = json.loads(line[0][7:])
        out.append(r)
        print(json.dumps(r))
    shas = {}
    for r in out:
        if "sha_later" in r:
            shas.setdefault(r["sha_later"], []).append(r["mode"])
    print("processes with equal later steps: " + json.dumps(shas))
    os.makedirs(os.path.dirname(a.out), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
