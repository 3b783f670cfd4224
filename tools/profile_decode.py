#!/usr/bin/env python3
"""Where a served request's time goes on one CUDA GPU, at the full width
of examples/maml/params.yml with seeded random weights.

    python3 tools/profile_decode.py [--infer-dtype bfloat16]
        [--out build/profile_decode.json]
    python3 tools/profile_decode.py --adapt [--out ...]
    python3 tools/profile_decode.py --maml [--out ...]

Three readings, at B = 1 and B = 4, in float32 or (``--infer-dtype
bfloat16``) with the model served in bfloat16:
  1. the decoder kernel's µs per phase of a step (block 0's work and its
     time in each phase's barrier), from the device-clock stamps it
     writes when given a ``phase_ns`` buffer (500 steps, T_in 120; median
     over steps), and its ms per decode with and without the stamps
     (what the stamps cost);
  2. one served request split into stages, each closed by a device
     synchronisation, median of 5 warm runs: G2P, prenet masks, encoder,
     decoder kernel, postnet, Griffin-Lim with the copy to the host;
  3. the device's busy share over one request under ``torch.profiler``:
     the union of the device-side intervals over the request's span.

``--adapt`` takes one reading instead: one warm ``AdaptiveTTS.adapt``
(chip_smoke phase 11's four clips, the shipped loss, 5 SGD steps and the
query pass, float32) under ``torch.profiler``: its wall time, device
events and the device's busy share.  ``--maml`` does the same for one
warm MAML meta-step of chip_smoke phase 12 (examples/maml/params.yml at
full width: second order, bfloat16 compute, 4 tasks x 8 shots of the
synthetic corpus), with the step's device time by kernel name.

Every decode runs all 500 steps (random weights would stop at once).
Prints a summary and writes the numbers as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

T_IN = 120
REPS = 5


def _build_tts(device, infer_dtype="float32"):
    import torch

    from chip_smoke import SHIPPED_AUDIO, SHIPPED_MODEL
    from msa_tts_tpu_torch.models.tacotron2nv import (
        Tacotron2NV,
        config_from_params,
    )
    from msa_tts_tpu_torch.serving import N_SYMBOLS, AdaptiveTTS

    mp = dict(SHIPPED_MODEL, decoder_no_early_stopping=True,
              n_mel_channels=SHIPPED_AUDIO["n_mels"], n_symbols=N_SYMBOLS)
    model = Tacotron2NV(config_from_params(mp),
                        generator=torch.Generator().manual_seed(0))
    tts = AdaptiveTTS({"model": mp, "audio_params": dict(SHIPPED_AUDIO),
                       "decode_backend": "cuda", "infer_dtype": infer_dtype},
                      model, device=device)
    # every row stays unfinished, so each request yields all 500 steps
    with torch.no_grad():
        tts.model.decoder.gate_layer.linear_layer.bias.fill_(-1e4)
    return tts


def _events_ms(fn, n):
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def kernel_phases(tts, device, B):
    """Reading 1: per-phase µs (median over steps) and ms per decode."""
    import torch

    from msa_tts_tpu_torch.models import cuda_decoder as CD

    dcfg = tts.cfg.decoder_config()
    S = dcfg.max_decoder_steps
    g = torch.Generator().manual_seed(B)
    enc = torch.randn(B, T_IN, dcfg.encoder_embedding_dim,
                      generator=g).to(device, tts.infer_dtype)
    lens = torch.tensor([T_IN, 97, 110, 64][:B], device=device)
    masks = CD.prenet_masks(dcfg, S, B, g, device=device)
    ns = torch.zeros(S, CD.N_STAMPS, dtype=torch.int64, device=device)

    def run(stamps):
        return CD.cuda_decoder_infer(tts.model.decoder, dcfg, enc, lens,
                                     masks, phase_ns=stamps)

    run(None)
    off = _events_ms(lambda: run(None), REPS)
    on = _events_ms(lambda: run(ns), REPS)
    d = (ns[:, 1:] - ns[:, :-1]).double().cpu() / 1e3          # (S, n) µs
    step = (ns[:, -1] - ns[:, 0]).double().cpu() / 1e3
    return {
        "B": B, "T_in": T_IN, "steps": S,
        "phase_us": {name: float(d[:, i].median())
                     for i, name in enumerate(CD.PHASES)},
        "step_us_median": float(step.median()),
        "ms_per_decode": off, "ms_per_decode_with_stamps": on,
    }


def request_stages(tts, device, texts, seed=0):
    """Reading 2: one request's stages, each closed by a device sync."""
    import numpy as np
    import torch

    from msa_tts_tpu_torch.models.cuda_decoder import (
        cuda_decoder_infer,
        prenet_masks,
    )
    from msa_tts_tpu_torch.models.tacotron2nv import (
        _encode,
        postnet_residual,
    )

    cfg, dcfg = tts.cfg, tts.cfg.decoder_config()
    model, B = tts.model, len(texts)
    emb = np.random.default_rng(0).standard_normal(
        cfg.speaker_embedding_dim).astype(np.float32)
    out = {}

    def stage(name, fn):
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out[name] = time.perf_counter() - t0
        return res

    t_start = time.perf_counter()
    seqs = stage("g2p", lambda: [tts._phonemes(t) for t in texts])
    T = max(len(s) for s in seqs)
    inputs = torch.zeros(B, T, dtype=torch.int64)
    for i, s in enumerate(seqs):
        inputs[i, :len(s)] = torch.tensor(s)
    inputs = inputs.to(device)
    lens = torch.tensor([len(s) for s in seqs], device=device)
    spk = torch.as_tensor(np.tile(emb[None], (B, 1)), device=device)
    g = torch.Generator().manual_seed(seed)
    masks = stage("prenet masks", lambda: prenet_masks(
        dcfg, dcfg.max_decoder_steps, B, g, device=device))
    enc = stage("encoder", lambda: _encode(model, cfg, inputs, lens, spk,
                                           mask_pad=True).contiguous())
    mel, _, _, mel_len, _ = stage("decoder kernel", lambda: (
        cuda_decoder_infer(model.decoder, dcfg, enc, lens, masks)))
    post = stage("postnet",
                 lambda: mel + postnet_residual(model.postnet, mel))
    r = cfg.n_frames_per_step
    n = mel_len.cpu().tolist()
    mels = [post[i, :, :max(n[i], 1) * r] for i in range(B)]
    stage("griffin-lim", lambda: tts._vocode(mels, "griffinlim", g))
    out["whole request"] = time.perf_counter() - t_start
    return out


def device_busy(fn, label: str = "request"):
    """``fn()`` under ``torch.profiler``: its wall time, the union of the
    device's intervals inside it, and those device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(label):
            fn()
            torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    span = [e for e in events
            if e.name == label and e.device_type != cuda][0].time_range
    # device-side kernels and copies; not the annotation of the span
    # itself, which newer profilers also put on the device's timeline
    dev_events = [e for e in events
                  if e.device_type == cuda and e.name != label]
    dev = sorted(
        (max(e.time_range.start, span.start), min(e.time_range.end, span.end))
        for e in dev_events
    )
    busy, hi = 0.0, span.start
    for lo, end in dev:
        lo = max(lo, hi)
        if end > lo:
            busy += end - lo
            hi = end
    wall = span.elapsed_us()
    return {
        "device_events": len(dev),
        "wall_ms": wall / 1e3,
        "device_busy_ms": busy / 1e3,
        "busy_share": busy / wall if dev else None,
    }, dev_events


def busy_share(tts, texts, emb):
    """Reading 3: union of device intervals over the request's span."""
    if len(texts) == 1:
        res, events = device_busy(lambda: tts.synthesize(texts[0],
                                                         spk_emb=emb))
    else:
        res, events = device_busy(lambda: tts.synthesize_batch(
            texts, spk_emb=emb))
    res["decoder_kernel_ms"] = sum(
        e.time_range.elapsed_us() for e in events
        if "decoder_loop" in e.name) / 1e3
    return res


def adapt_busy(device):
    """The ``--adapt`` reading: one warm ``adapt`` under the profiler."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from chip_smoke import (
        SHIPPED_ADAPT,
        SHIPPED_AUDIO,
        SHIPPED_MODEL,
        TEXTS,
        _clips,
    )
    from msa_tts_tpu_torch.models.tacotron2nv import (
        Tacotron2NV,
        config_from_params,
    )
    from msa_tts_tpu_torch.serving import N_SYMBOLS, AdaptiveTTS

    mp = dict(SHIPPED_MODEL, n_mel_channels=SHIPPED_AUDIO["n_mels"],
              n_symbols=N_SYMBOLS)
    model = Tacotron2NV(config_from_params(mp),
                        generator=torch.Generator().manual_seed(0))
    tts = AdaptiveTTS(dict(SHIPPED_ADAPT, model=mp,
                           audio_params=dict(SHIPPED_AUDIO)),
                      model, device=device)
    tmp = tempfile.mkdtemp(prefix="profile_adapt_")
    try:
        wavs = _clips(tmp, 4, SHIPPED_AUDIO["sample_rate"])
        phones = [tts.g2p.text_to_phone(t) for t in TEXTS[:4]]
        emb = np.random.default_rng(5).standard_normal(
            tts.cfg.speaker_embedding_dim).astype(np.float32)
        tts.adapt(wavs, phones, emb, seed=0)                  # warm
        res, _ = device_busy(lambda: tts.adapt(wavs, phones, emb, seed=1),
                             "adapt")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return res


def maml_busy(device, n_top: int = 12):
    """The ``--maml`` reading: one warm meta-step under the profiler."""
    import shutil
    import tempfile

    import torch

    from chip_smoke import SHIPPED_MODEL, maml_params
    from msa_tts_tpu_torch.dataloaders.loader_meta import unpack_task_batch
    from msa_tts_tpu_torch.dataloaders.synthetic import make_synthetic_corpus
    from msa_tts_tpu_torch.trainers.maml import MAML

    tmp = tempfile.mkdtemp(prefix="profile_maml_")
    try:
        corpus = f"{tmp}/corpus"
        make_synthetic_corpus(corpus, n_speakers=4, utterances_per_speaker=12,
                              seed=0, spk_emb_dim=SHIPPED_MODEL[
                                  "speaker_embedding_dim"])
        t = MAML(**maml_params(corpus, f"{tmp}/out"))
        episodes = list(t.dataloader_metatrain.iter_stacked())
        _, sup, qry = episodes[0]
        sup = unpack_task_batch(sup, t.speaker_emb_type, device)
        qry = unpack_task_batch(qry, t.speaker_emb_type, device)
        K = sup["inputs"].shape[0]

        def step(i):
            masks = t._draw_masks("train", 1, i, K, t.n_inner_train + 1, sup)
            t.train_state, _ = t._maml_step(t.train_state, sup, qry, masks)

        step(0)                                                 # warm
        torch.cuda.synchronize()
        res, events = device_busy(lambda: step(1), "meta_step")
        by_name: dict = {}
        for e in events:
            by_name[e.name] = by_name.get(e.name, 0.0) + (
                e.time_range.elapsed_us() / 1e3)
        res["top_kernels_ms"] = dict(sorted(
            by_name.items(), key=lambda kv: -kv[1])[:n_top])
        res["frames"] = int(sup["melspec_lengths"].sum()
                            + qry["melspec_lengths"].sum())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return res


def main() -> int:
    import numpy as np
    import torch

    from chip_smoke import TEXTS, _gpu_line

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--infer-dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--adapt", action="store_true",
                    help="profile one adapt call instead")
    ap.add_argument("--maml", action="store_true",
                    help="profile one MAML meta-step instead")
    ap.add_argument("--out", default=str(ROOT / "build"
                                         / "profile_decode.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_decode: needs a CUDA device", file=sys.stderr)
        return 1
    torch.set_grad_enabled(False)        # as serving's inference path
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    gpu = _gpu_line()
    print(gpu)
    if args.maml:
        res = {"gpu": gpu, "maml": maml_busy(device)}
        print(f"MAML meta-step under torch.profiler: {res['maml']}")
        _write(args.out, res)
        return 0
    if args.adapt:
        res = {"gpu": gpu, "adapt": adapt_busy(device)}
        print(f"adapt under torch.profiler: {res['adapt']}")
        _write(args.out, res)
        return 0
    tts = _build_tts(device, args.infer_dtype)
    emb = np.random.default_rng(0).standard_normal(
        tts.cfg.speaker_embedding_dim).astype(np.float32)
    res = {"gpu": gpu, "infer_dtype": args.infer_dtype, "kernel": [],
           "stages": {}, "profiler": {}}
    for B in (1, 4):
        k = kernel_phases(tts, device, B)
        res["kernel"].append(k)
        print(f"kernel B={B}: step median {k['step_us_median']:.1f} us; "
              + ", ".join(f"{n} {v:.1f}" for n, v in k["phase_us"].items())
              + f"; ms/decode {k['ms_per_decode']:.3f} without stamps, "
              f"{k['ms_per_decode_with_stamps']:.3f} with")
    for B in (1, 4):
        texts = TEXTS[:B]
        request_stages(tts, device, texts)                 # warm-up
        runs = [request_stages(tts, device, texts) for _ in range(REPS)]
        med = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
        res["stages"][f"B={B}"] = med
        print(f"request stages B={B} (s, median of {REPS}): "
              + ", ".join(f"{k} {v:.4f}" for k, v in med.items()))
    for B in (1, 4):
        p = busy_share(tts, TEXTS[:B], emb)
        res["profiler"][f"B={B}"] = p
        print(f"profiler B={B}: {p}")
    _write(args.out, res)
    return 0


def _write(path: str, res: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    print(f"wrote {path}")


if __name__ == "__main__":
    sys.exit(main())
