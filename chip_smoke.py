#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one CUDA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. require CUDA, build the hand-written kernels from the sources in
     the checkout, print the card's name and power limit;
  2. hold the whole-loop decoder kernel against its plain PyTorch
     version on the card at the full width of examples/maml/params.yml;
  3. serve a few requests through ``AdaptiveTTS`` with seeded random
     weights and the kernel as the decode backend, and check the
     waveforms and the kernel's launch count.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it lists each kernel with its launches on the serving
path, its error against the plain version and both times.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

# examples/maml/params.yml — `model` and `audio_params`, carried as a
# dict because the machine with the GPU may have no yaml
# (tests/test_torch_serving.py holds the two equal).
SHIPPED_MODEL = {
    "attention_params": {
        "attention_dim": 128,
        "attention_location_kernel_size": 31,
        "attention_location_n_filters": 32,
        "attention_type": "ForwardAttention",
        "forward_attn": True,
        "forward_attn_mask": False,
        "norm": "softmax",
        "trans_agent": True,
        "windowing": False,
    },
    "attention_rnn_dim": 1024,
    "decoder_no_early_stopping": False,
    "decoder_rnn_dim": 1024,
    "encoder_embedding_dim": 512,
    "encoder_kernel_size": 5,
    "encoder_n_convolutions": 3,
    "gate_threshold": 0.5,
    "mask_padding": True,
    "max_decoder_steps": 500,
    "n_frames_per_step": 2,
    "p_attention_dropout": 0.1,
    "p_decoder_dropout": 0.1,
    "postnet_embedding_dim": 512,
    "postnet_kernel_size": 5,
    "postnet_n_convolutions": 5,
    "prenet_dim": 256,
    "scan_unroll": 16,
    "speaker_emb_type": "static",
    "speaker_embedding_dim": 256,
    "speaker_embedding_dim_lin": 64,
    "symbols_embedding_dim": 512,
    "use_residual_encoder": False,
}
SHIPPED_AUDIO = {
    "f_max": 8000.0,
    "f_min": 0.0,
    "griffinlim_iters": 60,
    "hop_length": 256,
    "n_fft": 1024,
    "n_mels": 80,
    "n_mfcc": 13,
    "sample_rate": 22050,
    "win_length": 1024,
}

ATOL = 1e-4          # kernel vs plain, f32, first CHECK_STEPS steps
CHECK_STEPS = 64
T_IN = 120
# served log-mel, kernel vs plain decode over all 500 steps: the f32
# summation orders differ, and the AR feedback carries that through
SERVE_ATOL = 1e-3


def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def _time_ms(fn, n: int) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def kernel_vs_plain(tts, device, seed: int = 0) -> dict:
    """Phase 2: the decoder kernel against the plain loop at full width,
    on the serving model's decoder, with the same encoder outputs and
    prenet masks."""
    import torch

    from msa_tts_tpu_torch.models import cuda_decoder as CD
    from msa_tts_tpu_torch.models.decoder import decoder_infer

    dcfg = tts.cfg.decoder_config()._replace(early_stopping=False)
    decoder = tts.model.decoder
    g = torch.Generator().manual_seed(seed)
    S, E = dcfg.max_decoder_steps, dcfg.encoder_embedding_dim
    r = dcfg.n_frames_per_step
    res = {"max_abs_err": 0.0}
    for B in (1, 4):
        enc = torch.randn(B, T_IN, E, generator=g).to(device)
        lens = torch.tensor([T_IN, 97, 110, 64][:B], device=device)
        masks = CD.prenet_masks(dcfg, S, B, g, device=device)
        plain = decoder_infer(decoder, dcfg, enc, lens, masks)
        kern = CD.cuda_decoder_infer(decoder, dcfg, enc, lens, masks)
        torch.cuda.synchronize()
        n = CHECK_STEPS
        for name, a, b, cut in zip(
            ("mels", "gates", "aligns"), kern[:3], plain[:3],
            (n * r, n * r, n),
        ):
            win = (a[..., :cut] if name != "aligns" else a[:, :cut])
            ref = (b[..., :cut] if name != "aligns" else b[:, :cut])
            err = float((win - ref).abs().max())
            whole = float((a - b).abs().max())
            print(f"  B={B} {name}: max|d| first {n} steps {err:.3e}, "
                  f"whole run {whole:.3e}")
            if not err <= ATOL:
                raise AssertionError(
                    f"kernel vs plain, B={B}, {name}: {err} > {ATOL}"
                )
            res["max_abs_err"] = max(res["max_abs_err"], err)
        if int(kern[4]) != S or int(plain[4]) != S:
            raise AssertionError("no-early-stop runs must take all S steps")
        k_ms = _time_ms(
            lambda: CD.cuda_decoder_infer(decoder, dcfg, enc, lens, masks), 5
        )
        p_ms = _time_ms(
            lambda: decoder_infer(decoder, dcfg, enc, lens, masks), 1
        )
        res["ms"], res["plain_ms"] = k_ms, p_ms
        print(f"  B={B}: kernel {1e3 * k_ms / S:.1f} us/step, plain "
              f"{1e3 * p_ms / S:.1f} us/step ({S} steps, T_in {T_IN})")

    # early stopping at B = 4 on the same inputs: shift the gate bias (the
    # gate does not feed back, so the trajectory is unchanged) so that
    # every row has stopped by the step where the row with the lowest
    # peak gate peaks; then stop steps and mel_lengths must be equal
    gates = plain[1][:, ::r][:, :200]
    shift = 0.05 - float(gates.max(dim=1).values.min())
    cfg = dcfg._replace(early_stopping=True)
    bias = decoder.gate_layer.linear_layer.bias
    with torch.no_grad():
        bias += shift
    try:
        plain = decoder_infer(decoder, cfg, enc, lens, masks)
        kern = CD.cuda_decoder_infer(decoder, cfg, enc, lens, masks)
    finally:
        with torch.no_grad():
            bias -= shift
    n_run = int(plain[4])
    prob = torch.sigmoid(plain[1][:, ::r][:, :n_run])
    closest = float((prob - cfg.gate_threshold).abs().min())
    ml_k, ml_p = kern[3].tolist(), plain[3].tolist()
    print(f"  early stop B=4: closest gate to threshold {closest:.3e}; "
          f"mel_lengths kernel {ml_k} plain {ml_p}, n_steps kernel "
          f"{int(kern[4])} plain {n_run}")
    if closest <= 1e-4:
        raise AssertionError(
            "a gate lies within 1e-4 of the threshold: pick another seed"
        )
    if ml_k != ml_p or int(kern[4]) != n_run or n_run >= S:
        raise AssertionError("early-stopping run: stop steps differ")
    return res


TEXTS = [
    "The birch canoe slid on the smooth planks.",
    "Glue the sheet to the dark blue background.",
    "It is easy to tell the depth of a well.",
    "These days a chicken leg is a rare dish.",
]


def serve(tts, device) -> int:
    """Phase 3: two single requests and one batch of four through
    ``AdaptiveTTS`` with the CUDA decode backend; returns the number of
    decoder-kernel launches they made.  Then one request's mel against
    the same request decoded by the plain loop."""
    import numpy as np
    import torch

    from msa_tts_tpu_torch.models import cuda_decoder as CD
    from msa_tts_tpu_torch.serving import AdaptiveTTS

    emb = np.random.default_rng(0).standard_normal(
        tts.cfg.speaker_embedding_dim).astype(np.float32)
    hop = tts.params["audio_params"]["hop_length"]
    # Random weights fire the gate at once, and a request's mel is cut at
    # its gate (mel_lengths) even without early stopping.  A gate bias of
    # -1e4 keeps every row unfinished, so each request decodes all
    # max_decoder_steps and yields that many frames of audio.
    with torch.no_grad():
        tts.model.decoder.gate_layer.linear_layer.bias.fill_(-1e4)
    n_frames = tts.cfg.max_decoder_steps * tts.cfg.n_frames_per_step
    want = hop * (n_frames - 1)
    CD.LAUNCHES = 0
    wavs = []
    for i, text in enumerate(TEXTS[:2]):
        t0 = time.perf_counter()
        wavs.append(tts.synthesize(text, spk_emb=emb, seed=i))
        print(f"  synthesize #{i}: {time.perf_counter() - t0:.3f} s wall, "
              f"{len(wavs[-1])} samples")
    t0 = time.perf_counter()
    batch = tts.synthesize_batch(TEXTS, spk_emb=emb, seed=2)
    dt = time.perf_counter() - t0
    print(f"  synthesize_batch x{len(TEXTS)}: {dt:.3f} s wall "
          f"({dt / len(TEXTS):.3f} s per request)")
    launches = CD.LAUNCHES
    if launches != 3:
        raise AssertionError(f"{launches} kernel launches for 3 decodes")
    # the same request decoded by the plain loop must give the same mel
    mel = tts.synthesize(TEXTS[0], spk_emb=emb, seed=0, vocoder="none")
    plain_tts = AdaptiveTTS(dict(tts.params, decode_backend="torch"),
                            tts.model, device=device)
    ref = plain_tts.synthesize(TEXTS[0], spk_emb=emb, seed=0,
                               vocoder="none")
    err = float(np.abs(mel - ref).max())
    print(f"  request mel, kernel vs plain decode: max|d| {err:.3e} "
          f"(tolerance {SERVE_ATOL})")
    if mel.shape != ref.shape or not err <= SERVE_ATOL:
        raise AssertionError(f"served mel differs from plain decode: {err}")
    wavs += batch
    for w in wavs:
        if w.shape != (want,) or not np.isfinite(w).all():
            raise AssertionError(
                f"waveform of shape {w.shape} (want ({want},)) or not finite"
            )
    print(f"  decoder kernel launches: {launches} for 3 decodes; "
          f"all waveforms finite, {want} samples")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    from msa_tts_tpu_torch.kernels import build
    from msa_tts_tpu_torch.models import cuda_decoder as CD

    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    CD._lib()
    print(f"phase 1: kernels built/loaded in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, (sec, log) in build.build_log.items():
        print(f"  nvcc {name}: {sec:.1f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print("   ", line.strip())
    gpu = _gpu_line()
    print(gpu)

    from msa_tts_tpu_torch.models.tacotron2nv import (
        Tacotron2NV,
        config_from_params,
    )
    from msa_tts_tpu_torch.serving import N_SYMBOLS, AdaptiveTTS

    mp = dict(SHIPPED_MODEL, decoder_no_early_stopping=True,
              n_mel_channels=SHIPPED_AUDIO["n_mels"], n_symbols=N_SYMBOLS)
    model = Tacotron2NV(config_from_params(mp),
                        generator=torch.Generator().manual_seed(0))
    tts = AdaptiveTTS(
        {"model": mp, "audio_params": dict(SHIPPED_AUDIO),
         "decode_backend": "cuda"},
        model, device=device,
    )

    print("phase 2: decoder kernel vs plain PyTorch at full width")
    k = kernel_vs_plain(tts, device)
    print("phase 3: serve requests (seeded random weights, cuda decode)")
    launches = serve(tts, device)

    print(json.dumps({"kernels": [{
        "name": "decoder_loop",
        "route": "cuda",
        "source": "msa_tts_tpu_torch/csrc/decoder_loop.cu",
        "replaces": "msa_tts_tpu/models/pallas_decoder.py:458",
        "launches": launches,
        "max_abs_err": k["max_abs_err"],
        "ms": k["ms"],
        "plain_ms": k["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
