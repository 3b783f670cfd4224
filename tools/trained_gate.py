#!/usr/bin/env python3
"""Train a narrow Tacotron with the port's MAML trainer on a synthetic
corpus until its gate fires on its own, then hold the decoder kernels to
their plain loops on those trained weights.

    python3 tools/trained_gate.py [--budget-s 600] [--out build/trained_gate.json]

The model is the tiny config of the CPU parity tests (char embedding 16,
2 encoder convolutions of 16, attention LSTM 20, decoder LSTM 28, prenet
12, attention 16, 2 postnet convolutions of 16, r = 2, 10 mel channels,
8-dim d-vectors) with ``max_decoder_steps`` 100.  The corpus is 4
speakers x 12 synthetic clips of 0.4-1.2 s; a meta-batch is the 4
speakers x 4 shots, one inner SGD step, first-order outer steps (the
cheaper FOMAML: more steps in the budget) with an Adam of lr 3e-2
(``--lr``; at 1e-2 no gate fired within 200 steps on the card; at 3e-2
one fired after 350 steps on the CPU, stopping at step 98-99 of 100).
Every
``--check-every`` meta-steps two sentences are decoded by the plain loop
in float32; the gate "fires on its own" when both stop after step 3 and
before the cap.  Then, on those weights, each sentence through the
whole-loop kernel (float32 and bfloat16 weights) and a stream through the
segment kernel against the plain decode of the same type: the stop step
(mel length) must be equal and the mels within chip_smoke's phase 3 and 4
limits.  Prints the readings and writes them as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

TINY_MODEL = {
    "mask_padding": True, "n_frames_per_step": 2,
    "symbols_embedding_dim": 16, "encoder_n_convolutions": 2,
    "encoder_embedding_dim": 16, "encoder_kernel_size": 5,
    "speaker_emb_type": "static", "speaker_embedding_dim": 8,
    "speaker_embedding_dim_lin": 6, "attention_rnn_dim": 20,
    "decoder_rnn_dim": 28, "prenet_dim": 12, "max_decoder_steps": 100,
    "gate_threshold": 0.5, "p_attention_dropout": 0.1,
    "p_decoder_dropout": 0.1, "postnet_embedding_dim": 16,
    "postnet_kernel_size": 5, "postnet_n_convolutions": 2,
    "attention_params": {
        "attention_type": "ForwardAttention", "attention_dim": 16,
        "attention_location_n_filters": 8,
        "attention_location_kernel_size": 15, "windowing": False,
        "norm": "softmax", "forward_attn": True, "trans_agent": True,
        "forward_attn_mask": False,
    },
}
AUDIO = {"n_fft": 1024, "win_length": 1024, "hop_length": 256,
         "n_mels": 10, "sample_rate": 22050, "f_min": 0.0, "f_max": 8000.0,
         "n_mfcc": 13, "griffinlim_iters": 4}
SENTENCES = ["The birch canoe slid on the smooth planks.",
             "Glue the sheet to the dark blue background."]


def _params(corpus: str, out: str, device: str, lr: str) -> dict:
    from msa_tts_tpu_torch.dataloaders.synthetic import synthetic_params

    p = synthetic_params(corpus, n_speakers=4, batch_size=4,
                         model_overrides=dict(TINY_MODEL))
    p.update(method="maml", experiment_name="trained_gate",
             output_path=out, device=device, audio_params=dict(AUDIO),
             n_epochs=100_000, meta_batch_size=4, n_inner_train=1,
             track_higher_grads=False, metatest_epoch_interval=100_000,
             ckpt_save_epoch_interval=100_000, use_tensorboard=False,
             plot_examples=False, handle_preemption=False,
             optim_outer={"optimizer_type": "Adam", "lr": lr})
    for k in ("dataset_metatrain", "dataset_metatest"):
        p[k] = dict(p[k], batch_size=4)
    return p


def _tts(trainer, **over):
    """An ``AdaptiveTTS`` on the trainer's current weights."""
    from msa_tts_tpu_torch.models.tacotron2nv import Tacotron2NV
    from msa_tts_tpu_torch.serving import AdaptiveTTS

    ts = trainer.train_state
    model = Tacotron2NV(trainer.cfg)
    model.load_state_dict({k: v.detach().cpu() for k, v in
                           {**ts.params, **ts.model_state}.items()},
                          strict=True)
    return AdaptiveTTS(dict(trainer.params, **over), model,
                       device=trainer.device)


def train_until_gate(trainer, budget_s: float, check_every: int, emb):
    """Meta-steps until the plain float32 decode of both sentences stops
    on its own (after step 3, before the cap) or the budget ends; returns
    ``(fired, steps, stop steps, seconds)``."""
    import torch

    S = trainer.cfg.max_decoder_steps
    r = trainer.cfg.n_frames_per_step
    t0 = time.perf_counter()
    epoch, stops = 0, []
    while time.perf_counter() - t0 < budget_s:
        for _ in range(check_every):
            epoch += 1
            trainer._metatrain(epoch)
        plain = _tts(trainer, decode_backend="torch")
        with torch.no_grad():
            stops = [plain.synthesize(t, spk_emb=emb, seed=i,
                                      vocoder="none").shape[-1] // r
                     for i, t in enumerate(SENTENCES)]
        print(f"  step {trainer.step_global}: loss "
              f"{trainer.last_loss:.4f}, plain decode stops at steps "
              f"{stops} (cap {S}), {time.perf_counter() - t0:.0f} s",
              flush=True)
        if all(3 < s < S for s in stops):
            return True, trainer.step_global, stops, (
                time.perf_counter() - t0)
    return False, trainer.step_global, stops, time.perf_counter() - t0


def kernels_vs_plain(trainer, emb) -> dict:
    """Each sentence through the whole-loop kernel and a stream through
    the segment kernel, float32 and bfloat16, against the plain decode of
    the same type: mel lengths and mels."""
    import numpy as np

    from chip_smoke import (
        DEC_BF16_FLIP,
        DEC_BF16_SHARE,
        SERVE_ATOL,
        SERVE_BF16_MAX,
        STREAM_ATOL,
        STREAM_BF16_ATOL,
    )
    from msa_tts_tpu_torch.models import cuda_decoder as CD

    out = {}
    for dtype in ("float32", "bfloat16"):
        kern = _tts(trainer, decode_backend="cuda", infer_dtype=dtype)
        plain = _tts(trainer, decode_backend="torch", infer_dtype=dtype)
        rows = []
        for i, text in enumerate(SENTENCES):
            n0, s0 = CD.LAUNCHES, CD.SEG_LAUNCHES
            mel = kern.synthesize(text, spk_emb=emb, seed=i, vocoder="none")
            ref = plain.synthesize(text, spk_emb=emb, seed=i,
                                   vocoder="none")
            streamed = np.concatenate(list(kern.synthesize_stream(
                text, spk_emb=emb, seed=i, vocoder="none",
                segment_steps=16)), -1)
            same = mel.shape == ref.shape
            d = np.abs(mel - ref) if same else np.array([np.inf])
            sd = (np.abs(streamed - mel).max()
                  if streamed.shape == mel.shape else np.inf)
            row = {"frames": mel.shape[-1], "plain_frames": ref.shape[-1],
                   "stream_frames": streamed.shape[-1],
                   "max_abs": float(d.max()),
                   "share_beyond_flip": float(
                       (d > DEC_BF16_FLIP["mels"]).mean()),
                   "stream_max_abs": float(sd),
                   "launches": CD.LAUNCHES - n0,
                   "seg_launches": CD.SEG_LAUNCHES - s0}
            if dtype == "float32":
                row["ok"] = bool(same and row["max_abs"] <= SERVE_ATOL
                                 and sd <= STREAM_ATOL)
            else:
                row["ok"] = bool(same and row["max_abs"] <= SERVE_BF16_MAX
                                 and row["share_beyond_flip"]
                                 <= DEC_BF16_SHARE
                                 and sd <= STREAM_BF16_ATOL)
            rows.append(row)
            print(f"  {dtype} sentence {i}: kernel {row['frames']} frames, "
                  f"plain {row['plain_frames']}, stream "
                  f"{row['stream_frames']}; mel max|d| {row['max_abs']:.3e}"
                  f", share beyond {DEC_BF16_FLIP['mels']} "
                  f"{row['share_beyond_flip']:.2e}; stream vs offline "
                  f"{row['stream_max_abs']:.3e}; launches {row['launches']}"
                  f" / {row['seg_launches']}; ok {row['ok']}")
        out[dtype] = rows
    return out


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--budget-s", type=float, default=600.0)
    ap.add_argument("--check-every", type=int, default=20)
    ap.add_argument("--lr", default="3e-2", help="the outer Adam's rate")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=str(ROOT / "build"
                                         / "trained_gate.json"))
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("trained_gate: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from msa_tts_tpu_torch.dataloaders.synthetic import make_synthetic_corpus
    from msa_tts_tpu_torch.trainers.maml import MAML

    class Tracked(MAML):
        last_loss = float("nan")

        def log_writer(self, logs):
            super().log_writer(logs)
            if "train/loss" in logs:
                self.last_loss = logs["train/loss"][0]

    tmp = tempfile.mkdtemp(prefix="trained_gate_")
    try:
        corpus = os.path.join(tmp, "corpus")
        make_synthetic_corpus(corpus, n_speakers=4, utterances_per_speaker=12,
                              spk_emb_dim=8, seed=0)
        trainer = Tracked(**_params(corpus, os.path.join(tmp, "out"),
                                    args.device, args.lr))
        emb = np.random.default_rng(5).standard_normal(8).astype(np.float32)
        fired, steps, stops, secs = train_until_gate(
            trainer, args.budget_s, args.check_every, emb)
        res = {"fired": fired, "meta_steps": steps, "stop_steps": stops,
               "train_s": secs, "cap": trainer.cfg.max_decoder_steps}
        print(f"gate fired on its own: {fired} after {steps} meta-steps "
              f"({secs:.0f} s), plain float32 decode stops at {stops}")
        if args.device == "cuda":
            from chip_smoke import _gpu_line

            res["gpu"] = _gpu_line()
            print(res["gpu"])
            res["kernels"] = kernels_vs_plain(trainer, emb)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(f"wrote {args.out}")
    ok = res["fired"] and all(r["ok"] for rows in res.get(
        "kernels", {}).values() for r in rows)
    return 0 if ok or args.device != "cuda" else 1


if __name__ == "__main__":
    sys.exit(main())
