#!/usr/bin/env python3
"""Settle whether the bf16 WaveRNN sample loop is right on trained weights,
against the JAX package as the reference (run on a host with jax; the
CPU is enough).

    JAX_PLATFORMS=cpu python3 tools/settle_gen_bf16.py [--steps 100] \
        [--batch 16] [--threads 4] [--out build/settle_gen_bf16.json]

1. Train a WaveRNN at the served width (the ``WaveRNNConfig`` defaults:
   MOL, rnn/fc 512, compute and res_out 128, 10 res blocks, hop 256) with
   the port's ``trainers/wavernn_train.py`` on the CPU, on the synthetic
   corpus of chip_smoke's phases 12-14 (4 speakers x 12 clips, seed 0),
   ``--steps`` steps of ``--batch`` windows of 1,280 samples, Adam lr
   1e-4: phase 14's recipe (batch 16, 100 steps) unless asked otherwise.
2. Convert the trained weights to the JAX package's trees with
   ``msa_tts_tpu_torch.utils.convert.wavernn_jax_from_state_dict``.
3. Fold a 544-frame mel of the corpus into 44 rows of 3,850 samples
   (target 2,750, overlap 550; the port's upsampling network, f32) and
   run the sample loop on the same folded conditioning and the same
   noise (``msa_tts_tpu.vocoders.wavernn._generation_noise``) four ways:
   the JAX package's loop with bf16 matrices
   (``cast_generation_params(..., jnp.bfloat16)``) and with f32, the
   port's plain loop with bf16 matrices and with f32.  Both noises of
   chip_smoke phase 14: as drawn, and with the mixture choice forced by
   the noise (1e3 added to the gumbel draw's own winner).
4. For each pair: the share of samples further apart than 1e-3 (phase
   8's judgement holds it at 5e-3), the rows that part and the median
   step where they first do, max|d|; and the MCD (``ops/metrics.
   mcd_batch``) between the log-mels of the two unfolded waveforms,
   beside the MCD between two f32 vocodings drawn from different noise.

Prints the readings and the verdict and writes them as JSON to ``--out``:
``judgement`` when the JAX package's own bf16 loop departs from its f32
by a share of at least 1e-2 (the judgement cannot hold trained weights),
``port fault`` when that share stays below phase 8's 5e-3 while the
port's bf16 loop does not.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

FLIP = 1e-3          # phase 8's GEN_FLIP
SHARE = 5e-3         # phase 8's GEN_BF16_SHARE
FORCE = 1e3          # chip_smoke's GEN_FORCE
TARGET, OVERLAP, FRAMES = 2_750, 550, 544
AUDIO = {"n_fft": 1024, "win_length": 1024, "hop_length": 256,
         "n_mels": 80, "sample_rate": 22050, "f_min": 0.0,
         "f_max": 8000.0, "griffinlim_iters": 60}


def _departure(a, b) -> dict:
    """Samples of ``a`` and ``b`` (rows, T) further apart than FLIP."""
    import numpy as np

    d = np.abs(a - b)
    over = d > FLIP
    rows = over.any(axis=1)
    firsts = [int(over[r].argmax()) for r in range(len(over)) if rows[r]]
    return {"share": float(over.mean()), "rows": int(rows.sum()),
            "first_median": statistics.median(firsts) if firsts else None,
            "max_abs": float(d.max())}


def _mcd(wa, wb) -> float:
    """MCD between the log-mels of two waveforms of one length."""
    import numpy as np

    from msa_tts_tpu_torch.ops.audio import melspec_ap
    from msa_tts_tpu_torch.ops.metrics import mcd_batch

    ma = melspec_ap(wa.astype(np.float32), AUDIO).T[None]
    mb = melspec_ap(wb.astype(np.float32), AUDIO).T[None]
    return mcd_batch(ma, mb, np.asarray([ma.shape[1]]))


def train(corpus: str, out: str, steps: int, batch: int):
    """The port's WaveRNN trainer on the CPU; returns (trainer, s)."""
    from msa_tts_tpu_torch.config import save_params
    from msa_tts_tpu_torch.dataloaders.synthetic import synthetic_params
    from msa_tts_tpu_torch.trainers import wavernn_train as TW
    from msa_tts_tpu_torch.vocoders.wavernn import WaveRNNConfig

    cfg = WaveRNNConfig()
    p = synthetic_params(corpus, n_speakers=4, batch_size=batch)
    p.update(method="wavernn", experiment_name="settle", output_path=out,
             use_tensorboard=False, tb_log_interval=1, print_interval=10,
             ckpt_save_step_interval=10 ** 6, train_seed=0, model_seed=0,
             batch_size=batch, device="cpu", audio_params=dict(AUDIO),
             voc_mode=cfg.mode, rnn_dims=cfg.rnn_dims, fc_dims=cfg.fc_dims,
             compute_dims=cfg.compute_dims, res_out_dims=cfg.res_out_dims,
             res_blocks=cfg.res_blocks, pad=cfg.pad,
             upsample_factors=list(cfg.upsample_factors), seq_len=1280,
             lr=1e-4, n_steps=steps)
    os.makedirs(out, exist_ok=True)
    save_params(p, os.path.join(out, "params.yml"))
    ran = []

    class Kept(TW.WaveRNNTrainer):
        def run(self):
            ran.append(self)
            return super().run()

    orig, TW.WaveRNNTrainer = TW.WaveRNNTrainer, Kept
    t0 = time.perf_counter()
    try:
        TW.main(argparse.Namespace(params_path=out))
    finally:
        TW.WaveRNNTrainer = orig
    return ran[0], time.perf_counter() - t0, p


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--seed", type=int, default=21)
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "settle_gen_bf16.json"))
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from msa_tts_tpu.vocoders import wavernn as JW
    from msa_tts_tpu_torch.dataloaders.synthetic import make_synthetic_corpus
    from msa_tts_tpu_torch.utils.checkpoint import load_checkpoint
    from msa_tts_tpu_torch.utils.convert import (
        wavernn_jax_from_state_dict,
        wavernn_state_dict_from_jax,
    )
    from msa_tts_tpu_torch.vocoders import wavernn as TW

    torch.set_num_threads(args.threads)
    res = {"steps": args.steps, "batch": args.batch, "seed": args.seed}
    with tempfile.TemporaryDirectory(prefix="settle_gen_bf16_") as tmp:
        corpus = f"{tmp}/corpus"
        make_synthetic_corpus(corpus, n_speakers=4, utterances_per_speaker=12,
                              seed=0, spk_emb_dim=256)
        trainer, secs, params = train(corpus, f"{tmp}/out", args.steps,
                                      args.batch)
        res["train_s"] = secs
        print(f"trained {args.steps} steps at the served width in "
              f"{secs:.1f} s")
        raw = load_checkpoint(f"{trainer.path_manager.checkpoints_path}/"
                              f"wavernn_{args.steps}.ckpt")
        frames = np.concatenate([it.mel for it in trainer.dataset.items], 1)
    cfg = TW.config_from_params(**params)
    jcfg = JW.config_from_params(**params)
    model = TW.WaveRNNModel(cfg)
    model.load_state_dict(wavernn_state_dict_from_jax(
        raw["params"], raw["model_state"], cfg), strict=True)
    model.eval()
    jp, _ = wavernn_jax_from_state_dict(model.state_dict(), cfg)

    # the folded conditioning of a 544-frame corpus mel (port, f32)
    mels = torch.from_numpy(frames[:, :FRAMES].copy())
    voc = TW.WaveRNN(model, cfg, gen_dtype="float32", gen_backend="torch",
                     device="cpu")
    padded, _ = voc._pad_batch([mels])
    with torch.no_grad():
        mels_up, aux = TW.upsample_apply(model.upsample, cfg, padded)
    up, n_folds = TW._fold_device(mels_up[0], TARGET, OVERLAP)
    ax = TW._fold_device(aux[0], TARGET, OVERLAP)[0]
    B, L = up.shape[:2]
    res["rows"], res["real_folds"] = B, n_folds
    wave_len = (FRAMES - 1) * cfg.hop_length
    print(f"{B} fold rows of {L} samples ({n_folds} real)")

    run_j = jax.jit(JW._make_generate_scan(jcfg, with_noise=True))
    gp = {"f32": JW.cast_generation_params(jp, None),
          "bf16": JW.cast_generation_params(jp, jnp.bfloat16)}
    tp = {"f32": TW.cast_generation_params(model, torch.float32),
          "bf16": TW.cast_generation_params(model, torch.bfloat16)}

    def noise(seed, forced):
        n1, n2 = (np.asarray(x) for x in JW._generation_noise(
            jcfg, jax.random.PRNGKey(seed), L, B))
        if forced:
            n1 = n1 + FORCE * np.eye(n1.shape[-1], dtype=n1.dtype)[
                n1.argmax(-1)]
        return n1, n2

    def wave(samples):
        return TW.xfade_and_unfold(samples[:n_folds].astype(np.float64),
                                   TARGET, OVERLAP)[:wave_len]

    for kind in ("sampled", "forced"):
        n1, n2 = noise(args.seed, kind == "forced")
        out, secs = {}, {}
        for tag in ("f32", "bf16"):
            t0 = time.perf_counter()
            out[f"jax_{tag}"] = np.asarray(run_j(
                gp[tag], jnp.asarray(up.numpy()), jnp.asarray(ax.numpy()),
                jnp.asarray(n1), jnp.asarray(n2)))
            secs[f"jax_{tag}"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            out[f"port_{tag}"] = TW.generate_samples(
                tp[tag], cfg, up, ax, torch.from_numpy(n1),
                torch.from_numpy(n2), backend="torch").numpy()
            secs[f"port_{tag}"] = time.perf_counter() - t0
        m1, m2 = noise(args.seed + 1, kind == "forced")
        other = np.asarray(run_j(gp["f32"], jnp.asarray(up.numpy()),
                                 jnp.asarray(ax.numpy()), jnp.asarray(m1),
                                 jnp.asarray(m2)))
        waves = {k: wave(v) for k, v in out.items()}
        pairs = {}
        for a, b in (("jax_bf16", "jax_f32"), ("port_bf16", "jax_bf16"),
                     ("port_bf16", "jax_f32"), ("port_f32", "jax_f32"),
                     ("port_bf16", "port_f32")):
            v = _departure(out[a][:n_folds], out[b][:n_folds])
            v["mcd"] = _mcd(waves[a], waves[b])
            pairs[f"{a} vs {b}"] = v
            print(f"{kind} noise, {a} vs {b}: share beyond {FLIP} "
                  f"{v['share']:.3e}, rows {v['rows']}/{n_folds}, median "
                  f"first step {v['first_median']}, max|d| "
                  f"{v['max_abs']:.3e}, MCD {v['mcd']:.4f}")
        mcd_ff = _mcd(waves["jax_f32"], wave(other))
        print(f"{kind} noise, jax_f32 vs jax_f32 on other noise: MCD "
              f"{mcd_ff:.4f}")
        for k in ("jax_f32", "jax_bf16", "port_f32", "port_bf16"):
            x = out[k][:n_folds]
            if not (np.isfinite(x).all() and np.abs(x).max() <= 1.0):
                raise AssertionError(f"{kind}, {k}: samples not finite or "
                                     "outside [-1, 1]")
        res[kind] = {"pairs": pairs, "mcd_f32_other_noise": mcd_ff,
                     "loop_s": secs}
    share = res["sampled"]["pairs"]["jax_bf16 vs jax_f32"]["share"]
    port = res["sampled"]["pairs"]["port_bf16 vs jax_f32"]["share"]
    if share >= 1e-2:
        verdict = "judgement"
    elif share < SHARE and port >= SHARE:
        verdict = "port fault"
    else:
        verdict = "undecided"
    res["verdict"] = verdict
    print(f"verdict: {verdict} (the JAX package's bf16 loop against its "
          f"f32: share {share:.3e}; the port's bf16 loop: {port:.3e}; "
          f"phase 8's limit {SHARE})")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
