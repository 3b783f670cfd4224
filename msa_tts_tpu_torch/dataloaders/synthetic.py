"""Synthetic tiny corpus generator (the port's own copy of
``msa_tts_tpu/dataloaders/synthetic.py``: the same files for the same
arguments).

Creates an on-disk dataset in the framework's metafile layout (wavs +
``metadata.csv`` + ``spk_emb.pkl``) from procedural "speech": per-speaker
harmonic stacks with distinct f0 and formant envelopes, and random
phoneme strings over the real IPA vocabulary.  Used by tests, the
benchmark, and smoke-training runs — no real dataset or espeak binary
required (the reference's test strategy gap; SURVEY.md §4).
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from ..ops.audio import save_wav
from ..utils.g2p.char_list import char_list


def make_synthetic_corpus(
    root: str,
    *,
    n_speakers: int = 4,
    utterances_per_speaker: int = 12,
    sample_rate: int = 22050,
    min_dur: float = 0.4,
    max_dur: float = 1.2,
    spk_emb_dim: int = 64,
    seed: int = 0,
) -> str:
    """Write the corpus under ``root``; returns the metafile path."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    audio_folder = "wavs"

    # Phoneme alphabet: skip pad (idx 0); keep single-char symbols.
    symbols = [c for c in char_list[1:] if c != " "]

    spk_embs = {}
    lines = []
    for s in range(n_speakers):
        speaker = f"spk{s:02d}"
        spk_dir = os.path.join(root, audio_folder, speaker)
        os.makedirs(spk_dir, exist_ok=True)
        f0 = 90.0 + 40.0 * s + rng.uniform(-5, 5)
        formant = 500.0 + 150.0 * s
        emb = rng.standard_normal(spk_emb_dim).astype(np.float32)
        emb /= np.linalg.norm(emb)
        spk_embs[speaker] = {"mean": emb}

        for u in range(utterances_per_speaker):
            dur = float(rng.uniform(min_dur, max_dur))
            n = int(dur * sample_rate)
            t = np.arange(n) / sample_rate
            # harmonic stack + slow amplitude modulation + formant noise
            wav = np.zeros(n, dtype=np.float64)
            for h in range(1, 5):
                wav += np.sin(2 * np.pi * f0 * h * t) / h
            wav *= 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(1.5, 4.0) * t)
            wav += 0.05 * np.sin(2 * np.pi * formant * t)
            wav += 0.01 * rng.standard_normal(n)
            wav = (wav / np.abs(wav).max()).astype(np.float32)

            fname = f"{speaker}_{u:03d}.wav"
            save_wav(os.path.join(spk_dir, fname), wav, sample_rate)

            n_ph = int(8 + dur * 20)
            phonemes = "".join(rng.choice(symbols, size=n_ph))
            text = f"synthetic utterance {u}"
            lines.append(
                f"{speaker}|{fname}|{text}|{phonemes}|{dur:.3f}"
            )

    meta_path = os.path.join(root, "metadata.csv")
    with open(meta_path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(root, "spk_emb.pkl"), "wb") as f:
        pickle.dump(spk_embs, f)
    return meta_path


DEFAULT_AUDIO_PARAMS = {
    "n_fft": 1024,
    "win_length": 1024,
    "hop_length": 256,
    "n_mels": 80,
    "sample_rate": 22050,
    "f_min": 0.0,
    "f_max": 8000.0,
    "n_mfcc": 13,
    "griffinlim_iters": 30,
}


def synthetic_params(
    root: str,
    *,
    n_speakers: int = 4,
    batch_size: int = 4,
    model_overrides: dict | None = None,
    **overrides,
) -> dict:
    """A complete reference-vocabulary params dict wired to a synthetic
    corpus at ``root`` — the params.yml a smoke experiment would use."""
    speakers = [f"spk{s:02d}" for s in range(n_speakers)]
    params = {
        "method": "baseline",
        "experiment_name": "synthetic",
        "output_path": os.path.join(root, "output"),
        "model_name": "Tacotron2NV",
        "audio_processor": "ap",
        "audio_params": dict(DEFAULT_AUDIO_PARAMS),
        "dataset_random_seed": 0,
        "num_workers": 0,
        "n_epochs": 1,
        "ckpt_save_epoch_interval": 1,
        "metatest_epoch_interval": 1,
        "tb_log_interval": 10,
        "do_metatest": False,
        "finetune": False,
        "clip_grad_norm": True,
        "grad_clip_thresh": 1.0,
        "freeze_charemb": False,
        "freeze_encoder": False,
        "freeze_decoder": False,
        "meta_batch_size": 2,
        "n_inner_train": 2,
        "n_inner_test": 2,
        "track_higher_grads": True,
        "criterion": {
            "criterion_type": "Tacotron2Loss",
            "reduction": "none",
            "pos_weight": 6.0,
        },
        "optim": {"optimizer_type": "Adam", "lr": "1e-3"},
        "optim_inner": {"optimizer_type": "SGD", "lr": "1e-2"},
        "optim_outer": {"optimizer_type": "Adam", "lr": "1e-3"},
        "model": {
            "mask_padding": True,
            "n_frames_per_step": 1,
            "symbols_embedding_dim": 32,
            "encoder_n_convolutions": 2,
            "encoder_embedding_dim": 32,
            "encoder_kernel_size": 5,
            "speaker_emb_type": "static",
            "speaker_embedding_dim": 64,
            "speaker_embedding_dim_lin": 16,
            "attention_rnn_dim": 64,
            "decoder_rnn_dim": 64,
            "prenet_dim": 32,
            "max_decoder_steps": 100,
            "gate_threshold": 0.5,
            "p_attention_dropout": 0.1,
            "p_decoder_dropout": 0.1,
            "decoder_no_early_stopping": False,
            "postnet_embedding_dim": 32,
            "postnet_kernel_size": 5,
            "postnet_n_convolutions": 3,
            "use_residual_encoder": False,
            "attention_params": {
                "attention_type": "ForwardAttention",
                "attention_dim": 32,
                "attention_location_n_filters": 8,
                "attention_location_kernel_size": 15,
                "windowing": False,
                "norm": "softmax",
                "forward_attn": True,
                "trans_agent": True,
                "forward_attn_mask": False,
            },
        },
        "dataset_train": {
            "dataset_path": root,
            "meta_file": "metadata.csv",
            "speakers_list": speakers,
            "audio_folder": "wavs",
            "total_duration_per_spk": -1,
            "perc_train": 0.8,
            "trim_margin_silence": False,
            "ref_level_db": 26,
            "batch_size": batch_size,
            "use_binned_sampler": False,
        },
    }
    params["dataset_metatrain"] = dict(params["dataset_train"])
    params["dataset_metatest"] = dict(params["dataset_train"])
    params["dataset_metatrain"]["batch_size"] = 2
    params["dataset_metatest"]["batch_size"] = 2
    if model_overrides:
        params["model"].update(model_overrides)
    params.update(overrides)
    return params
