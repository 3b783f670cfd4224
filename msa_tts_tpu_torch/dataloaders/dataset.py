"""Utterance items and log-mel features (the port's own copy of the parts
of ``msa_tts_tpu/dataloaders/dataset.py`` that adaptation uses)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..ops import audio as A


@dataclass
class Item:
    phonemes: np.ndarray      # (T_text,) int32
    mel: np.ndarray           # (n_mel, T_mel) float32 log-mel
    spk_emb: np.ndarray       # (D,) float32 d-vector


def compute_logmel(wav: np.ndarray, audio_processor: str,
                   audio_params: dict) -> np.ndarray:
    """A waveform's (n_mel, T) float32 log-mel by the ``"ap"`` (log10,
    HTK) or ``"ap2"`` (natural log, Slaney, HiFi-GAN's) frontend."""
    if audio_processor == "ap":
        log_mel = A.melspec_ap(wav, audio_params)
    elif audio_processor == "ap2":
        log_mel = A.melspec_ap2(wav[None, :], audio_params)[0]
    else:
        raise ValueError(f"unknown audio_processor: {audio_processor}")
    return np.asarray(log_mel, dtype=np.float32)
