"""Batch assembly (counterpart of ``msa_tts_tpu/dataloaders/collate.py``):
items sorted by text length, longest first (unless ``sort_by_length`` is
off); each item's training mel (its soft target where ER-KD set one,
unless ``use_soft_mel`` is off); text zero-padded to ``text_pad_to``, else to a
multiple of ``text_pad_multiple``; mels padded to ``mel_pad_to``, else
to a multiple of ``mel_pad_multiple``, then to one of the reduction
factor; stop labels 1.0 from the last valid frame on (padding
included)."""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np

from .dataset import Item


class Batch(NamedTuple):
    inputs: np.ndarray          # (B, T_text) int32
    input_lengths: np.ndarray   # (B,) int32
    mels: np.ndarray            # (B, n_mel, T_mel) float32
    mel_lengths: np.ndarray     # (B,) int32
    speaker_ids: np.ndarray     # (B,) int32
    spk_embs: np.ndarray        # (B, D) float32
    stop_labels: np.ndarray     # (B, T_mel) float32

    def speaker_vecs(self, speaker_emb_type: str) -> np.ndarray:
        if speaker_emb_type == "learnable_lookup":
            return self.speaker_ids
        return self.spk_embs


def _round_up(n: int, multiple: int | None) -> int:
    if not multiple:
        return n
    return ((n + multiple - 1) // multiple) * multiple


def collate(items: Sequence[Item], *, reduction_factor: int = 1,
            text_pad_multiple: int | None = None,
            mel_pad_multiple: int | None = None,
            text_pad_to: int | None = None,
            mel_pad_to: int | None = None, sort_by_length: bool = True,
            use_soft_mel: bool = True) -> Batch:
    """Assemble a :class:`Batch` from items."""
    if sort_by_length:
        items = sorted(items, key=lambda it: -len(it.phonemes))
    mels = [it.mel_for_training if use_soft_mel else it.mel for it in items]
    text_lens = np.asarray([len(it.phonemes) for it in items], np.int32)
    mel_lens = np.asarray([m.shape[1] for m in mels], np.int32)
    t_text = text_pad_to or _round_up(int(text_lens.max()),
                                      text_pad_multiple)
    t_mel = _round_up(mel_pad_to or _round_up(int(mel_lens.max()),
                                              mel_pad_multiple),
                      reduction_factor)

    B, n_mel = len(items), mels[0].shape[0]
    inputs = np.zeros((B, t_text), np.int32)
    mel_arr = np.zeros((B, n_mel, t_mel), np.float32)
    stop = np.ones((B, t_mel), np.float32)
    spk_ids = np.zeros((B,), np.int32)
    spk_embs = np.zeros((B, items[0].spk_emb.shape[0]), np.float32)
    for b, it in enumerate(items):
        inputs[b, : len(it.phonemes)] = it.phonemes
        M = mels[b].shape[1]
        mel_arr[b, :, :M] = mels[b]
        stop[b, : M - 1] = 0.0
        spk_ids[b] = it.speaker_id
        spk_embs[b] = it.spk_emb
    return Batch(inputs=inputs, input_lengths=text_lens, mels=mel_arr,
                 mel_lengths=mel_lens, speaker_ids=spk_ids,
                 spk_embs=spk_embs, stop_labels=stop)
