"""Utterance items, log-mel features and the in-memory dataset (the
port's own copy of ``msa_tts_tpu/dataloaders/dataset.py``).

Every utterance's log-mel and phoneme ids are computed once, when the
dataset is built, so that batching is padding and stacking only.  The
features come from the host C++ library (``native/``: trim, STFT, mel
and log of the whole split in one threaded call, bit for bit the JAX
package's) unless ``use_native_feats`` is false or no compiler is
found; then from the numpy path of ``ops/audio.py``, equal to it to
float32 rounding."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..ops import audio as A
from ..utils.g2p import Grapheme2Phoneme
from .metafile import (
    SpeakerSplit,
    Utterance,
    load_speaker_embeddings,
    resolve_audio_path,
)


@dataclass
class Item:
    phonemes: np.ndarray      # (T_text,) int32
    mel: np.ndarray           # (n_mel, T_mel) float32 log-mel
    spk_emb: np.ndarray       # (D,) float32 d-vector
    speaker: str = ""
    speaker_id: int = 0
    item_id: str = ""         # "{speaker}_{index in its split}"
    duration: float = 0.0     # seconds, from the metafile
    # ER-KD's replay slot: when set, this (soft) mel replaces the ground
    # truth in batching (the reference's dataloader_default_buffer.py)
    soft_mel: np.ndarray | None = None
    # the wav file, for consumers of the waveform (the vocoder trainers)
    audio_path: str | None = None
    # the silence-trim slice (start, end) into the loaded waveform that
    # gave ``mel``; None when untrimmed.  A consumer pairing mel frames
    # with samples applies it, or frame 0 and sample 0 are apart by the
    # leading silence.
    trim: tuple | None = None

    @property
    def mel_for_training(self) -> np.ndarray:
        return self.soft_mel if self.soft_mel is not None else self.mel


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


class TTSDataset:
    """One split ("train"/"test") of a speaker dict, in RAM.  Speaker ids
    follow the enumeration order of the speakers dict, as in the
    reference."""

    def __init__(self, splits: dict[str, SpeakerSplit], mode: str, *,
                 dataset_path: str, audio_folder: str = "wavs",
                 trim_margin_silence: bool = False,
                 ref_level_db: float = 26, audio_processor: str = "ap",
                 audio_params: dict, g2p: Grapheme2Phoneme | None = None,
                 spk_emb_dict: dict | None = None,
                 use_native_feats: bool = True,
                 feats_threads: int | None = None):
        self.mode = mode
        self.audio_processor = audio_processor
        self.audio_params = audio_params
        g2p = g2p or Grapheme2Phoneme()
        if spk_emb_dict is None:
            spk_emb_dict = load_speaker_embeddings(dataset_path)
        self.speaker_to_id = {s: i for i, s in enumerate(splits.keys())}
        self.id_to_speaker = {i: s for s, i in self.speaker_to_id.items()}

        sr = audio_params["sample_rate"]
        self.items: list[Item] = []
        wavs: list[np.ndarray] = []
        for speaker, split in splits.items():
            utts: list[Utterance] = getattr(split, mode)
            for itr, u in enumerate(utts):
                seq, _ = g2p.convert(u.phonemes, convert_mode="phone_to_idx")
                path = resolve_audio_path(dataset_path, audio_folder,
                                          speaker, u.filename, len(splits))
                wavs.append(A.load_wav(path, target_sample_rate=sr))
                self.items.append(Item(
                    phonemes=np.asarray(seq, dtype=np.int32), mel=None,
                    spk_emb=spk_emb_dict[speaker], speaker=speaker,
                    speaker_id=self.speaker_to_id[speaker],
                    item_id=f"{speaker}_{itr}", duration=u.duration,
                    audio_path=path,
                ))
        native_out = None
        if use_native_feats:
            from ..native import extract_logmels_batch

            native_out = extract_logmels_batch(
                wavs, audio_processor, audio_params,
                trim_margin_silence=trim_margin_silence,
                ref_level_db=ref_level_db, n_threads=feats_threads)
        if native_out is not None:
            for item, mel, sl in zip(self.items, *native_out):
                item.mel = mel
                if trim_margin_silence:
                    item.trim = (int(sl[0]), int(sl[1]))
        else:
            for item, wav in zip(self.items, wavs):
                if trim_margin_silence:
                    item.trim = A.trim_margin_silence_slice(
                        wav, ref_level_db=ref_level_db)
                    wav = wav[item.trim[0]:item.trim[1]]
                item.mel = compute_logmel(wav, audio_processor, audio_params)
        self._by_speaker: dict[str, list[Item]] = {}
        for it in self.items:
            self._by_speaker.setdefault(it.speaker, []).append(it)

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, idx: int) -> Item:
        return self.items[idx]

    def get_audio_durations(self) -> list[float]:
        return [it.duration for it in self.items]

    def items_for_speaker(self, speaker: str) -> list[Item]:
        return self._by_speaker.get(speaker, [])

    def max_text_len(self) -> int:
        return max(len(it.phonemes) for it in self.items)

    def max_mel_len(self) -> int:
        return max(it.mel.shape[1] for it in self.items)
