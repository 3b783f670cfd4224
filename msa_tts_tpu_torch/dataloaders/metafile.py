"""Metafile parsing and train/test splitting (the port's own copy of
``msa_tts_tpu/dataloaders/metafile.py``).

Metafile format (shared with the reference, one utterance per line):
``speaker|filename|text|phonemes|duration_seconds``.

Split semantics reproduce the reference exactly
(msa_tts/dataloaders/dataloader_default.py:266-316): per speaker, lines
are shuffled with ``random.seed(dataset_random_seed)`` *re-seeded per
speaker*, truncated to the first items whose cumulative duration exceeds
``total_duration_per_spk`` minutes, then split at
``round(perc_train · n)`` with a guard keeping at least two test items.
"""

from __future__ import annotations

import os
import pickle
import random
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Utterance:
    speaker: str
    filename: str
    text: str
    phonemes: str
    duration: float


@dataclass
class SpeakerSplit:
    train: list[Utterance] = field(default_factory=list)
    test: list[Utterance] = field(default_factory=list)


def parse_metafile(path: str) -> list[Utterance]:
    utts = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split("|")
            if len(parts) < 5:
                raise ValueError(f"malformed metafile line: {line!r}")
            utts.append(
                Utterance(
                    speaker=parts[0],
                    filename=parts[1],
                    text=parts[2],
                    phonemes=parts[3],
                    duration=float(parts[4]),
                )
            )
    return utts


def split_speakers(
    utterances: list[Utterance],
    speakers_list: list[str],
    *,
    total_duration_per_spk: float = -1,
    perc_train: float = 0.9,
    seed: int = 0,
) -> tuple[dict[str, SpeakerSplit], str]:
    """Produce per-speaker train/test item lists.  Returns (splits, log)."""
    splits: dict[str, SpeakerSplit] = {}
    logs = ""
    for speaker in speakers_list:
        lines = [u for u in utterances if u.speaker == speaker]
        # Reference re-seeds before every speaker's shuffle.
        rng = random.Random(seed)
        rng.shuffle(lines)

        if total_duration_per_spk != -1:
            budget = total_duration_per_spk * 60.0
            cum = np.cumsum([u.duration for u in lines])
            over = np.nonzero(cum > budget)[0]
            first_idx = int(over[0]) if len(over) else len(lines)
        else:
            first_idx = len(lines)

        items = lines[:first_idx]
        split_idx = round(float(perc_train) * len(items))
        if split_idx >= len(items) - 1:
            split_idx = len(items) - 2  # keep ≥ 2 test items
        if split_idx < 0:
            raise ValueError(
                f"speaker {speaker}: too few items ({len(items)}) to split"
            )
        sp = SpeakerSplit(train=items[:split_idx], test=items[split_idx:])
        splits[speaker] = sp
        if not sp.train:
            # reference semantics allow this (its ≥2-test guard can eat
            # every train item, dataloader_default.py:303-313) — but it
            # deserves more than a log line, since training then sees
            # zero utterances for the speaker
            print(
                f"WARNING: speaker {speaker} has 0 train items after "
                f"the split ({len(items)} total; ≥2 reserved for test)"
            )
        logs += (
            f"Speaker {speaker}, trainset:{len(sp.train)} utt,"
            f"testset:{len(sp.test)} utt \n"
        )
    return splits, logs


def load_speaker_embeddings(dataset_path: str) -> dict[str, np.ndarray]:
    """Load ``spk_emb.pkl``: speaker → mean d-vector (reference
    dataloader_default.py:57-58 format: {speaker: {"mean": vec, ...}})."""
    with open(os.path.join(dataset_path, "spk_emb.pkl"), "rb") as f:
        raw = pickle.load(f)
    out = {}
    for spk, v in raw.items():
        vec = v["mean"] if isinstance(v, dict) else v
        out[spk] = np.asarray(vec, dtype=np.float32)
    return out


def resolve_audio_path(dataset_path: str, audio_folder: str, speaker: str,
                       filename: str, num_speakers: int) -> str:
    """Reference path layout (dataloader_default.py:77-84): flat when
    ``audio_folder`` is empty and there is a single speaker, else
    ``<root>/<audio_folder>/<speaker>/<filename>``."""
    if audio_folder == "" and num_speakers == 1:
        return os.path.join(dataset_path, filename)
    return os.path.join(dataset_path, audio_folder, speaker, filename)
