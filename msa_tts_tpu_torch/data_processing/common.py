"""Shared helpers for offline dataset preparation (the port's own copy of
``msa_tts_tpu/data_processing/common.py``).

Output schema (one line per utterance, identical to the reference's):
``speaker|wav|text|phonemes|duration``.  Host work: the clips are read,
resampled and phonemized on a process pool.
"""

from __future__ import annotations

import os
from concurrent.futures import ProcessPoolExecutor

from ..ops.audio import load_wav, save_wav
from ..utils.g2p import Grapheme2Phoneme

_g2p = None


def _get_g2p() -> Grapheme2Phoneme:
    global _g2p
    if _g2p is None:
        _g2p = Grapheme2Phoneme()
    return _g2p


def process_utterance(
    spk_id: str,
    wav_path: str,
    transcript: str,
    *,
    language: str = "en-us",
    target_sample_rate: int | None = 22050,
    resampled_path: str | None = None,
    wav_field: str | None = None,
    ensure_final_punct: bool = False,
) -> str | None:
    """Load (and optionally resample and rewrite) one utterance,
    phonemize its transcript, and return the metafile line; None on
    failure."""
    try:
        wav = load_wav(wav_path, target_sample_rate=target_sample_rate)
        if resampled_path is not None:
            os.makedirs(os.path.dirname(resampled_path), exist_ok=True)
            save_wav(resampled_path, wav, target_sample_rate)
        dur = len(wav) / float(target_sample_rate)
        if ensure_final_punct and transcript and transcript[-1] not in "!.?":
            transcript += "."
        phoneme = _get_g2p().text_to_phone(transcript, language=language)
        wav_field = wav_field or os.path.basename(wav_path)
        return f"{spk_id}|{wav_field}|{transcript}|{phoneme}|{dur:#.2f}"
    except Exception as e:  # the reference skips a failing item
        print(f"skipping {wav_path}: {e}")
        return None


def run_pool(fn, jobs, max_workers: int = 20):
    """Fan a list of job tuples over a process pool; drop failures."""
    if max_workers <= 1:
        results = [fn(*job) for job in jobs]
    else:
        with ProcessPoolExecutor(max_workers=max_workers) as ex:
            futures = [ex.submit(fn, *job) for job in jobs]
            results = [f.result() for f in futures]
    return [r for r in results if r is not None]


def write_metafile(ds_path: str, lines: list[str],
                   name: str = "metadata.txt") -> str:
    path = os.path.join(ds_path, name)
    with open(path, "w", encoding="utf-8") as f:
        for line in lines:
            f.write(line + "\n")
    print("Finished.")
    return path
