"""CommonVoice preparation: phonemize validated clips per speaker
(the port's own copy of
``msa_tts_tpu/data_processing/prepare_comvoice.py``; reference:
msa_tts/data_processing/prepare_comvoice.py).  Expects
mp3-converted-to-wav clips under ``clips_wav/`` and the standard
``validated.tsv`` manifest.

Usage: ``python -m msa_tts_tpu_torch.data_processing.prepare_comvoice
--ds_path <root> [--lang de] [--min_per_spk 10] [--workers 20]``
"""

from __future__ import annotations

import argparse
import csv
import os
from collections import defaultdict

from .common import process_utterance, run_pool, write_metafile


class CommonVoiceProcessor:
    def __init__(self, ds_path: str, lang: str = "de", workers: int = 20,
                 min_per_spk: int = 10, clips_folder: str = "clips_wav"):
        self.ds_path = ds_path
        self.lang = lang
        self.workers = workers
        self.min_per_spk = min_per_spk
        self.clips_folder = clips_folder

    def create_metadata(self):
        by_spk = defaultdict(list)
        with open(os.path.join(self.ds_path, "validated.tsv")) as f:
            for row in csv.DictReader(f, delimiter="\t"):
                by_spk[row["client_id"]].append(
                    (row["path"], row["sentence"])
                )
        jobs = []
        for spk, rows in by_spk.items():
            if len(rows) < self.min_per_spk:
                continue
            for path, sentence in rows:
                wav = os.path.splitext(path)[0] + ".wav"
                src = os.path.join(self.ds_path, self.clips_folder, wav)
                # CommonVoice clips are FLAT under clips_wav/, but the
                # training loader resolves <root>/wavs/<speaker>/<file>
                # for multi-speaker metafiles (metafile.resolve_audio_
                # path, reference dataloader_default.py:77-84) — so
                # rewrite each clip into that layout (resampled to the
                # training rate), the same mechanism prepare_vctk uses;
                # otherwise the emitted metafile is untrainable.
                dst = os.path.join(self.ds_path, "wavs", spk, wav)
                jobs.append((spk, src, sentence, wav, dst))
        meta = run_pool(self._one, jobs, max_workers=self.workers)
        return write_metafile(self.ds_path, meta)

    def _one(self, spk, src, transcript, wav_field, dst):
        return process_utterance(
            spk, src, transcript,
            language=self.lang, target_sample_rate=22050,
            resampled_path=dst,
            wav_field=wav_field, ensure_final_punct=True,
        )


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--ds_path", type=str, required=True)
    parser.add_argument("--lang", type=str, default="de")
    parser.add_argument("--min_per_spk", type=int, default=10)
    parser.add_argument("--workers", type=int, default=20)
    args = parser.parse_args()
    CommonVoiceProcessor(
        args.ds_path, args.lang, args.workers, args.min_per_spk
    ).create_metadata()
