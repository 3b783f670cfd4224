"""CSS10 preparation: single-speaker-per-language corpora
(the port's own copy of
``msa_tts_tpu/data_processing/prepare_css10.py``; reference:
msa_tts/data_processing/prepare_css10.py).  Reads the
``transcript.txt`` manifest (path|raw|normalized|duration).

Usage: ``python -m msa_tts_tpu_torch.data_processing.prepare_css10
--ds_path <root> --lang de [--speaker css10_de] [--workers 20]``
"""

from __future__ import annotations

import argparse
import os

from .common import process_utterance, run_pool, write_metafile


class CSS10Processor:
    def __init__(self, ds_path: str, lang: str = "de",
                 speaker: str | None = None, workers: int = 20):
        self.ds_path = ds_path
        self.lang = lang
        self.speaker = speaker or f"css10_{lang}"
        self.workers = workers

    def create_metadata(self):
        with open(os.path.join(self.ds_path, "transcript.txt")) as f:
            rows = [l.strip().split("|") for l in f if l.strip()]
        jobs = []
        for row in rows:
            rel_path, transcript = row[0], row[2] if len(row) > 2 else row[1]
            src = os.path.join(self.ds_path, rel_path)
            jobs.append((self.speaker, src, transcript, rel_path))
        meta = run_pool(self._one, jobs, max_workers=self.workers)
        return write_metafile(self.ds_path, meta)

    def _one(self, spk, src, transcript, wav_field):
        return process_utterance(
            spk, src, transcript,
            language=self.lang, target_sample_rate=22050,
            wav_field=wav_field, ensure_final_punct=True,
        )


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--ds_path", type=str, required=True)
    parser.add_argument("--lang", type=str, default="de")
    parser.add_argument("--speaker", type=str, default=None)
    parser.add_argument("--workers", type=int, default=20)
    args = parser.parse_args()
    CSS10Processor(
        args.ds_path, args.lang, args.speaker, args.workers
    ).create_metadata()
