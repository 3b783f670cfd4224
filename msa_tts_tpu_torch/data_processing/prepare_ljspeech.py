"""LJSpeech preparation (single speaker "lj"): phonemize the metadata.csv
transcripts, emit the pipe-metafile
(the port's own copy of
``msa_tts_tpu/data_processing/prepare_ljspeech.py``; reference:
msa_tts/data_processing/prepare_ljspeech.py).

Usage: ``python -m msa_tts_tpu_torch.data_processing.prepare_ljspeech
--ds_path <LJSpeech root> [--lang en-us] [--workers 10]``
"""

from __future__ import annotations

import argparse
import os

from .common import process_utterance, run_pool, write_metafile


class LJSpeechProcessor:
    def __init__(self, ds_path: str, lang: str = "en-us",
                 workers: int = 10):
        self.ds_path = ds_path
        self.lang = lang
        self.workers = workers

    def create_metadata(self):
        with open(os.path.join(self.ds_path, "metadata.csv")) as f:
            rows = [l.strip().split("|") for l in f if l.strip()]
        jobs = []
        for wav_id, _raw, transcript in rows:
            src = os.path.join(self.ds_path, "wavs", wav_id + ".wav")
            jobs.append(("lj", src, transcript, f"wavs/{wav_id}.wav"))
        meta = run_pool(self._one, jobs, max_workers=self.workers)
        return write_metafile(self.ds_path, meta)

    def _one(self, spk, src, transcript, wav_field):
        return process_utterance(
            spk, src, transcript,
            language=self.lang, target_sample_rate=22050,
            wav_field=wav_field,
        )


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--ds_path", type=str, required=True)
    parser.add_argument("--lang", type=str, default="en-us")
    parser.add_argument("--workers", type=int, default=10)
    args = parser.parse_args()
    LJSpeechProcessor(args.ds_path, args.lang, args.workers).create_metadata()
