"""VCTK preparation: resample 48 kHz → 22.05 kHz into ``wavs/``,
phonemize transcripts, emit the metafile
(the port's own copy of
``msa_tts_tpu/data_processing/prepare_vctk.py``; reference:
msa_tts/data_processing/prepare_vctk.py).

Usage: ``python -m msa_tts_tpu_torch.data_processing.prepare_vctk
--ds_path <VCTK root> [--lang en-us] [--workers 20]``
"""

from __future__ import annotations

import argparse
import glob
import os

from .common import process_utterance, run_pool, write_metafile


class VCTKProcessor:
    def __init__(self, ds_path: str, lang: str = "en-us",
                 workers: int = 20):
        self.ds_path = ds_path
        self.lang = lang
        self.workers = workers

    def read_ds_files(self):
        out = []
        for txt_file in glob.glob(
            os.path.join(self.ds_path, "txt", "*", "*.txt")
        ):
            with open(txt_file) as f:
                transcript = f.readline().strip()
            spk = os.path.basename(os.path.dirname(txt_file))
            wav_file = os.path.basename(txt_file).replace(".txt", ".wav")
            out.append((spk, wav_file, transcript))
        return out

    def create_metadata(self):
        lines = self.read_ds_files()
        os.makedirs(os.path.join(self.ds_path, "wavs"), exist_ok=True)
        jobs = []
        for itr, (spk, wav_file, transcript) in enumerate(lines):
            src = os.path.join(self.ds_path, "wav48", spk, wav_file)
            dst = os.path.join(self.ds_path, "wavs", spk, wav_file)
            jobs.append((spk, src, transcript, dst))
        meta = run_pool(self._one, jobs, max_workers=self.workers)
        return write_metafile(self.ds_path, meta)

    def _one(self, spk, src, transcript, dst):
        return process_utterance(
            spk, src, transcript,
            language=self.lang, target_sample_rate=22050,
            resampled_path=dst, ensure_final_punct=True,
        )


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--ds_path", type=str, required=True)
    parser.add_argument("--lang", type=str, default="en-us")
    parser.add_argument("--workers", type=int, default=20)
    args = parser.parse_args()
    VCTKProcessor(args.ds_path, args.lang, args.workers).create_metadata()
