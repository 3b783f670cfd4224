"""Ground-truth re-synthesis (counterpart of
``msa_tts_tpu/data_processing/convert_gt.py``; reference:
msa_tts/data_processing/convert_gt.py): every source wav through its
log-mel and the vocoder, so that MOS comparisons against synthesized
audio are vocoder-fair.

The mel is the ``audio_processor``'s log-mel of the clip (the dataset's
features, host numpy or the host library); the vocoder runs on the GPU
unless ``device: cpu`` is given: Griffin-Lim, or WaveRNN (its sample loop
one launch of the CUDA kernel there) with the denoiser when its noise
profile exists.

Usage: ``python -m msa_tts_tpu_torch.data_processing.convert_gt
--params_path <params.yml with ds_path / source_folder / target_folder /
vocoder settings>``
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

from ..config import load_params
from ..dataloaders.dataset import compute_logmel
from ..ops.audio import griffinlim_logmelspec, load_wav, save_wav
from ..utils.backend import load_device


class GTConvertor:
    def __init__(self, params: dict):
        self.params = params
        self.device = load_device(params.get("device", "cuda"))
        self.vocoder = params.get("vocoder", "griffinlim")
        if self.vocoder == "wavernn":
            from ..vocoders.wavernn import get_wavernn

            self.params_wavernn = load_params(
                params["vocoder_params_path"]
            )
            self.wavernn = get_wavernn(
                self.device, **{k: v for k, v in self.params_wavernn.items()
                                if k != "device"})
            self.denoiser = None
            noise_profile = params.get("noise_profile_path")
            if noise_profile and os.path.exists(noise_profile):
                from ..vocoders.denoiser import AudioDenoiser

                self.denoiser = AudioDenoiser(noise_profile)

    def convert_file(self, source_wav_path: str, target_wav_path: str,
                     log: str = ""):
        if log:
            print(log)
        sr = self.params["audio_params"]["sample_rate"]
        wav = load_wav(source_wav_path, target_sample_rate=sr)
        mel = compute_logmel(
            wav,
            self.params.get("audio_processor", "ap"),
            self.params["audio_params"],
        )
        mel = torch.as_tensor(mel, device=self.device)
        if self.vocoder == "wavernn":
            out = self.wavernn.generate(
                mel[None], True,
                self.params_wavernn["target"],
                self.params_wavernn["overlap"],
            )
            if self.denoiser is not None:
                out = self.denoiser.denoise(out)
        else:
            out = griffinlim_logmelspec(
                mel, self.params["audio_params"]).cpu().numpy()
        save_wav(target_wav_path, np.asarray(out), sr)

    def run(self):
        source = os.path.join(
            self.params["ds_path"], self.params["source_folder"]
        )
        target = os.path.join(
            self.params["ds_path"], self.params["target_folder"]
        )
        speakers = [
            s for s in os.listdir(source)
            if os.path.isdir(os.path.join(source, s))
        ]
        for speaker in speakers:
            os.makedirs(os.path.join(target, speaker), exist_ok=True)
            wavs = glob.glob(os.path.join(source, speaker, "*.wav"))
            for itr, src in enumerate(wavs):
                dst = os.path.join(target, speaker, os.path.basename(src))
                self.convert_file(
                    src, dst, f"{speaker}: {itr + 1}/{len(wavs)}"
                )


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--params_path", type=str, required=True)
    args = parser.parse_args()
    GTConvertor(load_params(args.params_path)).run()
