"""HiFi-GAN's generator (jik876/hifi-gan, ``resblock`` 1 or 2), served in
float32 through cuDNN: its weights, how it is built, and its reference
and work."""

from __future__ import annotations

import math

import torch

import parts
from metrics._common import frames
from reference import hifigan as RH
from reference.precision import Precision
from work import hifigan as WH
from work import peaks


class Part(parts.Part):
    name = "hifigan"

    def weight_spec(self) -> dict:
        """Weights U(±gain/√fan_in), the gain the configuration's
        ``random_init.hifigan_gain``: it keeps the random generator's
        waveform away from both silence and tanh's saturation."""
        h, n_mels = self.block, self.cfg["audio_params"]["n_mels"]
        gain = self.cfg["random_init"]["hifigan_gain"]
        s = {}

        def conv(name, shape, fan_in):
            b = gain / math.sqrt(fan_in)
            s[f"{name}.weight"] = (shape, (-b, b))
            n_out = shape[0] if "ups" not in name else shape[1]
            s[f"{name}.bias"] = ((n_out,), (-0.01, 0.01))

        ch = h["upsample_initial_channel"]
        conv("conv_pre", (ch, n_mels, 7), n_mels * 7)
        nk = len(h["resblock_kernel_sizes"])
        for i, (u, k) in enumerate(zip(h["upsample_rates"],
                                       h["upsample_kernel_sizes"])):
            c = ch // 2 ** (i + 1)
            conv(f"ups.{i}", (2 * c, c, k), 2 * c * k // u)
            for j, (kk, dils) in enumerate(zip(h["resblock_kernel_sizes"],
                                               h["resblock_dilation_sizes"])):
                for m in range(len(dils)):
                    names = ([f"convs1.{m}", f"convs2.{m}"]
                             if h["resblock"] == "1" else [f"convs.{m}"])
                    for nm in names:
                        conv(f"resblocks.{i * nk + j}.{nm}", (c, c, kk),
                             c * kk)
        conv("conv_post", (1, ch // 2 ** len(h["upsample_rates"]), 7),
             ch // 2 ** len(h["upsample_rates"]) * 7)
        return s

    def build(self, sd: dict, device):
        from msa_tts_tpu_torch.vocoders.hifigan import Generator, HiFiGAN

        with torch.device(device):
            gen = Generator(self.block, self.cfg["audio_params"]["n_mels"])
        gen.load_state_dict(sd, strict=True)
        return HiFiGAN.from_params(gen, self.block, device=device)

    def stated(self) -> str:
        return "float32"

    def waves(self, ref, prec: str, mels: str) -> list:
        return [RH.generate(Precision(prec), ref.wts[self.name], self.block,
                            x[None])[0].double().cpu().numpy()
                for x in ref.mels(mels)[: ref.n]]

    def seconds_at_peak(self, run, r) -> float:
        return WH.ops(self.block, self.cfg["audio_params"]["n_mels"], 1,
                      frames(self.cfg)) / peaks.FLOPS[
                          peaks.conv_type(run.cudnn_tf32)]
