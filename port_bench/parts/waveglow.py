"""WaveGlow (NVIDIA/waveglow), served by the port's
``vocoders/waveglow.py`` with bfloat16 products through cuBLAS and
cuDNN: its weights, how it is built and fed, its reference and work.

Each request's latent noise comes from its seed, drawn standard normal
on the device as one (n_group, positions) tensor for a mel of
``max_decoder_steps`` frames (every row decodes to the cap: ``reduced:
gate_bias``), in the layout the port documents; the served vocoder and
the reference scale it by the configuration's ``sigma``.
"""

from __future__ import annotations

import math
import weakref

import torch

import parts
from metrics._common import frames
from reference import waveglow as RW
from reference.precision import Precision
from traffic.text import sub_seed
from work import peaks
from work import waveglow as WW


class Part(parts.Part):
    name = "waveglow"

    def __init__(self, cfg: dict):
        super().__init__(cfg)
        self.n_mels = cfg["audio_params"]["n_mels"]
        self._voc = lambda: None

    def weight_spec(self) -> dict:
        """PyTorch's default init U(±1/√fan_in), weights and biases alike
        (the upsampler's fan-in what one upsampled sample sums); ``end``
        U(±gain/√fan_in), the gain ``random_init.waveglow_end_gain``;
        each invertible convolution the channel reversal plus U(±spread),
        ``random_init.waveglow_convinv_spread`` (the configuration's
        ``assumed``)."""
        v, ri = self.block, self.cfg["random_init"]
        w = v["WN_config"]
        C, n, K = w["n_channels"], w["n_layers"], w["kernel_size"]
        s = {}

        def conv(name, shape, fan_in, gain=1.0):
            b = gain / math.sqrt(fan_in)
            s[f"{name}.weight"] = (shape, (-b, b))
            n_out = shape[1] if name == "upsample" else shape[0]
            s[f"{name}.bias"] = ((n_out,), (-b, b))

        m = self.n_mels
        # each upsampled sample sums m channels × kernel / hop taps
        conv("upsample", (m, m, WW.UPSAMPLE_KERNEL),
             m * WW.UPSAMPLE_KERNEL // WW.HOP)
        cond = m * v["n_group"]
        # in the order of the module's state_dict
        for k, (h, _) in enumerate(WW.flows(v)):
            p = f"WN.{k}."
            for i in range(n):
                conv(f"{p}in_layers.{i}", (2 * C, C, K), C * K)
            for i in range(n):
                out = 2 * C if i < n - 1 else C
                conv(f"{p}res_skip_layers.{i}", (out, C, 1), C)
            conv(p + "start", (C, h, 1), h)
            conv(p + "end", (2 * h, C, 1), C, ri["waveglow_end_gain"])
            conv(p + "cond_layer", (2 * C * n, cond, 1), cond)
        a = ri["waveglow_convinv_spread"]
        for k, (_, r) in enumerate(WW.flows(v)):
            # row-major: the reversal's 1 sits at (i, r - 1 - i)
            s[f"convinv.{k}.conv.weight"] = ((r, r, 1), [
                (1, one - a, one + a)
                for one in (float(j // r + j % r == r - 1)
                            for j in range(r * r))])
        return s

    def build(self, sd: dict, device):
        try:
            from msa_tts_tpu_torch.vocoders.waveglow import (WaveGlow,
                                                             WaveGlowVocoder)
        except ImportError as e:
            raise SystemExit(
                "port_bench/parts/waveglow.py serves the port's "
                "msa_tts_tpu_torch/vocoders/waveglow.py, which this "
                f"checkout lacks: {e}") from e
        v = self.block
        with torch.device(device):
            model = WaveGlow(v["n_mel_channels"], v["n_flows"], v["n_group"],
                             v["n_early_every"], v["n_early_size"],
                             v["WN_config"])
        model.load_state_dict(sd, strict=True)
        voc = WaveGlowVocoder(model, dtype=v["product_dtype"],
                              sigma=v["sigma"], device=device)
        # the served system is freed before the check; its count is read
        # only while it lives
        self._voc = weakref.ref(voc)
        return voc

    def stated(self) -> str:
        return self.block["product_dtype"]

    def positions(self, n_frames: int) -> int:
        return n_frames * WW.HOP // self.block["n_group"]

    def noise(self, r, positions: int, device) -> torch.Tensor:
        """Request ``r``'s (n_group, positions) standard normal noise."""
        g = torch.Generator(device=device).manual_seed(sub_seed(r.seed,
                                                                "noise"))
        return torch.randn((self.block["n_group"], positions), generator=g,
                           device=device)

    def call_inputs(self, ctx, reqs: list) -> dict:
        P = self.positions(frames(self.cfg))
        return {"voc_noise": [self.noise(r, P, ctx.device) for r in reqs]}

    def waves(self, ref, prec: str, mels: str) -> list:
        out = []
        for r, m in zip(ref.reqs[: ref.n], ref.mels(mels)[: ref.n]):
            z = self.noise(r, self.positions(m.shape[-1]), ref.device)
            out.append(RW.infer(Precision(prec), ref.wts[self.name],
                                self.block, m, z, self.block["sigma"])
                       .double().cpu().numpy())
        return out

    def seconds_at_peak(self, run, r) -> float:
        return WW.ops(self.block, self.n_mels, self.positions(
            frames(self.cfg))) / peaks.FLOPS["bfloat16"]

    def counters(self) -> dict:
        voc = self._voc()
        return {"waveglow_calls": 0 if voc is None else voc.calls}
