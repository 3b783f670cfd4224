"""WaveRNN with the mixture-of-logistics output (fatchord/WaveRNN), served
through the sample-loop kernel K3: its weights, how it is built and fed,
and how the check judges it.

Each request's sampling noise comes from its seed, one fold row after
another as the served vocoder folds a mel of ``max_decoder_steps`` frames
(every row decodes to the cap: ``reduced: gate_bias``).  Two free-running
sample streams part for good at a near tie of the mixture choice, so the
waveforms are compared only for requests whose choice the noise pins
(``PIN``, the mix's ``pinned_share``); some unpinned requests are
followed step by step instead (``wavernn_step_miss``, see ``check.py``).
"""

from __future__ import annotations

import math

import torch

import parts
import weights as W
from metrics._common import frames, wavernn_folds
from reference import wavernn as RW
from reference.precision import Precision
from traffic.text import sub_seed
from work import peaks
from work import wavernn as WW

# added to the winner of a request's own Gumbel draw when the request's
# mixture choice is pinned: far beyond any difference of the mixture
# logits, so the noise alone decides the choice (a sampled request whose
# two computations part at a near tie cannot be compared sample by sample)
PIN = 1e3
_U_LO, _U_HI = 1e-5, 1.0 - 1e-5
# a sample step departs where the served sample and the reference's draw
# differ by more than this: ~10 x their rounding, below the distance
# between two mixture components' samples
STEP_TOL = 0.02


def noise(seed: int, steps: int, rows: int, device, *, pinned: bool,
          K: int = 10):
    """One request's ``(n1 (steps, rows, K), n2 (steps, rows))``: Gumbel
    noise for the mixture choice (pinned: its winner raised by PIN) and
    the logistic draw, from uniforms in (1e-5, 1 − 1e-5)."""
    g = torch.Generator(device=device).manual_seed(seed)
    u1 = torch.rand((steps, rows, K), generator=g, device=device)
    u2 = torch.rand((steps, rows), generator=g, device=device)
    u1 = _U_LO + (_U_HI - _U_LO) * u1
    u2 = _U_LO + (_U_HI - _U_LO) * u2
    n1 = -torch.log(-torch.log(u1))
    if pinned:
        n1 = n1 + PIN * torch.nn.functional.one_hot(
            n1.argmax(-1), K).to(n1.dtype)
    return n1, torch.log(u2) - torch.log1p(-u2)


class Part(parts.Part):
    name = "wavernn"

    def __init__(self, cfg: dict):
        super().__init__(cfg)
        self.v = dict(self.block,
                      upsample_factors=list(self.block["upsample_factors"]))

    def weight_spec(self) -> dict:
        v, n_mels = self.block, self.cfg["audio_params"]["n_mels"]
        c, ro, rnn, fc = (v["compute_dims"], v["res_out_dims"], v["rnn_dims"],
                          v["fc_dims"])
        d = ro // 4
        k = 2 * v["pad"] + 1
        s = {}

        def lin(name, n_out, n_in, bias=True):
            b = 1.0 / math.sqrt(n_in)
            s[f"{name}.weight"] = ((n_out, n_in), (-b, b))
            if bias:
                s[f"{name}.bias"] = ((n_out,), (-b, b))

        R = "upsample.resnet."
        b = 1.0 / math.sqrt(n_mels * k)
        s[R + "conv_in.weight"] = ((c, n_mels, k), (-b, b))
        W.bn(s, R + "batch_norm", c)
        for i in range(v["res_blocks"]):
            b = 1.0 / math.sqrt(c)
            s[f"{R}layers.{i}.conv1.weight"] = ((c, c, 1), (-b, b))
            s[f"{R}layers.{i}.conv2.weight"] = ((c, c, 1), (-b, b))
            W.bn(s, f"{R}layers.{i}.batch_norm1", c)
            W.bn(s, f"{R}layers.{i}.batch_norm2", c)
        b = 1.0 / math.sqrt(c)
        s[R + "conv_out.weight"] = ((ro, c, 1), (-b, b))
        s[R + "conv_out.bias"] = ((ro,), (-b, b))
        for i, f in enumerate(v["upsample_factors"]):
            s[f"upsample.up_layers.{2 * i + 1}.weight"] = (
                (1, 1, 1, 2 * f + 1), 1.0 / (2 * f + 1))
        lin("I", rnn, n_mels + d + 1)
        u = (-1.0 / math.sqrt(rnn), 1.0 / math.sqrt(rnn))
        for name, n_in in (("rnn1", rnn), ("rnn2", rnn + d)):
            s[f"{name}.weight_ih_l0"] = ((3 * rnn, n_in), u)
            s[f"{name}.weight_hh_l0"] = ((3 * rnn, rnn), u)
            s[f"{name}.bias_ih_l0"] = ((3 * rnn,), u)
            s[f"{name}.bias_hh_l0"] = ((3 * rnn,), u)
        lin("fc1", fc, rnn + d)
        lin("fc2", fc, fc + d)
        lin("fc3", 30, fc)
        # the output's bias by part: mixture weights and means near 0, the
        # log scales near -4, so that the logistics' scales (~0.02) leave
        # the samples inside [-1, 1] instead of clamped at its ends
        s["fc3.bias"] = ((30,), [(20, -0.1, 0.1), (10, -4.5, -3.5)])
        return s

    def build(self, sd: dict, device):
        from msa_tts_tpu_torch.vocoders.wavernn import (WaveRNN,
                                                        WaveRNNConfig,
                                                        WaveRNNModel)

        v, ap = self.block, self.cfg["audio_params"]
        wcfg = WaveRNNConfig(
            mode=v["voc_mode"], n_mels=ap["n_mels"], rnn_dims=v["rnn_dims"],
            fc_dims=v["fc_dims"], compute_dims=v["compute_dims"],
            res_out_dims=v["res_out_dims"], res_blocks=v["res_blocks"],
            hop_length=ap["hop_length"], sample_rate=ap["sample_rate"],
            pad=v["pad"], upsample_factors=tuple(v["upsample_factors"]))
        with torch.device(device):
            wm = WaveRNNModel(wcfg)
        wm.load_state_dict(sd, strict=True)
        return WaveRNN(wm, wcfg, gen_dtype=v["gen_dtype"], device=device)

    def stated(self) -> str:
        return self.block["gen_dtype"]

    def _noises(self, reqs: list, n_frames: int, device) -> list:
        """Each request's noise for the folds of a mel padded to
        ``n_frames`` frames."""
        v, hop = self.block, self.cfg["audio_params"]["hop_length"]
        _, n_pad = WW.fold_rows(n_frames, hop, v["target"], v["overlap"])
        L = v["target"] + 2 * v["overlap"]
        return [noise(sub_seed(r.seed, "noise"), L, n_pad, device,
                      pinned=r.pinned) for r in reqs]

    def call_inputs(self, ctx, reqs: list) -> dict:
        # the served vocoder pads a batch's mels to a multiple of 32 frames
        padded = -(-frames(self.cfg) // 32) * 32
        return {"voc_noise": self._noises(reqs, padded, ctx.device)}

    def hook(self, ctx) -> None:
        voc = ctx.tts._attached(self.name)
        run_folded = voc._run_folded

        def keep_folds(*a, **kw):
            # a device copy of each wanted unpinned row's raw folds
            samples, n_folds = run_folded(*a, **kw)
            call = ctx.current
            for r, x in zip(call.requests if call else [], samples):
                if ctx.keeper.wants(r) and not r.pinned:
                    r.kept["folds"] = x.clone()
            return samples, n_folds

        voc._run_folded = keep_folds

    def sample(self, draw, limits: dict) -> tuple:
        return (draw(int(limits["requests"]), pinned=True),
                draw(int(limits.get("followed_requests", 0)), pinned=False))

    def raw(self, ref, prec: str, mels: str, which: str) -> tuple:
        """The raw folds (B, n_pad, L) at ``prec`` from the mels
        ``ref.mels(mels)`` of the ``"compared"`` or ``"followed"``
        requests, and the real fold count."""
        key = ("wavernn.raw", prec, mels, which)
        if key not in ref.memo:
            rows = ref.rows(which)
            m = ref.mels(mels)[rows]
            bucket = -(-max(x.shape[-1] for x in m) // 32) * 32
            ref.memo[key] = RW.raw_samples(
                Precision(prec), ref.wts[self.name], self.v, m,
                self._noises(ref.reqs[rows], bucket, ref.device))
        return ref.memo[key]

    def waves(self, ref, prec: str, mels: str) -> list:
        samples, n_folds = self.raw(ref, prec, mels, "compared")
        return RW.unfold(self.v, samples, n_folds,
                         [x.shape[-1] for x in ref.mels(mels)[: ref.n]])

    def steps_missed(self, ref, stream, prec: str, mels: str) -> float:
        """The share of the followed requests' sample steps (real folds)
        at which ``stream`` (B, n_pad, L) departs by more than
        ``STEP_TOL`` (or is not a number) from the sample the reference
        at ``prec`` draws, from the mels ``ref.mels(mels)``, after the
        stream's previous samples."""
        rows = ref.rows("followed")
        m = ref.mels(mels)[rows]
        bucket = -(-max(x.shape[-1] for x in m) // 32) * 32
        drawn, n_folds = RW.raw_samples(
            Precision(prec), ref.wts[self.name], self.v, m,
            self._noises(ref.reqs[rows], bucket, ref.device), forced=stream)
        d = (drawn[:, :n_folds] - stream[:, :n_folds].float()).abs()
        return float((~(d <= STEP_TOL)).float().mean())

    def readings(self, ref, limits: dict, prec: str, mels: str,
                 control: str | None = None) -> dict:
        """``wavernn_step_miss``, where the limits follow requests: the
        served system's raw folds kept in the window, or the reference's
        own at ``control``, judged step by step."""
        if "followed_requests" not in limits:
            return {}
        followed = ref.reqs[ref.rows("followed")]
        if not followed:
            stream = None
        elif control is None:
            stream = (None if any("folds" not in r.kept for r in followed)
                      else torch.stack([r.kept["folds"] for r in followed]))
        else:
            stream = self.raw(ref, control, mels, "followed")[0]
        return {"wavernn_step_miss":
                float("inf") if stream is None else
                self.steps_missed(ref, stream, prec, mels)}

    def seconds_at_peak(self, run, r) -> float:
        v, n_mels = self.block, self.cfg["audio_params"]["n_mels"]
        n, L = wavernn_folds(self.cfg)
        conv = peaks.conv_type(run.cudnn_tf32)
        return (WW.conditioning_ops(v, n_mels, 1, frames(self.cfg))
                / peaks.FLOPS[conv]
                + WW.projection_ops(v, n_mels, n, L) / peaks.FLOPS[
                    "tf32" if run.matmul_tf32 else "float32"]
                + WW.loop_ops(v, n, L) / peaks.FLOPS[v["gen_dtype"]])

    def counters(self) -> dict:
        from msa_tts_tpu_torch.vocoders import cuda_gen

        return {"k3_launches": cuda_gen.GEN_LAUNCHES}
