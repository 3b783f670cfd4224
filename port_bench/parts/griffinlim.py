"""Griffin-Lim, which the port serves with no model attached
(``AdaptiveTTS._vocode``): the log-mel's magnitude, then momentum
Griffin-Lim for the configuration's ``audio_params.griffinlim_iters``,
in float32 (its product with TF32 off, PyTorch's default).

Each request's starting phase comes from its seed (``gl_phase``), shaped
as the port takes it: alone (one request in its call), (n_freqs, F) over
the mel's F frames; in a batch, one such phase a row over the frames the
batch is padded to, a multiple of 32.  The phase is made for a mel of
``max_decoder_steps`` frames: every row decodes to the cap
(``reduced: gate_bias``).  A mix served through the batcher, which draws
the phase itself, is not supported.
"""

from __future__ import annotations

import math

import torch

import parts
from check import request_call
from metrics._common import frames
from reference import griffinlim as RG
from reference.precision import Precision
from traffic.text import sub_seed
from work import griffinlim as WG
from work import peaks


class Part(parts.Part):
    name = "griffinlim"

    def __init__(self, cfg: dict):
        super().__init__(cfg)
        self.ap = cfg["audio_params"]
        self.n_freqs = self.ap["n_fft"] // 2 + 1

    def stated(self) -> str:
        return "float32"

    def lower(self) -> str:
        # its product runs with TF32 off, and cuFFT has no TF32 path
        return "tf32"

    def _padded(self, batched: bool) -> int | None:
        """The frames a batch pads its mels to (None: alone, unpadded)."""
        return -(-frames(self.cfg) // 32) * 32 if batched else None

    def phase(self, r, batched: bool, device) -> torch.Tensor:
        """Request ``r``'s (n_freqs, F) starting phase, uniform in
        [−π, π) from its seed, F the frames of its magnitude."""
        F = max(self._padded(batched) or frames(self.cfg),
                self.ap["n_fft"] // self.ap["hop_length"] + 1)
        g = torch.Generator(device=device).manual_seed(sub_seed(r.seed,
                                                                "phase"))
        u = torch.rand((self.n_freqs, F), generator=g, device=device)
        return u * (2.0 * math.pi) - math.pi

    def call_inputs(self, ctx, reqs: list) -> dict:
        batched = len(reqs) > 1
        ph = [self.phase(r, batched, ctx.device) for r in reqs]
        return {"gl_phase": torch.stack(ph) if batched else ph[0]}

    def waves(self, ref, prec: str, mels: str) -> list:
        out = []
        for r, m in zip(ref.reqs[: ref.n], ref.mels(mels)[: ref.n]):
            batched = len(request_call(r, ref.calls)[0].requests) > 1
            out.append(RG.invert(Precision(prec), self.ap, m,
                                 self.phase(r, batched, ref.device),
                                 self._padded(batched)))
        return out

    def seconds_at_peak(self, run, r) -> float:
        return WG.ops(self.ap, 1, frames(self.cfg)) / peaks.FLOPS["float32"]
