"""Closed loop, one client: one sentence at a time through
``AdaptiveTTS.synthesize`` with the mix's vocoder, each with its prenet
masks (and the vocoder's own inputs) from its own seed; the next is sent
when the last one's waveform is on the host."""

from __future__ import annotations

import time

import inputs
from records import Call, span
from traffic.closed_batch import Workload as _Batch


class Workload(_Batch):
    def _batch(self, reqs: list) -> Call:
        ctx, p = self.ctx, self.p
        (r,) = reqs
        call = Call(vocoder=p["vocoder"], requests=reqs,
                    rows=1, mask_seed=r.seed)
        with span("inputs"):
            masks = inputs.prenet_masks(ctx.cfg, call.mask_seed, 1, ctx.device)
            voc_inputs = ctx.part.call_inputs(ctx, reqs)
        ctx.current = call
        call.t_start = r.t_due = time.perf_counter()
        with span("synthesize"):
            r.wav = ctx.tts.synthesize(r.text, vocoder=p["vocoder"],
                                       spk_emb=ctx.spk_emb, pre_masks=masks,
                                       **voc_inputs)
        call.t_end = r.t_done = time.perf_counter()
        return call

    def warmup(self) -> None:
        for _ in range(int(self.p.get("warmup_calls", 3))):
            self._batch(self._requests(1, "warmup"))
        self.n = 0

    def run(self, seconds: float) -> tuple:
        calls = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            calls.append(self._batch(self._requests(1, "window")))
        return ([r for c in calls for r in c.requests], calls, t0,
                calls[-1].t_end)
