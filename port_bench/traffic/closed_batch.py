"""Closed loop, one client: batches of ``batch`` sentences back to back
through ``AdaptiveTTS.synthesize_batch`` with the mix's vocoder, each
batch with its prenet masks (and WaveRNN noise) from its own seed.  The
next batch is sent when the last one's waveforms are on the host."""

from __future__ import annotations

import time

import inputs
from records import Call, Request, span
from traffic.text import batch_counts, sentence, sub_seed


class Workload:
    def __init__(self, ctx):
        self.ctx = ctx
        self.p = ctx.traffic
        self.n = 0                       # requests made so far

    def _requests(self, k: int, tag: str) -> list:
        """The next batch of ``k`` requests, its lengths
        ``text.batch_counts``'s."""
        p, seed = self.p, self.ctx.seed
        counts = batch_counts(p["phonemes"], sub_seed(seed, tag), self.n // k,
                              k)
        out = []
        for j, c in enumerate(counts):
            i = self.n + j
            out.append(Request(
                idx=i, text=sentence(c, sub_seed(seed, tag), i),
                n_phonemes=c, seed=sub_seed(seed, tag, "request", i),
                pinned=self.ctx.pinned(sub_seed(seed, tag, "pin", i))))
        self.n += k
        return out

    def _batch(self, reqs: list) -> Call:
        ctx, p = self.ctx, self.p
        B = len(reqs)
        call = Call(vocoder=p["vocoder"], requests=reqs,
                    rows=B, mask_seed=sub_seed(reqs[0].seed, "masks"))
        with span("inputs"):
            masks = inputs.prenet_masks(ctx.cfg, call.mask_seed, B, ctx.device)
            noise = ctx.voc_noise(reqs) if p["vocoder"] == "wavernn" else None
        ctx.current = call
        call.t_start = time.perf_counter()
        for r in reqs:
            r.t_due = call.t_start
        with span("synthesize_batch"):
            wavs = ctx.tts.synthesize_batch(
                [r.text for r in reqs], vocoder=p["vocoder"],
                spk_emb=ctx.spk_emb, pre_masks=masks, voc_noise=noise)
        call.t_end = time.perf_counter()
        for r, w in zip(reqs, wavs):
            r.t_done, r.wav = call.t_end, w
        return call

    def warmup(self) -> None:
        for _ in range(int(self.p.get("warmup_calls", 2))):
            self._batch(self._requests(self.p["batch"], "warmup"))
        self.n = 0

    def run(self, seconds: float) -> tuple:
        """(requests, calls, t0, t1): batches until ``seconds`` have
        passed; the window ends when the last batch's waveforms are on
        the host."""
        calls = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            calls.append(self._batch(self._requests(self.p["batch"], "window")))
        return ([r for c in calls for r in c.requests], calls, t0,
                calls[-1].t_end)
