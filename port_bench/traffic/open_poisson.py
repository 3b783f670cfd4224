"""Open loop: independent users.  Requests of single sentences arrive as
a Poisson process at ``rate_per_s`` and are submitted, in process and with no socket,
to the batcher of a ``TTSServer`` over the system (``max_batch``,
``window_ms``, ``buckets``, ``text_pad_multiple`` as the mix sets them).
So that every seed asks for the same work, the gaps between arrivals
come in blocks: one block is the exponential distribution's ``block``
quantiles, shuffled by the seed.  A request is timed from its due time
to its waveform on the host; the server draws each batch's masks itself.
"""

from __future__ import annotations

import collections
import math
import threading
import time

import numpy as np

from records import Call, Request, span
from traffic.text import phoneme_counts, sentence, sub_seed


def gaps(p: dict, seed: int, n: int) -> list:
    """``n`` gaps in seconds between arrivals."""
    k = int(p["block"])
    q = [-math.log(1.0 - (i + 0.5) / k) / p["rate_per_s"] for i in range(k)]
    out, b = [], 0
    while len(out) < n:
        rng = np.random.default_rng(sub_seed(seed, "gaps", b))
        out += [q[i] for i in rng.permutation(k)]
        b += 1
    return out[:n]


class Workload:
    def __init__(self, ctx):
        self.ctx = ctx
        self.p = ctx.traffic
        self.calls: list = []
        self._lock = threading.Lock()
        # text → its submitted requests not yet in a batch, in order (the
        # batcher takes them first in, first out)
        self._pending = collections.defaultdict(collections.deque)
        self.server = ctx.system.server(ctx.spk_emb, self.p)
        tts = ctx.tts
        inner = tts.synthesize_batch

        def recorded(texts, voice=None, **kw):
            # pass-through that notes the batch the batcher formed (its
            # rows in order and its padded row count) and spans the call
            call = Call(vocoder=kw.get("vocoder"),
                        rows=max(len(texts), kw.get("pad_batch_to") or 1),
                        t_start=time.perf_counter())
            with self._lock:
                call.requests = [self._pending[t].popleft()
                                 if self._pending[t] else None for t in texts]
                self.calls.append(call)
            self.ctx.current = call
            with span("synthesize_batch"):
                out = inner(texts, voice, **kw)
            call.t_end = time.perf_counter()
            return out

        tts.synthesize_batch = recorded

    def _requests(self, n: int, tag: str) -> list:
        seed = self.ctx.seed
        out = []
        for i, c in enumerate(phoneme_counts(self.p["phonemes"],
                                             sub_seed(seed, tag), n)):
            out.append(Request(idx=i, text=sentence(c, sub_seed(seed, tag), i),
                               n_phonemes=c,
                               seed=sub_seed(seed, tag, "request", i)))
        return out

    def _submit(self, r: Request):
        with self._lock:
            self._pending[r.text].append(r)
        fut = self.server.batcher.submit(r.text, None, self.p["vocoder"])

        def done(f, r=r):
            t = time.perf_counter()
            if f.exception() is not None:
                r.error = repr(f.exception())
            else:
                r.wav, r.t_done = f.result(), t

        fut.add_done_callback(done)
        return fut

    def warmup(self) -> None:
        """Every bucket once (twice for the first): b requests at once,
        which the batcher collects into one batch of bucket b."""
        self.server.batcher.start()
        reqs = self._requests(sum(self.p["buckets"]) + self.p["buckets"][0],
                              "warmup")
        i = 0
        for b in [self.p["buckets"][0]] + list(self.p["buckets"]):
            futs = [self._submit(r) for r in reqs[i: i + b]]
            i += b
            for f in futs:
                f.result()
        self.calls.clear()

    def run(self, seconds: float) -> tuple:
        """(requests, calls, t0, t_close): arrivals due in [t0, t0 +
        seconds); the window's requests are waited for until a minute
        past the close, and a request still not done then has failed."""
        p = self.p
        n_max = int(p["rate_per_s"] * seconds * 2 + 64)
        reqs = self._requests(n_max, "window")
        stats = self.server.stats
        n_batches, n_rows = stats.batches_total, stats.batched_requests_total
        futs, window = [], []
        self.late_s = []
        t0 = time.perf_counter() + 0.05
        due = []
        t = t0
        for gap in gaps(p, self.ctx.seed, n_max):
            t += gap
            if t >= t0 + seconds:
                break
            due.append(t)
        with span("window"):
            for t_due in due:
                with span("sleep"):
                    while (left := t_due - time.perf_counter()) > 0:
                        time.sleep(min(left, 0.002))
                self.late_s.append(time.perf_counter() - t_due)
                with span("submit"):
                    r = reqs[len(window)]
                    r.t_due = t_due
                    window.append(r)
                    futs.append(self._submit(r))
            with span("sleep"):
                while (left := t0 + seconds - time.perf_counter()) > 0:
                    time.sleep(min(left, 0.002))
        with span("drain"):
            deadline = t0 + seconds + 60.0
            for f in futs:
                try:
                    f.result(timeout=max(deadline - time.perf_counter(), 0.0))
                except Exception:           # noqa: BLE001 — counted as failed
                    pass
        self.server.batcher.stop()
        del self.ctx.tts.synthesize_batch           # the unwrapped method
        # the batcher's counters across the window: rows per batch
        self.batch_rows = ((stats.batched_requests_total - n_rows)
                           / max(stats.batches_total - n_batches, 1))
        for r in window:
            if r.t_done is None and r.error is None:
                r.error = "not done a minute after the window closed"
        return window, list(self.calls), t0, t0 + seconds
