"""TTS serving over HTTP with dynamic batching (counterpart of
``msa_tts_tpu/server.py``).

* :class:`DynamicBatcher`: one executor thread owns the device.
  Concurrent requests accumulate for up to ``window_ms`` or
  ``max_batch`` and run as ONE batched synthesis per (voice, vocoder)
  group (one decoder-kernel launch on a GPU).
* Shape bucketing: batch sizes snap to ``batch_buckets`` and text
  lengths to ``text_pad_multiple`` (``synthesize_batch``'s pad options;
  the padding is masked out of the math).
* :class:`TTSServer`: a stdlib ``ThreadingHTTPServer`` front end:
  ``POST /synthesize`` ``{"text": ..., "voice": ..., "vocoder": ...}``
  → ``audio/wav``; ``POST /synthesize_stream`` → chunked ``audio/wav``
  (through :class:`stream_mux.StreamMultiplexer` with
  ``stream_multiplex=N``); ``GET /voices``, ``GET /stats``,
  ``GET /health``.  No extra dependencies.

Latency/throughput knob: ``window_ms=0`` degenerates to per-request
execution (lowest latency); larger windows trade tail latency for
aggregate throughput under load.

While a ``torch.profiler`` session runs, the batcher records spans
(``utils/profiling.py``): ``serve.submit`` on the caller's thread,
``serve.idle`` (waiting for a first request), ``serve.window`` (holding
the window open after it), ``serve.batch`` (one group's device call,
with its id and rows; the ``tts.*`` spans nest in it) and one
``serve.queue`` per request, from its submit to the start of the batch
that serves it, with the request's id.  ``/stats`` reports the same
queue waits (``queue_wait_p50_s``, ``queue_wait_p95_s``) at all times.
"""

from __future__ import annotations

import io
import itertools
import json
import queue
import ssl
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Sequence

import numpy as np

from .serving import AdaptiveTTS, Voice
from .utils import profiling
from .utils.profiling import annotate


class _QuietThreadingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer that treats a client vanishing mid-response
    as routine instead of printing a traceback: streaming clients
    disconnect whenever they've heard enough, and at server teardown
    in-flight sockets get reset — neither is a server error."""

    daemon_threads = True

    def handle_error(self, request, client_address):  # noqa: D102
        import sys

        exc = sys.exc_info()[1]
        if isinstance(exc, (ConnectionResetError, BrokenPipeError,
                            ConnectionAbortedError)):
            return
        super().handle_error(request, client_address)


@dataclass
class _Request:
    text: str
    voice: str | None
    vocoder: str
    future: Future = field(default_factory=Future)
    t_enqueue: float = field(default_factory=time.monotonic)
    t_enqueue_ns: int = field(default_factory=time.time_ns)  # trace clock
    ident: int = 0


class ServerStats:
    """Thread-safe rolling serving metrics."""

    def __init__(self, window: int = 1024):
        self._lock = threading.Lock()
        self.requests_total = 0
        self.errors_total = 0
        # streaming clients hanging up mid-utterance (heard enough) are
        # routine, not failures — counted separately so a healthy
        # deployment's error rate stays honest
        self.client_disconnects_total = 0
        self.batches_total = 0
        self.batched_requests_total = 0
        self._latencies = deque(maxlen=window)
        self._queue_waits = deque(maxlen=window)

    def record_queue_waits(self, waits_s) -> None:
        """Each request's wait from submit to the start of its batch."""
        with self._lock:
            self._queue_waits.extend(waits_s)

    def record_batch(self, n: int) -> None:
        with self._lock:
            self.batches_total += 1
            self.batched_requests_total += n

    def record_request(self, latency_s: float, error: bool,
                       disconnect: bool = False) -> None:
        with self._lock:
            self.requests_total += 1
            if disconnect:
                self.client_disconnects_total += 1
            elif error:
                self.errors_total += 1
            else:
                self._latencies.append(latency_s)

    def snapshot(self) -> dict:
        with self._lock:
            lat = sorted(self._latencies)
            waits = sorted(self._queue_waits)

            def pct(p, v=lat):
                return v[min(len(v) - 1, int(p * len(v)))] if v else None

            mean_batch = (
                self.batched_requests_total / self.batches_total
                if self.batches_total else None
            )
            return {
                "requests_total": self.requests_total,
                "errors_total": self.errors_total,
                "client_disconnects_total": self.client_disconnects_total,
                "batches_total": self.batches_total,
                "mean_batch_size": mean_batch,
                "latency_p50_s": pct(0.50),
                "latency_p95_s": pct(0.95),
                "queue_wait_p50_s": pct(0.50, waits),
                "queue_wait_p95_s": pct(0.95, waits),
            }


class DynamicBatcher:
    """Accumulate concurrent synthesis requests into batched device
    calls.  ``synth_fn(texts, voice_name, vocoder, pad_batch_to)`` must
    return one waveform per text."""

    def __init__(
        self,
        synth_fn,
        *,
        max_batch: int = 8,
        window_ms: float = 25.0,
        batch_buckets: Sequence[int] = (1, 2, 4, 8),
        stats: ServerStats | None = None,
    ):
        self._synth = synth_fn
        self.max_batch = int(max_batch)
        # a max_batch above the largest bucket would collect groups no
        # bucket covers (bucket() would clamp DOWN): extend the ladder
        # by powers of two instead
        batch_buckets = list(batch_buckets)
        while max(batch_buckets) < self.max_batch:
            batch_buckets.append(max(batch_buckets) * 2)
        self.window_s = float(window_ms) / 1e3
        self.batch_buckets = tuple(sorted(batch_buckets))
        self.stats = stats or ServerStats()
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._request_ids = itertools.count(1)
        self._batch_ids = itertools.count(1)

    # ------------------------------------------------------------- api
    def start(self) -> "DynamicBatcher":
        self._thread = threading.Thread(
            target=self._loop, name="msa-tts-batcher", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._q.put(None)  # wake the worker
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        # fail any requests still queued behind the sentinel — their
        # clients get an immediate error instead of a full timeout
        while True:
            try:
                r = self._q.get_nowait()
            except queue.Empty:
                break
            if r is not None and not r.future.done():
                r.future.set_exception(
                    RuntimeError("server shutting down")
                )

    def submit(self, text: str, voice: str | None = None,
               vocoder: str = "griffinlim") -> Future:
        with annotate("serve.submit"):
            req = _Request(text=text, voice=voice, vocoder=vocoder,
                           ident=next(self._request_ids))
            if self._stop.is_set():
                # the worker is gone — a queued request would never
                # resolve and its client would wait out the full timeout
                req.future.set_exception(
                    RuntimeError("server shutting down"))
                return req.future
            self._q.put(req)
            return req.future

    def bucket(self, n: int) -> int:
        for b in self.batch_buckets:
            if n <= b:
                return b
        return self.batch_buckets[-1]

    # ---------------------------------------------------------- worker
    def _collect(self) -> list[_Request]:
        with annotate("serve.idle"):
            first = self._q.get()
        if first is None:
            return []
        batch = [first]
        deadline = time.monotonic() + self.window_s
        with annotate("serve.window"):
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    break
                batch.append(nxt)
        return batch

    def _loop(self) -> None:
        while not self._stop.is_set():
            batch = self._collect()
            if not batch:
                continue
            # homogeneous device calls: group by (voice, vocoder)
            groups: dict = {}
            for r in batch:
                groups.setdefault((r.voice, r.vocoder), []).append(r)
            for (voice, vocoder), reqs in groups.items():
                self._run_group(voice, vocoder, reqs)

    def _run_group(self, voice, vocoder, reqs: list[_Request]) -> None:
        t, t_ns = time.monotonic(), time.time_ns()
        self.stats.record_queue_waits([t - r.t_enqueue for r in reqs])
        if profiling.on():
            for r in reqs:
                profiling.RECORDER.add("serve.queue", r.t_enqueue_ns, t_ns,
                                       ident=r.ident)
        with annotate("serve.batch", next(self._batch_ids), len(reqs)):
            self._run_batch(voice, vocoder, reqs)

    def _run_batch(self, voice, vocoder, reqs: list[_Request]) -> None:
        try:
            wavs = self._synth(
                [r.text for r in reqs], voice, vocoder,
                self.bucket(len(reqs)),
            )
        except Exception as e:  # noqa: BLE001 — surfaced per request
            import traceback

            print(f"[server] batch of {len(reqs)} failed: {e!r}",
                  flush=True)
            traceback.print_exc()
            for r in reqs:
                # record before set_exception — same observable-before-
                # recorded race as the success path below
                self.stats.record_request(
                    time.monotonic() - r.t_enqueue, error=True
                )
                r.future.set_exception(e)
            return
        self.stats.record_batch(len(reqs))
        for r, w in zip(reqs, wavs):
            # record BEFORE set_result: the moment the future resolves
            # the client can observe completion and query /stats — stats
            # must already reflect this request (otherwise a client that
            # polls /stats right after its response sees it missing)
            self.stats.record_request(
                time.monotonic() - r.t_enqueue, error=False
            )
            r.future.set_result(w)


class TTSServer:
    """HTTP serving front end over :class:`AdaptiveTTS`.

        server = TTSServer(tts)
        server.register_voice("alice", voice)
        port = server.start()          # daemon thread
        # POST http://host:port/synthesize {"text": "...", "voice": "alice"}
        server.stop()
    """

    def __init__(
        self,
        tts: AdaptiveTTS,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        default_spk_emb: np.ndarray | None = None,
        max_batch: int = 8,
        window_ms: float = 25.0,
        batch_buckets: Sequence[int] = (1, 2, 4, 8),
        text_pad_multiple: int = 16,
        request_timeout_s: float = 300.0,
        stream_multiplex: int = 0,
        stream_mux_t_cap: int = 128,
        stream_mux_adapted: int | None = None,
        stream_mux_max_pending: int | None = None,
    ):
        self.tts = tts
        self.host = host
        self._port = port
        self.text_pad_multiple = int(text_pad_multiple)
        self.request_timeout_s = float(request_timeout_s)
        self._voices: dict[str, Voice] = {}
        self._default_spk_emb = (
            np.asarray(default_spk_emb, np.float32)
            if default_spk_emb is not None else None
        )
        self.stats = ServerStats()
        self.recorder = tts.recorder
        self._device_lock = threading.Lock()
        self.batcher = DynamicBatcher(
            self._synth_group, max_batch=max_batch, window_ms=window_ms,
            batch_buckets=batch_buckets, stats=self.stats,
        )
        # stream_multiplex=N decodes up to N concurrent /synthesize_stream
        # requests in ONE segment-kernel launch per tick (stream_mux.py)
        # instead of time-slicing the device.  Adapted voices get their
        # OWN multiplexer (per-slot decoder weights on the plain torch
        # engine); over-cap texts and saturation go to the per-stream
        # path.  stream_mux_adapted=0 disables the adapted
        # mux; None mirrors stream_multiplex.  The adapted mux is built
        # on the first register_voice, so a base-voice-only deployment
        # never builds it.
        self.stream_mux = None
        self.adapted_mux = None
        self._adapted_mux_slots = (
            int(stream_multiplex) if stream_mux_adapted is None
            else int(stream_mux_adapted)
        )
        self._mux_t_cap = int(stream_mux_t_cap)
        self._mux_max_pending = stream_mux_max_pending
        self._adapted_mux_lock = threading.Lock()
        if stream_multiplex:
            from .stream_mux import StreamMultiplexer

            # the base mux decodes as the model's own decode_backend
            # names it: the segment kernel on the card unless `torch`
            # was named there, the plain segment on a CPU
            self.stream_mux = StreamMultiplexer(
                tts, n_slots=int(stream_multiplex),
                t_cap=int(stream_mux_t_cap),
                device_lock=self._device_lock,
                backend=tts.decode_backend,
                max_pending=stream_mux_max_pending,
            )
        self._httpd: ThreadingHTTPServer | None = None
        self._http_thread: threading.Thread | None = None

    # ------------------------------------------------------------- api
    def register_voice(self, name: str, voice: Voice) -> None:
        self._voices[name] = voice
        self._ensure_adapted_mux()

    def _ensure_adapted_mux(self) -> None:
        """Build the adapted-voice multiplexer on first use (idempotent,
        thread-safe)."""
        if self.adapted_mux is not None or not self._adapted_mux_slots:
            return
        from .stream_mux import StreamMultiplexer

        with self._adapted_mux_lock:
            if self.adapted_mux is not None:
                return
            self.adapted_mux = StreamMultiplexer(
                self.tts, n_slots=self._adapted_mux_slots,
                t_cap=self._mux_t_cap,
                device_lock=self._device_lock,
                backend="torch", per_slot_params=True,
                max_pending=self._mux_max_pending,
            )

    def start(self) -> int:
        """Start batcher + HTTP listener; returns the bound port."""
        self.batcher.start()
        handler = _make_handler(self)
        self._httpd = _QuietThreadingHTTPServer(
            (self.host, self._port), handler
        )
        self._port = self._httpd.server_address[1]
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="msa-tts-http",
            daemon=True,
        )
        self._http_thread.start()
        return self._port

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._http_thread is not None:
            self._http_thread.join(timeout=30)
            self._http_thread = None
        self.batcher.stop()
        if self.stream_mux is not None:
            self.stream_mux.close()
        if self.adapted_mux is not None:
            self.adapted_mux.close()

    @property
    def port(self) -> int:
        return self._port

    def warmup(self, texts: Sequence[str],
               vocoder: str = "griffinlim") -> None:
        """Run every batch bucket and one stream for representative
        ``texts`` once (kernel builds, packed weights, the allocator's
        pools), so the first real traffic sees steady-state latency.
        Run it once at deploy, before ``start`` opens the port.  Uses
        the default voice when the server has one, else the first
        registered voice; a no-op (with a notice) if neither exists."""
        voice_name = None
        if self._default_spk_emb is None:
            if not self._voices:
                print("[server] warmup skipped: no default_spk_emb and "
                      "no registered voices")
                return
            voice_name = next(iter(sorted(self._voices)))
        buckets = [
            b for b in self.batcher.batch_buckets
            if b <= self.batcher.max_batch
        ]
        for b in buckets:
            for t in texts:
                self._synth_group([t] * b, voice_name, vocoder, b)
        # streaming runs its own kernel (the segment decoder): drain one
        # stream per text so the first /synthesize_stream client does
        # not pay its build while holding _device_lock
        for t in texts:
            for _ in self.stream_chunks(t, voice_name, vocoder):
                pass
        # the adapted-voice mux runs its own engine: warm it through the
        # first registered voice, unless the loop above already streamed
        # through it (no default_spk_emb: voice_name was that voice)
        if (self.adapted_mux is not None and self._voices
                and voice_name is None):
            first = next(iter(sorted(self._voices)))
            for t in texts:
                for _ in self.stream_chunks(t, first, vocoder):
                    pass

    # ------------------------------------------------------ device call
    def servable_vocoders(self) -> set:
        """Vocoders this server can return as audio: those attached
        (Griffin-Lim by default).  The library-level ``"none"`` (raw
        mel) is excluded: flattened mel bytes under an audio/wav content
        type would be well-formed garbage."""
        return set(self.tts._vocoders)

    def _resolve_voice(self, voice_name):
        """Voice-name → (Voice | None, default spk_emb | None); raises
        on an unknown name or when neither a voice nor a default exists."""
        voice = None
        spk_emb = self._default_spk_emb
        if voice_name is not None:
            voice = self._voices.get(voice_name)
            if voice is None:
                raise KeyError(f"unknown voice: {voice_name!r}")
        elif spk_emb is None:
            raise ValueError(
                "no voice given and the server has no default_spk_emb"
            )
        return voice, spk_emb

    def _synth_group(self, texts, voice_name, vocoder, pad_batch_to):
        voice, spk_emb = self._resolve_voice(voice_name)
        with self._device_lock:
            return self.tts.synthesize_batch(
                texts, voice, vocoder=vocoder, spk_emb=spk_emb,
                text_pad_multiple=self.text_pad_multiple,
                pad_batch_to=pad_batch_to,
            )

    def stream_chunks(self, text: str, voice_name: str | None,
                      vocoder: str):
        """Generator of float32 wav chunks for /synthesize_stream.
        Streaming bypasses the dynamic batcher (it optimizes
        time-to-first-audio, not aggregate throughput); the device lock
        keeps its device work from interleaving with batched calls.

        The lock is taken per ``next()`` — i.e. around the device work
        that produces each chunk — and RELEASED while the caller writes
        to the client socket, so one slow streaming client cannot wedge
        the batcher's /synthesize traffic behind a held lock.

        With ``stream_multiplex=N`` concurrent streams decode together
        in one segment-kernel call per tick (stream_mux.py).  Adapted
        voices route to the per-slot-weights multiplexer (each slot
        decodes under its own adapted params); over-cap texts and a
        saturated mux go to the per-stream path."""
        from .stream_mux import MuxSaturated

        voice, spk_emb = self._resolve_voice(voice_name)
        mux = self.adapted_mux if voice is not None else self.stream_mux
        if mux is not None and (voice is not None or spk_emb is not None):
            try:                    # eager validation — no chunks yet
                muxed = mux.stream(
                    text, spk_emb=spk_emb, voice=voice, vocoder=vocoder
                )
            except (ValueError, MuxSaturated):
                # text longer than the mux t_cap, or queue full —
                # degrade to the time-sliced solo path
                muxed = None
            if muxed is not None:
                yield from muxed
                return
        # pad the text length like the batched path (the padding is
        # masked out of the math: serving.synthesize_stream)
        gen = self.tts.synthesize_stream(
            text, voice, vocoder=vocoder, spk_emb=spk_emb,
            text_pad_multiple=self.text_pad_multiple,
        )
        while True:
            with self._device_lock:
                try:
                    chunk = next(gen)
                except StopIteration:
                    return
            yield chunk

    # ------------------------------------------------------------- wavs
    def encode_wav(self, wav: np.ndarray) -> bytes:
        from scipy.io import wavfile

        sr = int(self.tts.params["audio_params"]["sample_rate"])
        wav = np.asarray(wav, dtype=np.float32)
        # Hard-clip out-of-range samples — the same limiter the
        # streaming endpoint applies (which cannot peak-normalize: the
        # peak isn't known until the last chunk), so one utterance
        # sounds identical from either endpoint.
        wav = np.clip(wav, -1.0, 1.0)
        buf = io.BytesIO()
        wavfile.write(buf, sr, (wav * 32767.0).astype(np.int16))
        return buf.getvalue()


def _arg_parser():
    import argparse

    ap = argparse.ArgumentParser(description="msa_tts_tpu_torch HTTP server")
    ap.add_argument("--experiment_path", required=True)
    ap.add_argument("--checkpoint_id", default="0")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve from (default: cuda, which "
                         "fails without a GPU; cpu runs the kernels' plain "
                         "versions)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--window_ms", type=float, default=25.0)
    ap.add_argument("--max_batch", type=int, default=8)
    ap.add_argument("--speaker", default=None)
    ap.add_argument("--voices_dir", default=None)
    ap.add_argument("--warmup_text", action="append", default=None)
    ap.add_argument("--stream_multiplex", type=int, default=0,
                    help="decode up to N concurrent /synthesize_stream "
                         "requests in one segment launch per tick "
                         "(continuous batching; 0 = per-stream)")
    ap.add_argument("--stream_mux_adapted", type=int, default=None,
                    help="slots for the ADAPTED-voice multiplexer "
                         "(per-slot decoder weights; default mirrors "
                         "--stream_multiplex, 0 disables)")
    ap.add_argument("--stream_mux_max_pending", type=int, default=None,
                    help="bound each mux's admission queue; beyond it "
                         "streams shed to the solo path (backpressure)")
    return ap


def main(argv=None):
    """Serve a trained experiment over HTTP:

        python -m msa_tts_tpu_torch.server --experiment_path <dir> \\
            [--checkpoint_id 0] [--device cuda] [--port 8080] \\
            [--speaker p225] [--warmup_text "..."]

    The model is served from the GPU unless ``--device cpu`` is given.
    The default voice comes from the experiment's ``spk_emb.pkl``
    (``--speaker`` picks one; otherwise the first).  ``--voices_dir``
    registers every ``*.voice`` file in it (written by either package's
    ``AdaptiveTTS.save_voice``) under its stem name.
    """
    import glob
    import os
    import pickle

    args = _arg_parser().parse_args(argv)
    if args.voices_dir and not os.path.isdir(args.voices_dir):
        raise FileNotFoundError(
            f"--voices_dir {args.voices_dir!r} is not a directory")

    tts = AdaptiveTTS.from_experiment(
        args.experiment_path, args.checkpoint_id, device=args.device
    )
    emb = None
    emb_path = tts.params.get("spk_emb_path")
    if emb_path and os.path.exists(emb_path):
        with open(emb_path, "rb") as f:
            table = pickle.load(f)
        key = args.speaker or sorted(table.keys())[0]
        v = table[key]
        emb = np.asarray(
            v["mean"] if isinstance(v, dict) else v, np.float32
        )
        print(f"[server] default voice: speaker {key!r}")

    server = TTSServer(
        tts, host=args.host, port=args.port, default_spk_emb=emb,
        window_ms=args.window_ms, max_batch=args.max_batch,
        stream_multiplex=args.stream_multiplex,
        stream_mux_adapted=args.stream_mux_adapted,
        stream_mux_max_pending=args.stream_mux_max_pending,
    )
    if args.voices_dir:
        for p in sorted(glob.glob(os.path.join(args.voices_dir,
                                               "*.voice"))):
            name = os.path.splitext(os.path.basename(p))[0]
            server.register_voice(name, tts.load_voice(p))
            print(f"[server] registered voice {name!r}")
    if args.warmup_text:
        print("[server] warming up ...")
        server.warmup(args.warmup_text)
    port = server.start()
    print(f"[server] listening on http://{args.host}:{port}")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        print("[server] shutting down")
        server.stop()


def _make_handler(server: TTSServer):
    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 for chunked streaming responses; every non-streaming
        # response carries an explicit Content-Length
        protocol_version = "HTTP/1.1"

        # quiet by default; errors still surface via status codes
        def log_message(self, fmt, *args):  # noqa: D102
            pass

        def _check_vocoder(self, name) -> None:
            ok = server.servable_vocoders()
            if name not in ok:
                raise ValueError(
                    f"vocoder {name!r} is not servable here; "
                    f"available: {sorted(ok)}"
                )

        def _check_voice(self, name) -> None:
            # validate at parse time → a client typo is a 400, not a
            # 500 + server-side traceback from inside the batcher thread
            try:
                server._resolve_voice(name)
            except (KeyError, ValueError) as e:
                raise ValueError(str(e)) from e

        def _send_json(self, code: int, obj: dict) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 — http.server API
            if self.path == "/health":
                # Surface the active phonemizer: "fallback" means text
                # requests are served with approximate rule-based phones
                # (espeak missing) — degraded quality, not an outage.
                g2p_backend = getattr(
                    server.tts.g2p, "backend_name", "unknown"
                )
                self._send_json(200, {
                    "status": "ok",
                    "g2p_backend": g2p_backend,
                    "g2p_degraded": g2p_backend == "fallback",
                    # which compute paths serve this deployment
                    "decode_backend": server.tts.decode_backend,
                    "device": str(server.tts.device),
                    # parallel: {dp: N} — synthesize_batch's devices;
                    # {tp: M} — the devices every product splits over
                    "dp": getattr(server.tts, "_dp", 1),
                    "tp": getattr(server.tts, "_tp", 1),
                    "stream_multiplex": (
                        server.stream_mux.B
                        if server.stream_mux is not None else 0
                    ),
                    "stream_mux_backend": (
                        server.stream_mux.backend
                        if server.stream_mux is not None else None
                    ),
                    # adapted-voice continuous batching (per-slot
                    # decoder weights on the plain torch engine)
                    "stream_mux_adapted": (
                        server.adapted_mux.B
                        if server.adapted_mux is not None else 0
                    ),
                })
            elif self.path == "/stats":
                snap = server.stats.snapshot()
                if server.stream_mux is not None:
                    snap["stream_mux"] = server.stream_mux.metrics()
                if server.adapted_mux is not None:
                    snap["adapted_mux"] = server.adapted_mux.metrics()
                self._send_json(200, snap)
            elif self.path == "/voices":
                self._send_json(
                    200, {"voices": sorted(server._voices.keys())}
                )
            else:
                self._send_json(404, {"error": "not found"})

        def do_POST(self):  # noqa: N802 — http.server API
            if self.path == "/synthesize_stream":
                self._do_stream()
                return
            if self.path != "/synthesize":
                self._send_json(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(req, dict):
                    raise ValueError("body must be a JSON object")
                text = req["text"]
                if not isinstance(text, str) or not text.strip():
                    raise ValueError("'text' must be a non-empty string")
                self._check_vocoder(req.get("vocoder", "griffinlim"))
                self._check_voice(req.get("voice"))
            except (KeyError, TypeError, ValueError,
                    json.JSONDecodeError) as e:
                self._send_json(400, {"error": str(e)})
                return
            fut = server.batcher.submit(
                text, req.get("voice"), req.get("vocoder", "griffinlim")
            )
            try:
                wav = fut.result(timeout=server.request_timeout_s)
            except Exception as e:  # noqa: BLE001 — client-facing error
                self._send_json(500, {"error": str(e)})
                return
            body = server.encode_wav(wav)
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _do_stream(self):
            """Chunked streaming synthesis: a WAV header with the
            0xFFFFFFFF streaming-length convention, then PCM16 chunks as
            the pipeline produces them — time-to-first-byte is one
            decode segment + one vocode chunk, not the whole utterance."""
            import struct

            t0 = time.monotonic()
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                text = req["text"]
                if not isinstance(text, str) or not text.strip():
                    raise ValueError("'text' must be a non-empty string")
                self._check_vocoder(req.get("vocoder", "griffinlim"))
                self._check_voice(req.get("voice"))
            except (KeyError, TypeError, ValueError,
                    json.JSONDecodeError) as e:
                self._send_json(400, {"error": str(e)})
                return
            sr = int(server.tts.params["audio_params"]["sample_rate"])
            try:
                gen = server.stream_chunks(
                    text, req.get("voice"),
                    req.get("vocoder", "griffinlim"),
                )
                first = next(gen, None)
            except Exception as e:  # noqa: BLE001 — client-facing
                server.stats.record_request(
                    time.monotonic() - t0, error=True
                )
                self._send_json(500, {"error": str(e)})
                return
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def chunk(data: bytes):
                self.wfile.write(f"{len(data):X}\r\n".encode())
                self.wfile.write(data)
                self.wfile.write(b"\r\n")
                self.wfile.flush()

            # streaming WAV header: unknown length = 0xFFFFFFFF
            header = (
                b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + b"WAVE"
                + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sr,
                                        sr * 2, 2, 16)
                + b"data" + struct.pack("<I", 0xFFFFFFFF)
            )
            chunk(header)

            def pcm(w):
                w = np.clip(np.asarray(w, np.float32), -1.0, 1.0)
                return (w * 32767.0).astype("<i2").tobytes()

            try:
                if first is not None:
                    chunk(pcm(first))
                for w in gen:
                    chunk(pcm(w))
            except Exception as e:  # noqa: BLE001 — mid-stream failure
                # Do NOT send the terminal chunk: closing the connection
                # with the chunked body unterminated is the HTTP-level
                # truncation signal, so clients can tell half an
                # utterance from a complete response.
                self.close_connection = True
                # a client hanging up mid-stream (heard enough) is
                # routine, not a server failure — same premise as the
                # quiet-server disconnect handling; don't inflate
                # errors_total with every normal early hang-up
                # ConnectionError covers BrokenPipe/Reset/Aborted (the
                # Aborted flavor is what some platforms and proxies
                # raise); SSLEOFError is the TLS-wrapped equivalent
                hangup = isinstance(
                    e, (ConnectionError, ssl.SSLEOFError)
                )
                if not hangup:
                    print(f"[server] stream aborted: {e!r}", flush=True)
                server.stats.record_request(
                    time.monotonic() - t0, error=not hangup,
                    disconnect=hangup,
                )
            else:
                # record BEFORE the terminal chunk: once the client
                # parses it, the stream is observably complete and a
                # /stats probe must already count this request (the
                # handler thread can be descheduled between flush and a
                # later record — a real, observed race under load).
                # Latency here is the full stream duration; /stats also
                # carries these in requests_total so streaming-heavy
                # deployments don't read as idle.
                server.stats.record_request(
                    time.monotonic() - t0, error=False
                )
                self.wfile.write(b"0\r\n\r\n")
                self.wfile.flush()

    return Handler


if __name__ == "__main__":
    main()
