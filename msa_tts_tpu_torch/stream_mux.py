"""Continuous-batching stream multiplexer (counterpart of
``msa_tts_tpu/stream_mux.py``): N concurrent streams decoded in ONE
batched segment per tick.

Decoding every live stream in one launch multiplies streaming capacity
at roughly single-stream cadence: fixed device-resident slots, streams
join at segment boundaries and retire when their gate fires.  Two
engines:

- ``backend="cuda"`` (:class:`_CudaEngine`): all slots advance in one
  launch of the CUDA segment kernel (``cuda_decoder.
  cuda_decoder_segment``) per tick, with one weight set;
- ``backend="torch"`` (:class:`_TorchEngine`): each active slot runs the
  plain ``decoder_infer_segment`` at B = 1, under its own adapted
  weights when ``per_slot_params=True``.

``auto`` is ``cuda`` on CUDA tensors and ``torch`` on CPU tensors.  On
the card the plain engine runs only when ``torch`` is named, which
adapted voices (``per_slot_params=True``) need.

Exactness: a multiplexed stream gives what the same request gives
through :meth:`AdaptiveTTS.synthesize_stream` at ``text_pad_multiple =
t_cap``, whatever slot it lands in and whoever its neighbours are:

- slot rows are independent: the kernel sums every row in an order that
  depends on neither B nor the grid;
- each slot's prenet masks are that stream's own (S, 2, 1, P) draw,
  gathered at its own step;
- the per-stream host pipeline is the same ``_StreamCursor``.

Not carried over from the JAX package: the v5e ``profitable`` B <= 8
gate and ``fits_vmem`` (the CUDA wrapper checks its shared memory
against the 227 KB a block can use instead), and ``interpret``.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from .models.cuda_decoder import (
    check_supported,
    cuda_decoder_segment,
    segment_inputs,
)
from .models.decoder import decoder_infer_segment, decoder_stream_init
from .serving import (
    _stream_cursor,
    _stream_encode,
    _stream_masks,
    _segment_masks,
)
from .utils.backend import resolve_kernel_backend


class _Slot:
    __slots__ = ("active", "cursor", "out", "step")

    def __init__(self):
        self.active = False
        self.cursor = None
        self.out: queue.SimpleQueue | None = None
        self.step = 0          # decoder steps taken (host-side)


def _state_tensors(st: dict) -> list:
    """Every tensor of a ``decoder_stream_init`` state with a batch axis,
    in a fixed order."""
    c = st["carry"]
    return [st["decoder_input"], *c[:5], *c.attn_state,
            st["not_finished"], st["mel_lengths"]]


class _CudaEngine:
    """All slots advance in ONE launch of the CUDA segment kernel.

    The device holds, per slot: the encoder output, its attention
    projection and validity mask (zero for a slot never used, so its
    junk stays finite and, rows being independent, never reaches
    another row), the carried decoder state, the stream's prenet masks
    (with n_seg rows of ones past S) and its step."""

    def __init__(self, tts, dcfg, B: int, t_cap: int, n_seg: int):
        check_supported(dcfg)
        resolve_kernel_backend("cuda", tts.device)   # raises off the card
        self.dcfg, self.B, self.t_cap, self.n_seg = dcfg, B, t_cap, n_seg
        self.decoder = tts.model.decoder
        dev = tts.device
        E = dcfg.encoder_embedding_dim
        A = dcfg.attention_params["attention_dim"]
        S, P = dcfg.max_decoder_steps, dcfg.prenet_dim
        f32 = dict(dtype=torch.float32, device=dev)
        self.enc = torch.zeros(B, t_cap, E, **f32)
        self.pin = torch.zeros(B, t_cap, A, **f32)
        self.maskf = torch.zeros(B, t_cap, **f32)
        self.st = decoder_stream_init(dcfg, B, t_cap, device=dev)
        self.st["not_finished"].zero_()
        self.masks = torch.ones(B, S + n_seg, 2, P, **f32)
        self.steps = torch.zeros(B, dtype=torch.int64, device=dev)
        self._rows = torch.arange(B, device=dev)[:, None]
        self._offs = torch.arange(n_seg, device=dev)[None, :]

    def insert(self, idx: int, enc_row, in_len, masks_row, dec_model=None):
        """Admit a stream into slot ``idx``: a fresh decoder state, its
        encoder conditioning, its (S, 2, 1, P) masks, step 0."""
        if dec_model is not None:
            raise ValueError(
                "the CUDA engine shares one weight set; adapted voices "
                "need backend='torch' with per_slot_params=True"
            )
        pin_row, mask_row = segment_inputs(self.decoder, self.dcfg,
                                           enc_row, in_len)
        self.enc[idx] = enc_row[0]
        self.pin[idx] = pin_row[0]
        self.maskf[idx] = mask_row[0]
        st0 = decoder_stream_init(self.dcfg, 1, self.t_cap,
                                  device=self.enc.device)
        for a, b in zip(_state_tensors(self.st), _state_tensors(st0)):
            a[idx] = b[0]
        self.masks[idx, : self.dcfg.max_decoder_steps] = masks_row[:, :, 0]
        self.steps[idx] = 0

    def seg(self, active):
        """Advance every slot one segment; returns the device mels
        (B, n_mel, n_seg·r) and host not_finished / mel_lengths lists."""
        idx = (self.steps[:, None] + self._offs).clamp_max(
            self.masks.shape[1] - 1)
        pre = self.masks[self._rows, idx].permute(1, 2, 0, 3).contiguous()
        self.st, mels, _, _ = cuda_decoder_segment(
            self.decoder, self.dcfg, self.enc, self.pin, self.maskf, pre,
            self.st, self.n_seg,
        )
        self.steps += self.n_seg
        host = torch.cat([self.st["not_finished"],
                          self.st["mel_lengths"]]).tolist()
        return mels, host[: self.B], host[self.B:]


class _TorchEngine:
    """Each active slot runs ``decoder_infer_segment`` at B = 1 with its
    own state, masks and step; with ``per_slot_params`` under the
    decoder of the weights it was admitted with."""

    def __init__(self, tts, dcfg, B: int, t_cap: int, n_seg: int,
                 per_slot_params: bool = False):
        self.tts, self.dcfg, self.B = tts, dcfg, B
        self.t_cap, self.n_seg = t_cap, n_seg
        self.per_slot = bool(per_slot_params)
        self.rows: list[dict | None] = [None] * B

    def insert(self, idx: int, enc_row, in_len, masks_row, dec_model=None):
        if dec_model is not None and not self.per_slot:
            raise ValueError(
                "per-stream decoder params need per_slot_params=True"
            )
        model = dec_model if dec_model is not None else self.tts.model
        self.rows[idx] = dict(
            model=model, decoder=model.decoder, enc=enc_row, in_len=in_len,
            masks=masks_row, step=0,
            st=decoder_stream_init(self.dcfg, 1, self.t_cap,
                                   device=enc_row.device),
        )

    def seg(self, active):
        mels, flags = {}, []
        for i in active:
            row = self.rows[i]
            with self.tts._tp_scope(row["model"]):
                row["st"], m, _, _ = decoder_infer_segment(
                    row["decoder"], self.dcfg, row["enc"], row["in_len"],
                    _segment_masks(row["masks"], row["step"], self.n_seg),
                    row["st"], self.n_seg,
                )
            row["step"] += self.n_seg
            mels[i] = m[0]
            flags += [row["st"]["not_finished"], row["st"]["mel_lengths"]]
        host = torch.cat(flags).tolist() if flags else []
        nf, ml = [0] * self.B, [0] * self.B
        for k, i in enumerate(active):
            nf[i], ml[i] = host[2 * k], host[2 * k + 1]
        return mels, nf, ml


class MuxSaturated(RuntimeError):
    """All slots busy AND the pending queue is at ``max_pending``: the
    caller should shed load (the server falls back to the solo path)."""


class StreamMultiplexer:
    """Batch up to ``n_slots`` concurrent streams into one segment
    decode per tick.

    ``backend``: ``"cuda"`` (the segment kernel, one weight set),
    ``"torch"`` (the plain segment per slot) or ``"auto"`` (``cuda`` on
    CUDA tensors, ``torch`` on CPU tensors).  ``per_slot_params=True``
    serves adapted voices (``stream(..., voice=...)``), each slot under
    its own weights; it needs ``torch``, named on the card.

    ``max_pending`` bounds the admission queue: beyond it ``stream()``
    raises :class:`MuxSaturated`.  ``stream()`` is thread-safe; a
    background worker owns the device calls, under ``device_lock`` so
    that they interleave cleanly with a server's batched endpoint."""

    def __init__(self, tts, *, n_slots: int = 4, t_cap: int = 64,
                 segment_steps: int = 16, chunk_frames: int = 40,
                 vocode_ctx_frames: int = 16,
                 device_lock: threading.Lock | None = None,
                 backend: str = "auto",
                 per_slot_params: bool = False,
                 max_pending: int | None = None):
        cfg = tts.cfg
        dcfg = cfg.decoder_config()
        self.tts = tts
        self.cfg = cfg
        self.dcfg = dcfg
        self.B = int(n_slots)
        self.t_cap = int(t_cap)
        self.n_seg = int(segment_steps)
        self.chunk_frames = int(chunk_frames)
        self.vocode_ctx_frames = int(vocode_ctx_frames)
        self.per_slot_params = bool(per_slot_params)
        self.max_pending = None if max_pending is None else int(max_pending)
        self.lock = device_lock or threading.Lock()
        self._rejected_total = 0
        self._admitted_total = 0
        # completed counts every terminated stream (errored included, so
        # in-flight = admitted - completed - queue_depth always balances)
        self._completed_total = 0
        self._errored_total = 0
        self._ticks_total = 0

        backend = str(backend).lower()
        if backend not in ("cuda", "torch", "auto"):
            raise ValueError(f"unknown mux backend {backend!r}")
        on_card = tts.device.type == "cuda"
        if getattr(tts, "_tp_mesh", None) is not None:
            # tp serving decodes plainly with partitioned products: the
            # segment kernel takes one device's whole weights
            if backend == "cuda":
                raise NotImplementedError(
                    "the mux's cuda engine is single-device; a parallel: "
                    "{tp: M} model runs backend='torch'")
            backend = "torch"
        if self.per_slot_params and (backend == "cuda" or (
                backend == "auto" and on_card)):
            raise ValueError(
                "per_slot_params (adapted-voice mux) needs the plain "
                "engine: name backend='torch' (the CUDA engine shares "
                "one weight set)"
            )
        if backend == "auto":
            backend = "cuda" if on_card else "torch"
        if backend == "cuda":
            self.engine = _CudaEngine(tts, dcfg, self.B, self.t_cap,
                                      self.n_seg)
        else:
            self.engine = _TorchEngine(
                tts, dcfg, self.B, self.t_cap, self.n_seg,
                per_slot_params=self.per_slot_params,
            )
        self.backend = backend

        self._slots = [_Slot() for _ in range(self.B)]
        self._pending: list[tuple] = []
        self._cond = threading.Condition()
        self._stop = False
        self._worker = threading.Thread(
            target=self._loop, name="stream-mux", daemon=True
        )
        self._worker.start()

    # ---------------------------------------------------------- public
    def metrics(self) -> dict:
        """Backpressure and observability snapshot (served under
        /stats)."""
        with self._cond:
            return {
                "n_slots": self.B,
                "backend": self.backend,
                "per_slot_params": self.per_slot_params,
                "active_slots": sum(s.active for s in self._slots),
                "queue_depth": len(self._pending),
                "max_pending": self.max_pending,
                "admitted_total": self._admitted_total,
                "completed_total": self._completed_total,
                "errored_total": self._errored_total,
                "rejected_total": self._rejected_total,
                "ticks_total": self._ticks_total,
            }

    def stream(self, text: str, *, spk_emb=None, voice=None,
               vocoder: str = "griffinlim", seed: int = 0,
               pre_masks=None, gl_phase=None):
        """Iterator of host float32 wav chunks: the multiplexed
        equivalent of :meth:`AdaptiveTTS.synthesize_stream` (``seed``,
        ``pre_masks`` and ``gl_phase`` as there).

        ``voice`` streams under that voice's adapted weights (needs
        ``per_slot_params=True``).  Validation is eager (this is a plain
        function returning an iterator): a text longer than ``t_cap``
        raises ValueError and a full queue raises MuxSaturated here,
        before any slot is taken.  Once this returns, the stream decodes
        to its end whether or not the iterator is drained."""
        tts = self.tts
        if voice is not None and not self.per_slot_params:
            raise ValueError(
                "adapted voices need a per_slot_params=True multiplexer "
                "(per-slot decoder weights); this mux shares one "
                "parameter set"
            )
        seq = tts._phonemes(text)
        if len(seq) > self.t_cap:
            raise ValueError(
                f"text phonemizes to {len(seq)} symbols > mux t_cap "
                f"{self.t_cap}"
            )
        # shed load BEFORE paying the per-stream encode; capacity is the
        # free slots plus the allowed queue (advisory under races)
        if self.max_pending is not None:
            with self._cond:
                free = sum(not s.active for s in self._slots)
                if len(self._pending) >= self.max_pending + free:
                    self._rejected_total += 1
                    raise MuxSaturated(
                        f"{self.B - free}/{self.B} slots busy and "
                        f"{len(self._pending)} streams already queued "
                        f"(max_pending={self.max_pending})"
                    )
        model = tts._voice_model(voice)
        emb = voice.spk_emb if voice is not None else spk_emb
        # encode outside the worker tick: per-stream work, the same call
        # the solo path makes
        with self.lock, torch.no_grad():
            enc_row, in_len = _stream_encode(tts, model, seq, self.t_cap,
                                             emb)
            masks = _stream_masks(tts, seed, pre_masks)
        cursor = _stream_cursor(
            tts, model, vocoder, seed, gl_phase, self.n_seg,
            self.chunk_frames, self.vocode_ctx_frames,
        )
        dec_model = model if self.per_slot_params else None
        out: queue.SimpleQueue = queue.SimpleQueue()
        with self._cond:
            self._pending.append(
                (enc_row, in_len, masks, cursor, out, dec_model)
            )
            self._admitted_total += 1
            self._cond.notify()

        def drain():
            while True:
                item = out.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item

        return drain()

    def close(self):
        with self._cond:
            self._stop = True
            self._cond.notify()
        self._worker.join(timeout=10)

    # ---------------------------------------------------------- worker
    def _admit(self):
        """Move pending streams into free slots."""
        for i, slot in enumerate(self._slots):
            with self._cond:
                if not self._pending:
                    break
                if slot.active:
                    continue
                (enc_row, in_len, masks, cursor, out,
                 dec_model) = self._pending.pop(0)
                # reserve the slot before the insert, so the stream stays
                # visible to the admission bound
                slot.active = True
            try:
                with self.lock:
                    self.engine.insert(i, enc_row, in_len, masks,
                                       dec_model=dec_model)
            except Exception as e:  # deliver to THIS stream only
                with self._cond:
                    self._errored_total += 1
                    self._completed_total += 1
                slot.active = False
                out.put(e)
                out.put(None)
                continue
            slot.cursor = cursor
            slot.out = out
            slot.step = 0

    @torch.no_grad()
    def _loop(self):
        while True:
            with self._cond:
                while (not self._stop and not self._pending
                       and not any(s.active for s in self._slots)):
                    self._cond.wait()
                if self._stop:
                    for s in self._slots:
                        if s.active and s.out is not None:
                            s.out.put(None)
                    # queued, never admitted streams get a terminal too
                    for p in self._pending:
                        p[4].put(None)
                    self._pending.clear()
                    return
            try:
                self._admit()
                active = [i for i, s in enumerate(self._slots) if s.active]
                with self.lock:
                    mels, nf_h, ml_h = self.engine.seg(active)
                with self._cond:
                    self._ticks_total += 1
            except Exception as e:  # surface to every waiting client
                for s in self._slots:
                    if s.active and s.out is not None:
                        out = s.out
                        with self._cond:
                            self._errored_total += 1
                            self._completed_total += 1
                        s.active = False
                        s.cursor = None
                        s.out = None
                        out.put(e)
                        out.put(None)
                continue
            # the slots' host pipelines run one after another on this
            # thread: they are bound by the host's launch rate, and
            # threads would only contend for the GIL (a pool of one
            # thread per slot measured slower on the H100, PERF.md)
            for i in active:
                slot = self._slots[i]
                slot.step += self.n_seg
                self._advance_slot(slot, mels[i], int(ml_h[i]),
                                   int(nf_h[i]) == 0)

    def _advance_slot(self, slot, raw, ml, finished):
        """One slot's host pipeline for this tick (postnet window →
        vocoder → chunks)."""
        try:
            chunks, final = slot.cursor.advance(
                raw, ml=ml, finished=finished, n_steps=slot.step,
            )
            for c in chunks:
                slot.out.put(np.asarray(c, np.float32))
        except Exception as e:
            with self._cond:
                self._errored_total += 1
            slot.out.put(e)
            final = True
        if final:
            # count completion before the terminal chunk is observable
            with self._cond:
                self._completed_total += 1
            out = slot.out
            slot.active = False
            slot.cursor = None
            slot.out = None
            out.put(None)
