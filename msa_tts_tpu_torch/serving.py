"""Few-shot TTS serving API, synthesis and streaming paths (counterpart
of ``msa_tts_tpu/serving.py``).

    tts = AdaptiveTTS.from_experiment("output/maml/vctk_maml",
                                      checkpoint_id="0", device="cuda")
    wav = tts.synthesize("Hello there.", spk_emb=dvec)
    for chunk in tts.synthesize_stream("Hello there.", spk_emb=dvec):
        ...

Text → phonemes (``utils/g2p``) → Tacotron-2 with the decoder loop as
the CUDA kernel on a GPU (its plain PyTorch version on the CPU) →
Griffin-Lim, or a neural vocoder registered with ``attach_vocoder``:
WaveRNN (its sample loop as one CUDA kernel launch for all of a batch's
folds on a GPU) or HiFi-GAN.  ``synthesize_stream`` runs the decoder in
segments (the CUDA segment kernel on a GPU) through a delayed-exact
postnet and a chunked vocoder.  Each request draws its prenet dropout
masks, its Griffin-Lim starting phase and its WaveRNN sampling noise
from a ``torch.Generator`` seeded by the request's ``seed``; the parity
tests inject them instead.  The mel stays on the device from the decoder
to the vocoder.

``infer_dtype: bfloat16`` casts the model (parameters, batch-norm
state) and the speaker vector to bfloat16, as the JAX package's
``_cast_infer`` does: the encoder and the postnet run in bfloat16, the
decoder with bfloat16 products on float32 state (on a GPU the kernels'
bfloat16 weight path), and mels come back in float32.  ``auto`` is
float32 here (the JAX package's ``auto`` routes by a batch gate measured
on its own hardware, which is not carried over).  Solo, streamed and
multiplexed decoding use the same type.

Not in this version (each raises ``NotImplementedError``): speaker
adaptation (``adapt``), ``.ckpt`` (flax msgpack) checkpoints and
``parallel`` dp/tp serving.
"""

from __future__ import annotations

import os
import weakref
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from .utils.g2p import N_SYMBOLS, Grapheme2Phoneme

from .models.cuda_decoder import (
    check_supported,
    cuda_decoder_segment,
    prenet_masks,
    segment_inputs,
)
from .models.decoder import decoder_infer_segment, decoder_stream_init
from .models.tacotron2nv import (
    Tacotron2NV,
    _encode,
    config_from_params,
    postnet_residual,
    tacotron2nv_infer,
)
from .ops.audio import griffinlim_logmelspec
from .utils.backend import load_device, resolve_kernel_backend


@dataclass(eq=False)
class Voice:
    """An adapted speaker: the model's ``state_dict`` and its d-vector.
    Identity-keyed, so that :class:`AdaptiveTTS` loads each voice onto
    the device once."""

    state_dict: dict
    spk_emb: np.ndarray


class AdaptiveTTS:
    def __init__(self, params: dict, model: Tacotron2NV, *, device=None):
        self.params = params
        mp = dict(params["model"])
        mp.setdefault("n_mel_channels", params["audio_params"]["n_mels"])
        mp.setdefault("n_symbols", N_SYMBOLS)
        mp.setdefault("num_speakers", 1)
        # Serving pads and co-batches requests: attention-energy masking
        # (with mask_pad below) keeps a request's mel independent of its
        # batch.  An explicit attention_params.mask_energies still wins.
        ap = dict(mp.get("attention_params") or {})
        ap.setdefault("mask_energies", True)
        mp["attention_params"] = ap
        self.cfg = config_from_params(mp)

        idt = params.get("infer_dtype", "auto")
        if idt not in (None, "auto", "float32", "fp32", "bfloat16", "bf16"):
            raise ValueError(
                f"unknown infer_dtype {idt!r}: expected 'auto', "
                "'float32' or 'bfloat16'"
            )
        self.infer_dtype = (torch.bfloat16 if idt in ("bfloat16", "bf16")
                            else torch.float32)
        pcfg = params.get("parallel") or {}
        if int(pcfg.get("dp", 1)) > 1 or int(pcfg.get("tp", 1)) > 1:
            raise NotImplementedError(
                "parallel dp/tp serving is not ported yet"
            )

        self.device = torch.device(
            device if device is not None
            else next(model.parameters()).device
        )
        # the model itself is cast (in place, as it is moved): no second
        # copy of the weights stays behind
        self.model = model.to(self.device, self.infer_dtype).eval()
        self.decode_backend = params.get("decode_backend") or "auto"
        # raises now, not at the first request, for `cuda` on a CPU or a
        # config the kernel does not lower on a GPU
        if resolve_kernel_backend(self.decode_backend, self.device) == "cuda":
            check_supported(self.cfg.decoder_config())
        self.g2p = Grapheme2Phoneme()
        self._vocoders: dict = {}
        self._voice_cache: weakref.WeakKeyDictionary = (
            weakref.WeakKeyDictionary()
        )

    # ------------------------------------------------------------- load
    @classmethod
    def from_experiment(cls, experiment_path: str, checkpoint_id: str = "0",
                        *, device="cuda", **overrides):
        """Load ``params.yml`` and ``checkpoints/checkpoint_{id}.pt`` (the
        reference ``state_dict`` layout) from an experiment directory onto
        ``device``: the GPU unless ``device="cpu"`` is asked for (without
        a CUDA device the default raises)."""
        from .config import load_params

        device = load_device(device)
        params = load_params(os.path.join(experiment_path, "params.yml"))
        params.update(overrides)
        mp = dict(params["model"])
        mp["n_mel_channels"] = params["audio_params"]["n_mels"]
        mp["n_symbols"] = N_SYMBOLS
        mp["num_speakers"] = 1
        params["model"] = mp
        model = Tacotron2NV(config_from_params(mp))
        ckpt = os.path.join(
            experiment_path, "checkpoints", f"checkpoint_{checkpoint_id}"
        )
        if os.path.exists(ckpt + ".ckpt"):
            raise NotImplementedError(
                f"{ckpt}.ckpt is a flax msgpack checkpoint; the port reads "
                "only the reference .pt state_dict layout"
            )
        if not os.path.exists(ckpt + ".pt"):
            raise FileNotFoundError(ckpt + ".{ckpt,pt}")
        sd = torch.load(ckpt + ".pt", map_location="cpu", weights_only=True)
        model.load_state_dict(sd, strict=True)
        return cls(params, model, device=device)

    def adapt(self, *args, **kwargs):
        raise NotImplementedError(
            "speaker adaptation is not ported yet (it needs the training "
            "path: loss, optimizer, inner loop)"
        )

    def _voice_model(self, voice: Voice | None) -> Tacotron2NV:
        """The model holding ``voice``'s weights (the base model when
        None), loaded onto the device once per Voice."""
        if voice is None:
            return self.model
        model = self._voice_cache.get(voice)
        if model is None:
            model = Tacotron2NV(self.model.cfg)
            model.load_state_dict(voice.state_dict, strict=True)
            model = model.to(self.device, self.infer_dtype).eval()
            self._voice_cache[voice] = model
        return model

    # -------------------------------------------------------- synthesize
    def _phonemes(self, text: str) -> list[int]:
        return self.g2p.convert(
            text, convert_mode="text_to_phone_to_idx",
            language=self.params.get("language", "en-us"),
        )[0]

    def _decode(self, model, inputs: np.ndarray, in_len: np.ndarray,
                emb: np.ndarray, generator: torch.Generator, pre_masks):
        """(B, T) phoneme ids → mels (B, n_mel, S·r) on the device and
        host mel_lengths (B,) in decoder steps."""
        dev = self.device
        if pre_masks is None:
            dcfg = self.cfg.decoder_config()
            pre_masks = prenet_masks(dcfg, dcfg.max_decoder_steps,
                                     inputs.shape[0], generator, device=dev)
        mel, mel_len, _ = tacotron2nv_infer(
            model, self.cfg,
            torch.as_tensor(inputs, dtype=torch.int64, device=dev),
            torch.as_tensor(in_len, dtype=torch.int64, device=dev),
            torch.as_tensor(emb, dtype=torch.float32, device=dev),
            torch.as_tensor(pre_masks, dtype=torch.float32, device=dev),
            mask_pad=True, decode_backend=self.decode_backend,
        )
        return mel, mel_len.cpu().numpy()

    def synthesize(self, text: str, voice: Voice | None = None, *,
                   vocoder: str = "griffinlim", seed: int = 0,
                   spk_emb: np.ndarray | None = None, pre_masks=None,
                   gl_phase=None, voc_noise=None) -> np.ndarray:
        """Text → waveform as the adapted speaker (or the base model with
        an explicit ``spk_emb``).  ``pre_masks`` (S, 2, 1, P), ``gl_phase``
        and ``voc_noise`` (WaveRNN: a list with the utterance's
        ``(noise1, noise2)`` pair) inject the noise a request would
        otherwise draw from a generator seeded with ``seed``."""
        emb = voice.spk_emb if voice else np.asarray(spk_emb, np.float32)
        seq = self._phonemes(text)
        g = torch.Generator().manual_seed(seed)
        mel, mel_len = self._decode(
            self._voice_model(voice), np.asarray(seq, np.int64)[None],
            np.asarray([len(seq)]), np.asarray(emb, np.float32)[None], g,
            pre_masks,
        )
        n = max(int(mel_len[0]), 1) * self.cfg.n_frames_per_step
        return self._vocode([mel[0, :, :n]], vocoder, g, gl_phase,
                            voc_noise)[0]

    def synthesize_batch(
        self, texts: Sequence[str], voice: Voice | None = None, *,
        vocoder: str = "griffinlim", seed: int = 0,
        spk_emb: np.ndarray | None = None, text_pad_multiple: int = 1,
        pad_batch_to: int | None = None, pre_masks=None, gl_phase=None,
        voc_noise=None,
    ) -> list[np.ndarray]:
        """Batched text → waveforms: one decode over all texts.

        ``text_pad_multiple`` / ``pad_batch_to`` quantize the padded
        (B, T) shape; filler rows replicate row 0 and are dropped from
        the result.  ``pre_masks`` (S, 2, Bp, P), ``gl_phase`` and
        ``voc_noise`` (WaveRNN: one ``(noise1, noise2)`` pair per text)
        inject the request's noise."""
        emb = voice.spk_emb if voice else np.asarray(spk_emb, np.float32)
        seqs = [self._phonemes(t) for t in texts]
        B = len(seqs)
        Bp = max(B, pad_batch_to or B)
        m = max(int(text_pad_multiple), 1)
        T = -(-max(len(s) for s in seqs) // m) * m
        inputs = np.zeros((Bp, T), np.int64)
        in_len = np.empty((Bp,), np.int64)
        for i, s in enumerate(seqs):
            inputs[i, : len(s)] = s
            in_len[i] = len(s)
        inputs[B:], in_len[B:] = inputs[0], in_len[0]   # filler rows
        g = torch.Generator().manual_seed(seed)
        mel, mel_len = self._decode(
            self._voice_model(voice), inputs, in_len,
            np.tile(np.asarray(emb, np.float32)[None], (Bp, 1)), g,
            pre_masks,
        )
        r = self.cfg.n_frames_per_step
        mels = [mel[i, :, : max(int(mel_len[i]), 1) * r] for i in range(B)]
        return self._vocode(mels, vocoder, g, gl_phase, voc_noise)

    # ------------------------------------------------------------ vocoders
    def attach_vocoder(self, name: str, vocoder) -> None:
        """Register a neural vocoder: ``name`` in {"wavernn", "hifigan"},
        ``vocoder`` a ``vocoders.wavernn.WaveRNN`` or
        ``vocoders.hifigan.HiFiGAN``.  It is moved to this model's
        device, so the mel never leaves it."""
        if name not in ("wavernn", "hifigan"):
            raise ValueError(f"unknown vocoder name: {name}")
        self._vocoders[name] = vocoder.to(self.device)

    def _attached(self, name: str):
        voc = self._vocoders.get(name)
        if voc is None:
            cls = "WaveRNN" if name == "wavernn" else "HiFiGAN"
            raise ValueError(f"attach_vocoder({name!r}, {cls}(...)) first")
        return voc

    def _vocode(self, mels: list[torch.Tensor], vocoder: str,
                generator: torch.Generator, init_phase=None,
                voc_noise=None):
        """Device mels (n_mel, T_i) → host waveforms (or host mels for
        ``vocoder="none"``)."""
        if vocoder == "none":
            return [m.cpu().numpy() for m in mels]
        if vocoder == "wavernn":
            # one sample loop over every fold of every mel
            return self._attached("wavernn").generate_batch(
                mels, generator=generator, noises=voc_noise, verbose=False)
        if vocoder == "hifigan":
            voc = self._attached("hifigan")
            wavs = (voc.inference_batch(mels) if len(mels) > 1
                    else [voc.inference(m) for m in mels])
            return [w.cpu().numpy() for w in wavs]
        if vocoder != "griffinlim":
            raise ValueError(f"unknown vocoder: {vocoder}")
        ap = self.params["audio_params"]
        phase = (None if init_phase is None else
                 torch.as_tensor(init_phase, dtype=torch.float32,
                                 device=self.device))
        if len(mels) == 1:
            wav = griffinlim_logmelspec(
                mels[0], ap, init_phase=phase, generator=generator,
            )
            return [wav.cpu().numpy()]
        # one batched inversion: pad every mel with its own silence floor
        # to a common frame count (a multiple of 32, as the JAX package
        # does), then cut each wav to hop·(T−1) samples — the length the
        # single-mel path produces
        t_max = -(-max(m.shape[1] for m in mels) // 32) * 32
        batch = torch.stack([
            torch.cat([m, m.min().expand(m.shape[0], t_max - m.shape[1])],
                      dim=1)
            for m in mels
        ])
        wavs = griffinlim_logmelspec(
            batch, ap, init_phase=phase, generator=generator,
        ).cpu().numpy()
        hop = ap["hop_length"]
        return [wavs[i][: (m.shape[1] - 1) * hop]
                for i, m in enumerate(mels)]


# ---------------------------------------------------------------------------
# Streaming synthesis
# ---------------------------------------------------------------------------

def _cat(*xs):
    """Concatenate the non-empty (n_mel, t) tensors along time, or None."""
    xs = [x for x in xs if x is not None and x.shape[-1]]
    return torch.cat(xs, dim=-1) if xs else None


class _StreamingPostnet:
    """Delayed-exact streaming postnet.

    The postnet is a stack of same-padded time convolutions with a
    receptive field of ``ctx = n_convs · (kernel // 2)`` frames per
    side.  Emitting a frame only once ``ctx`` future frames exist, and
    carrying ``ctx`` past frames as left context, reproduces the offline
    postnet at the cost of ``ctx`` frames of delay.  Every window is
    zero-padded to ``pad_to`` columns and run with the true width masked
    (``postnet_apply(width=...)``), so all windows, the final one
    included, run at one shape.  Frames stay on the device."""

    def __init__(self, apply_fn, ctx: int, pad_to: int = 0):
        # apply_fn: ((B, n_mel, W), true width) -> (B, n_mel, W)
        self.apply = apply_fn
        self.ctx = int(ctx)
        self.pad_to = int(pad_to)
        self.left: torch.Tensor | None = None    # (n_mel, <= ctx) raw
        self.pending: torch.Tensor | None = None

    def push(self, raw: torch.Tensor, final: bool = False) -> torch.Tensor:
        """Feed raw mel frames (n_mel, t); returns the postnet frames
        that became exact (possibly none)."""
        self.pending = _cat(self.pending, raw)
        if self.pending is None:
            return raw[:, :0]
        n_pend = self.pending.shape[-1]
        m = n_pend if final else n_pend - self.ctx
        if m <= 0:
            return raw[:, :0]
        n_left = 0 if self.left is None else self.left.shape[-1]
        window = _cat(self.left, self.pending)
        w = window.shape[-1]
        if self.pad_to > w:
            window = torch.nn.functional.pad(window, (0, self.pad_to - w))
        out = self.apply(window[None], w)[0]
        emitted = out[:, n_left: n_left + m]
        keep = _cat(self.left, self.pending[:, :m])
        self.left = keep[:, -self.ctx:] if self.ctx else keep[:, :0]
        self.pending = self.pending[:, m:]
        return emitted


class _StreamingVocoder:
    """Chunked vocoding with ±ctx frames of context, trimmed from the
    output.  How close the chunks come to the offline waveform depends on
    the vocoder: HiFi-GAN (feed-forward convolutions) reproduces it
    wherever its receptive field fits inside the context; Griffin-Lim
    estimates the phase per window; WaveRNN is autoregressive per sample,
    so each window is a generation of its own from zero state."""

    def __init__(self, vocode_fn, hop: int, chunk: int, ctx: int,
                 tail_frames: int = 0):
        # (n_mel, W) device -> (n,) device tensor or host array
        self.vocode = vocode_fn
        self.hop, self.chunk, self.ctx = int(hop), int(chunk), int(ctx)
        # frames the vocoder comes up short per window (Griffin-Lim
        # returns (W-1)·hop samples for W frames): a padded final window
        # trims them explicitly so the streamed total is the offline one
        self.tail_frames = int(tail_frames)
        self.buf: torch.Tensor | None = None   # all emitted mel frames
        self.done = 0                          # frames already vocoded

    def push(self, mel: torch.Tensor | None, final: bool = False):
        """Feed exact mel frames; yields host float32 wav chunks."""
        self.buf = _cat(self.buf, mel)
        if self.buf is None:
            return
        T = self.buf.shape[-1]
        # every window is vocoded at ONE width chunk + 2·ctx, grown
        # toward whatever real frames exist; only an utterance shorter
        # than the window pads, with its own silence floor
        W = self.chunk + 2 * self.ctx
        while True:
            e = self.done + self.chunk
            if e + self.ctx > T:       # need future context (or final)
                if not (final and self.done < T):
                    break
                e = T
            s = self.done
            a = max(0, min(s - self.ctx, T - W))
            b = min(T, a + W)
            win = self.buf[:, a:b]
            padded = b - a < W
            if padded:
                win = torch.cat(
                    [win, win.min().expand(win.shape[0], W - (b - a))],
                    dim=1,
                )
            wav = self.vocode(win)
            if padded:
                wav = wav[: (b - a - self.tail_frames) * self.hop]
            o = (s - a) * self.hop
            n = (e - s) * self.hop
            chunk = wav[o: o + n]
            self.done = e
            if len(chunk):
                if isinstance(chunk, torch.Tensor):
                    chunk = chunk.cpu().numpy()
                yield chunk.astype(np.float32, copy=False)
            if e >= T:
                break


class _MelRelay:
    """``vocoder="none"``: the exact mel frames themselves, to the host."""

    @staticmethod
    def push(mel, final=False):
        if mel is not None and mel.shape[-1]:
            yield mel.cpu().numpy()


def _postnet_ctx(cfg) -> int:
    return cfg.postnet_n_convolutions * (cfg.postnet_kernel_size // 2)


def _stream_cursor(tts, model, vocoder: str, seed: int, gl_phase,
                   segment_steps: int, chunk_frames: int,
                   vocode_ctx_frames: int, voc_noise=None):
    """One stream's host-side stage stack (postnet → vocoder →
    :class:`_StreamCursor`), shared by :meth:`AdaptiveTTS.
    synthesize_stream` and the multiplexer so both run identical
    per-stream pipelines.

    ``gl_phase``: Griffin-Lim's starting phase for every window — a
    tensor, or a callable ``(n_freqs, n_frames) -> phase``; None draws
    U(-π, π) from a generator seeded with ``seed`` (the same phase for
    every window of a shape, as the JAX package uses one key).
    ``voc_noise``: WaveRNN's ``[(noise1, noise2)]`` for every window;
    None draws it per window from a generator seeded with ``seed``."""
    cfg = tts.cfg
    r = cfg.n_frames_per_step
    ap = tts.params["audio_params"]
    pctx = _postnet_ctx(cfg)

    def post_fn(x, width):
        return x + postnet_residual(model.postnet, x, width=width)

    # windows are padded to the widest a segment stream can produce (left
    # ctx + held-back ctx + a segment's raw frames + final zeros <= 3·ctx)
    post = _StreamingPostnet(post_fn, pctx,
                             pad_to=segment_steps * r + 3 * pctx)
    if vocoder == "none":
        return _StreamCursor(cfg, r, post, _MelRelay)
    if vocoder not in ("griffinlim", "wavernn", "hifigan"):
        raise ValueError(f"unknown vocoder: {vocoder}")
    if vocoder != "hifigan" and vocode_ctx_frames < 1:
        # Griffin-Lim and WaveRNN both come up one hop short per window
        # ((W-1)·hop samples for W frames): with zero context every
        # non-final chunk would silently lose a hop
        raise ValueError(
            f"vocoder={vocoder!r} needs vocode_ctx_frames >= 1")
    if vocoder != "griffinlim":
        tts._attached(vocoder)          # raises now, not at the first chunk

        def vocode_neural(mel):
            # every window restarts from the stream's seed, as the JAX
            # package hands every window the same key
            g = torch.Generator().manual_seed(seed)
            return tts._vocode([mel], vocoder, g, voc_noise=voc_noise)[0]

        # HiFi-GAN emits exactly W·hop samples, the other two (W-1)·hop
        voc = _StreamingVocoder(
            vocode_neural, ap["hop_length"], chunk_frames,
            vocode_ctx_frames, tail_frames=0 if vocoder == "hifigan" else 1)
        return _StreamCursor(cfg, r, post, voc)

    n_freqs = ap["n_fft"] // 2 + 1
    min_frames = ap["n_fft"] // ap["hop_length"] + 1
    phases: dict = {}

    def phase_for(n_frames: int) -> torch.Tensor:
        if n_frames not in phases:
            if callable(gl_phase):
                ph = gl_phase(n_freqs, n_frames)
            elif gl_phase is not None:
                ph = gl_phase
            else:
                g = torch.Generator().manual_seed(seed)
                ph = torch.rand((n_freqs, n_frames), generator=g)
                ph = ph * (2.0 * np.pi) - np.pi
            phases[n_frames] = torch.as_tensor(
                ph, dtype=torch.float32, device=tts.device)
        return phases[n_frames]

    def vocode(mel):
        phase = phase_for(max(mel.shape[-1], min_frames))
        return griffinlim_logmelspec(mel, ap, init_phase=phase)

    voc = _StreamingVocoder(vocode, ap["hop_length"], chunk_frames,
                            vocode_ctx_frames, tail_frames=1)
    return _StreamCursor(cfg, r, post, voc)


class _StreamCursor:
    """Per-stream segment bookkeeping: raw decoder frames → (postnet-
    exact, offline-trimmed, vocoded) chunks.  Shared by
    :meth:`AdaptiveTTS.synthesize_stream` (one stream) and
    :class:`msa_tts_tpu_torch.stream_mux.StreamMultiplexer` (one cursor
    per slot), so what frames the postnet sees, where the output is
    trimmed and when the stream ends cannot differ between the two."""

    def __init__(self, cfg, r: int, post: _StreamingPostnet, voc):
        self.cfg = cfg
        self.r = int(r)
        self.post = post
        self.voc = voc
        self.produced = 0   # raw frames fed to the postnet
        self.emitted = 0    # exact frames forwarded to the vocoder

    def advance(self, raw: torch.Tensor, ml: int, finished: bool,
                n_steps: int):
        """Consume one segment's raw frames; returns
        ``(chunk_iterator, final)``.

        ``raw``: (n_mel, seg·r) this segment's decoder output on the
        device; ``ml``: the stream's mel_lengths counter; ``finished``:
        the gate has fired; ``n_steps``: total decoder steps taken."""
        cfg, r, post, voc = self.cfg, self.r, self.post, self.voc
        at_cap = n_steps >= cfg.max_decoder_steps
        # Segments decode in fixed strides, so the last one can overshoot
        # max_decoder_steps by up to seg-1 steps the offline loop never
        # runs: drop those frames and their mel_lengths increments (+1
        # per step, so min() reproduces the offline count exactly)
        cap_frames = cfg.max_decoder_steps * r
        if self.produced + raw.shape[-1] > cap_frames:
            raw = raw[:, : max(0, cap_frames - self.produced)]
        L = min(max(ml, 1) * r, cap_frames)
        if finished:
            # offline trims its output to mel_lengths·r frames whatever
            # early_stopping says, and the postnet must see the raw
            # context offline saw beyond L:
            #   early_stopping=True: the offline loop exits once every
            #     gate fired, so its buffer holds mel_lengths+1 real steps
            #     (the firing step still writes its frame) and zeros
            #     beyond; feed exactly those real frames, then explicit
            #     zeros out to L+ctx (conv zero-padding is not the same
            #     as zero input frames past the first conv layer);
            #   early_stopping=False: offline decodes to the step cap, so
            #     frames past L are real context: keep decoding until
            #     every vocoded frame (< L) has its true receptive field.
            if cfg.early_stopping:
                need = min(ml + 1, cfg.max_decoder_steps) * r
            else:
                need = min(L + post.ctx, cap_frames)
            final = at_cap or (self.produced + raw.shape[-1] >= need)
            if final:
                raw = raw[:, : max(0, need - self.produced)]
                n_zero = min(L + post.ctx, cap_frames) - need
                if n_zero > 0:
                    raw = torch.cat(
                        [raw, raw.new_zeros(raw.shape[0], n_zero)], dim=-1
                    )
        else:
            final = at_cap
        self.produced += raw.shape[-1]
        exact = post.push(raw, final=final)
        # the vocoder sees at most L frames in all: while unfinished
        # L == produced, and once the gate fires L freezes (the offline
        # trim), so post-gate frames never reach the client
        take = max(0, min(exact.shape[-1], L - self.emitted))
        self.emitted += take
        return voc.push(exact[:, :take], final=final), final


def _segment_masks(masks: torch.Tensor, step: int, n: int) -> torch.Tensor:
    """Steps [step, step + n) of a stream's (S, 2, B, P) prenet masks;
    steps at or past S (their frames are dropped) get ones."""
    seg = masks[step: step + n]
    if seg.shape[0] < n:
        seg = torch.cat([seg, seg.new_ones((n - seg.shape[0],)
                                           + tuple(masks.shape[1:]))])
    return seg.contiguous()


def _stream_encode(tts, model, seq, t_pad: int, emb):
    """One stream's conditioned encoder output (1, t_pad, E) on the
    device and its length (1,), with padding masked (``mask_pad``), as
    the offline path encodes."""
    dev = tts.device
    padded = np.zeros((1, t_pad), np.int64)
    padded[0, : len(seq)] = seq
    in_len = torch.tensor([len(seq)], dtype=torch.int64, device=dev)
    enc = _encode(
        model, tts.cfg, torch.as_tensor(padded, device=dev), in_len,
        torch.as_tensor(np.asarray(emb, np.float32)[None], device=dev),
        mask_pad=True,
    )
    return enc.contiguous(), in_len


def _stream_masks(tts, seed: int, pre_masks) -> torch.Tensor:
    """A stream's (S, 2, 1, P) prenet masks on the device: injected, or
    the draw :meth:`AdaptiveTTS.synthesize` makes for the same seed."""
    if pre_masks is not None:
        return torch.as_tensor(pre_masks, dtype=torch.float32,
                               device=tts.device)
    dcfg = tts.cfg.decoder_config()
    return prenet_masks(dcfg, dcfg.max_decoder_steps, 1,
                        torch.Generator().manual_seed(seed),
                        device=tts.device)


@torch.no_grad()
def synthesize_stream(self, text: str, voice: Voice | None = None, *,
                      vocoder: str = "griffinlim",
                      spk_emb: np.ndarray | None = None, seed: int = 0,
                      segment_steps: int = 16, chunk_frames: int = 40,
                      vocode_ctx_frames: int = 16,
                      text_pad_multiple: int = 1, pre_masks=None,
                      gl_phase=None, voc_noise=None):
    """Generator: text → wav chunks (host float32), the first long before
    the last.

    One encode → the decoder in ``segment_steps``-step segments (the
    CUDA segment kernel on a GPU, its plain version on the CPU; chained
    segments reproduce the offline decode) → delayed-exact streaming
    postnet → chunked vocoder (Griffin-Lim, or an attached WaveRNN or
    HiFi-GAN).  The mel path is :meth:`synthesize`'s:
    ``vocoder="none"`` streams the offline mel in pieces.

    Noise: the prenet masks are the (S, 2, 1, P) draw :meth:`synthesize`
    makes for ``seed`` (or ``pre_masks``), sliced per segment.
    ``gl_phase`` (a tensor, or a callable ``(n_freqs, n_frames) ->
    phase``) is every window's Griffin-Lim start phase; ``voc_noise``
    (``[(noise1, noise2)]``) every window's WaveRNN sampling noise.

    Mels and windows stay on the device; each segment brings its step,
    not_finished and mel_lengths to the host in one transfer, and each
    chunk its samples.  ``text_pad_multiple`` pads the phoneme sequence
    (masked, so the math does not change)."""
    cfg = self.cfg
    dcfg = cfg.decoder_config()
    r = cfg.n_frames_per_step
    model = self._voice_model(voice)
    emb = voice.spk_emb if voice else np.asarray(spk_emb, np.float32)
    seq = self._phonemes(text)
    m = max(int(text_pad_multiple), 1)
    enc, in_len = _stream_encode(self, model, seq,
                                 -(-len(seq) // m) * m, emb)
    masks = _stream_masks(self, seed, pre_masks)
    n = int(segment_steps)
    if resolve_kernel_backend(self.decode_backend, self.device) == "cuda":
        check_supported(dcfg)
        pin, maskf = segment_inputs(model.decoder, dcfg, enc, in_len)

        def seg(st, pm):
            return cuda_decoder_segment(model.decoder, dcfg, enc, pin,
                                        maskf, pm, st, n)
    else:
        def seg(st, pm):
            return decoder_infer_segment(model.decoder, dcfg, enc, in_len,
                                         pm, st, n)

    cursor = _stream_cursor(self, model, vocoder, seed, gl_phase, n,
                            chunk_frames, vocode_ctx_frames, voc_noise)
    st = decoder_stream_init(dcfg, 1, enc.shape[1], device=self.device)
    step = 0
    while True:
        st, mels, _, _ = seg(st, _segment_masks(masks, step, n))
        # one device-to-host transfer per segment
        step, nf, ml = torch.cat([st["step"].reshape(1).to(torch.int32),
                                  st["not_finished"],
                                  st["mel_lengths"]]).tolist()
        chunks, final = cursor.advance(mels[0], ml=ml, finished=nf == 0,
                                       n_steps=step)
        yield from chunks
        if final:
            break


AdaptiveTTS.synthesize_stream = synthesize_stream
