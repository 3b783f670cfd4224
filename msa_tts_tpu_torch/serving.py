"""Few-shot TTS serving API: speaker adaptation, synthesis and streaming
(counterpart of ``msa_tts_tpu/serving.py``).

    tts = AdaptiveTTS.from_experiment("output/maml/vctk_maml",
                                      checkpoint_id="0", device="cuda")
    voice = tts.adapt(["a.wav", "b.wav"], ["<phonemes of a>", "..."],
                      spk_emb=dvec)
    tts.save_voice(voice, "voices/spk.voice")
    wav = tts.synthesize("Hello there.", voice)
    for chunk in tts.synthesize_stream("Hello there.", voice):
        ...

``adapt`` runs the JAX package's meta-test protocol on the clips: log-mel
features, one collated batch, ``n_inner_test`` steps of ``optim_inner``
on the teacher-forced training loss (``meta/maml.py``), then the loss of
the same batch on the adapted weights.  It always starts from the
float32 weights the object was built with, whatever ``infer_dtype``, and
never touches the serving model's tensors.  Voices and ``.ckpt``
checkpoints are the JAX package's msgpack files (``utils/checkpoint.py``).

Text → phonemes (``utils/g2p``) → Tacotron-2 with the decoder loop as
the CUDA kernel on a GPU (its plain PyTorch version on the CPU) → a
vocoder attached by name (``attach_vocoder``, the seam of
``vocoders/__init__.py``: Griffin-Lim by default, WaveRNN, HiFi-GAN,
WaveGlow).  ``synthesize_stream`` runs the decoder in segments (the CUDA
segment kernel on a GPU) through a delayed-exact postnet and a chunked
vocoder.  Each request draws its prenet dropout masks, then its
vocoder's noise, from a ``torch.Generator`` seeded by the request's
``seed``; the parity tests inject them instead.  The mel stays on the
device from the decoder to the vocoder.

``infer_dtype: bfloat16`` casts the model (parameters, batch-norm
state) and the speaker vector to bfloat16, as the JAX package's
``_cast_infer`` does: the encoder and the postnet run in bfloat16, the
decoder with bfloat16 products on float32 state (on a GPU the kernels'
bfloat16 weight path), and mels come back in float32.  ``auto`` is
float32 here (the JAX package's ``auto`` routes by a batch gate measured
on its own hardware, which is not carried over).  Solo, streamed and
multiplexed decoding use the same type.

``parallel: {dp: N}`` serves ``synthesize_batch`` over N devices, as the
JAX package shard_maps its decode: the batch is padded to a multiple of
N with filler rows, its prenet masks are drawn for the whole padded
batch, and each device decodes a contiguous block of rows on its own
replica of the model (its own copy of the kernel's packed weights),
every block launched before any result is awaited; the mels are
gathered on the model's device.  The devices are the host's CUDA
devices (a mesh larger than ``torch.cuda.device_count()`` raises), or N
times the CPU, or ``mesh_devices``.  The noise does not depend on N (the
JAX package folds the shard index into each shard's key).

``parallel: {tp: M}`` (and ``tp_min_dim``, default 128) shards the
weights over M devices in the JAX package's layout (``parallel/tp.py``,
through ``parallel.tp.DeviceTransport``): each device holds its shards,
the first also the whole leaves, and every request runs the plain
decode with partitioned products (the JAX package runs its XLA decode
under tp: the whole-loop kernel is single-device).  ``decode_backend:
auto`` resolves to ``torch``; ``cuda`` with tp raises.  ``self.model``
is then a weightless meta-device template; a voice is sharded when it
is first served.  ``infer_dtype: bfloat16`` casts the shards, as the
one-device model is cast.  ``{dp, tp}`` together raises, as in the JAX
package.

While a ``torch.profiler`` session runs, ``synthesize`` and
``synthesize_batch`` record their stages as spans
(``utils/profiling.py``, reachable as ``AdaptiveTTS.recorder``):
``tts.g2p``, ``tts.inputs`` (padding, the prenet masks drawn where none
are given, the copies to the device), ``tts.encode``, ``tts.decode``,
``tts.postnet``, ``tts.sync`` (the wait for the mel lengths),
``tts.vocode.<vocoder>`` and ``tts.to_host`` (the wait for the
waveforms).
"""

from __future__ import annotations

import copy
import os
import weakref
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from .dataloaders.collate import collate
from .dataloaders.dataset import Item, compute_logmel
from .meta.maml import make_metatest_fn
from .models.cuda_decoder import (
    check_supported,
    cuda_decoder_segment,
    prenet_masks,
    segment_inputs,
)
from .models.decoder import decoder_infer_segment, decoder_stream_init
from .models.loss import tacotron2_loss
from .models.tacotron2nv import (
    Tacotron2NV,
    _encode,
    config_from_params,
    dropout_masks,
    postnet_residual,
    tacotron2nv_infer,
)
from .ops.audio import load_wav, trim_margin_silence
from .optim import make_optimizer
from .parallel.mesh import Mesh, make_mesh
from .parallel.tp import (
    DeviceTransport,
    TensorParallel,
    gather_tree_tp,
    shard_tree_tp,
    tp_products,
    tp_shardings,
)
from .utils.backend import load_device, resolve_kernel_backend
from .utils.batching import pad_mel_batch
from .utils.checkpoint import (
    load_checkpoint,
    load_model_checkpoint,
    save_checkpoint,
)
from .utils.convert import jax_from_state_dict, state_dict_from_jax
from .utils.g2p import N_SYMBOLS, Grapheme2Phoneme
from .utils.profiling import RECORDER, annotate
from .vocoders import SEAM
from .vocoders.griffinlim import GriffinLim


@dataclass(eq=False)
class Voice:
    """An adapted speaker: the model's float32 ``state_dict``, its
    d-vector and the loss ``adapt`` ended with (the query loss).
    Identity-keyed, so that :class:`AdaptiveTTS` loads each voice onto
    the device once."""

    state_dict: dict
    spk_emb: np.ndarray
    support_loss: float = float("nan")


def teacher_forced_loss_fn(cfg, crit: dict):
    """The teacher-forced training loss ``loss_fn(params, model_state,
    batch, masks) -> (loss, new_model_state)`` that adaptation steps on:
    the model as a weightless meta-device copy run through
    ``torch.func.functional_call``, and ``tacotron2_loss`` with the
    ``criterion`` section's ``reduction`` (default none) and
    ``pos_weight`` (default 1)."""
    with torch.device("meta"):
        template = Tacotron2NV(cfg)

    def loss_fn(p, ms, b, masks):
        outs, new_ms = torch.func.functional_call(
            template, {**p, **ms},
            (b["inputs"], b["input_lengths"], b["melspecs"],
             b["melspec_lengths"], b["speaker_vecs"], masks))
        loss = tacotron2_loss(
            outs, (b["melspecs"], b["stop_labels"]), b["melspec_lengths"],
            n_frames_per_step=cfg.n_frames_per_step,
            reduction=crit.get("reduction", "none"),
            pos_weight=float(crit.get("pos_weight", 1.0)))
        return loss, {**ms, **new_ms}

    return loss_fn


TP_WITH_DP = ("serving parallel: use {dp: N} (batch throughput) or {tp: M} "
              "(per-stream latency), not both")


class AdaptiveTTS:
    # the spans and kernel stamps of the calls made while a profiler
    # session runs (utils/profiling.py)
    recorder = RECORDER

    def __init__(self, params: dict, model: Tacotron2NV, *, device=None,
                 mesh_devices=None):
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
        self._dp = int(pcfg.get("dp", 1))
        self._tp = int(pcfg.get("tp", 1))
        if self._tp > 1 and self._dp > 1:
            raise NotImplementedError(TP_WITH_DP)

        self.device = torch.device(
            device if device is not None
            else next(model.parameters()).device
        )
        # parallel: {dp: N}: synthesize_batch's rows over N devices;
        # {tp: M}: every product over M devices
        self._mesh = self._tp_mesh = None
        if self._dp > 1 or self._tp > 1:
            devices = mesh_devices or (
                [self.device] * max(self._dp, self._tp)
                if self.device.type == "cpu"
                else [torch.device("cuda", i)
                      for i in range(torch.cuda.device_count())])
            if self._dp > 1:
                self._mesh = make_mesh(dp=self._dp, task=1, devices=devices)
            else:
                self._tp_mesh = make_mesh(dp=1, task=1, tp=self._tp,
                                          devices=devices)
                self._tp_min_dim = int(pcfg.get("tp_min_dim", 128))
        self._replicas: weakref.WeakKeyDictionary = (
            weakref.WeakKeyDictionary())
        # the float32 weights adapt starts from; the serving model is
        # derived from them at infer_dtype (in float32 it holds them
        # itself; in bfloat16 the cast leaves them to _master alone)
        model = model.to(self.device, torch.float32)
        self._master = {k: v.detach() for k, v in model.state_dict().items()}
        self._param_names = [k for k, _ in model.named_parameters()]
        # tp: the model's tensors as their shards (the float32 master
        # weights adapt starts from, served at infer_dtype); the model a
        # meta-device template
        self._tp_ctx: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()
        if self._tp_mesh is not None:
            self._tp_plan = tp_shardings(self._master, self._tp_mesh,
                                         self._tp_min_dim)
            self._master = shard_tree_tp(self._master, self._tp_mesh,
                                         self._tp_min_dim)
            self.model = self._tp_template(self._master, self.infer_dtype)
        else:
            self.model = model.to(self.infer_dtype).eval()
        del model
        self._inner_tx = make_optimizer(
            params.get("optim_inner", {"optimizer_type": "SGD", "lr": 1e-2})
        )
        self._n_inner = int(params.get("n_inner_test", 5))
        self.decode_backend = params.get("decode_backend") or "auto"
        if self._tp_mesh is not None:
            if self.decode_backend == "cuda":
                raise NotImplementedError(
                    "decode_backend: cuda with parallel: tp — the decoder "
                    "kernel is single-device; tp runs the plain decode "
                    "(decode_backend: torch or auto)")
            self.decode_backend = "torch"
        # raises now, not at the first request, for `cuda` on a CPU or a
        # config the kernel does not lower on a GPU
        if resolve_kernel_backend(self.decode_backend, self.device) == "cuda":
            check_supported(self.cfg.decoder_config())
        self.g2p = Grapheme2Phoneme()
        self._vocoders: dict = {}
        self.attach_vocoder(GriffinLim.name, GriffinLim(params["audio_params"]))
        self._voice_cache: weakref.WeakKeyDictionary = (
            weakref.WeakKeyDictionary()
        )

    # ------------------------------------------------------------- load
    @classmethod
    def from_experiment(cls, experiment_path: str, checkpoint_id: str = "0",
                        *, device="cuda", **overrides):
        """Load ``params.yml`` and ``checkpoints/checkpoint_{id}.ckpt``
        (a JAX-package trainer's msgpack checkpoint: its ``params`` and
        ``model_state``) or ``checkpoint_{id}.pt`` (the reference
        ``state_dict`` layout) from an experiment directory onto
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
        sd, _ = load_model_checkpoint(os.path.join(
            experiment_path, "checkpoints", f"checkpoint_{checkpoint_id}"),
            model.cfg)
        model.load_state_dict(sd, strict=True)
        return cls(params, model, device=device)

    # ------------------------------------------------------------ adapt
    def adapt_batch(self, wav_paths: Sequence[str],
                    phonemes: Sequence[str], spk_emb: np.ndarray) -> dict:
        """The clips as the one training batch ``adapt`` runs on, device
        tensors: each wav loaded at the model's rate, trimmed of margin
        silence when ``dataset_train.trim_margin_silence``, turned into
        the ``audio_processor``'s log-mel, and collated with its
        phonemes (sorted by text length, longest first)."""
        if len(wav_paths) != len(phonemes):
            raise ValueError(f"{len(wav_paths)} clips but {len(phonemes)} "
                             "phonemizations")
        ap = self.params["audio_params"]
        trim = self.params.get("dataset_train", {}).get(
            "trim_margin_silence", False)
        spk_emb = np.asarray(spk_emb, np.float32)
        items = []
        for path, ph in zip(wav_paths, phonemes):
            wav = load_wav(path, target_sample_rate=ap["sample_rate"])
            if trim:
                wav = trim_margin_silence(wav)
            mel = compute_logmel(
                wav, self.params.get("audio_processor", "ap"), ap)
            seq, _ = self.g2p.convert(ph, convert_mode="phone_to_idx")
            items.append(Item(phonemes=np.asarray(seq, np.int32), mel=mel,
                              spk_emb=spk_emb))
        b = collate(items, reduction_factor=self.cfg.n_frames_per_step,
                    text_pad_multiple=16, mel_pad_multiple=32)
        dev = self.device

        def t(x, dtype=None):
            return torch.as_tensor(x, dtype=dtype, device=dev)

        return {
            "inputs": t(b.inputs, torch.int64),
            "input_lengths": t(b.input_lengths, torch.int64),
            "melspecs": t(b.mels),
            "melspec_lengths": t(b.mel_lengths, torch.int64),
            "speaker_vecs": t(b.spk_embs),
            "stop_labels": t(b.stop_labels),
        }

    def adapt(self, wav_paths: Sequence[str], phonemes: Sequence[str],
              spk_emb: np.ndarray, *, seed: int = 0, masks=None) -> Voice:
        """k-shot adaptation from reference clips and their
        phonemizations; the support set is also the query set.

        ``masks``: every dropout mask of the ``n_inner_test`` steps and
        the query pass, a list of ``n_inner_test + 1`` dictionaries as
        ``models.tacotron2nv.dropout_masks`` draws them for the batch
        (arrays or tensors; rows in the batch's order, longest text
        first).  Without it they are drawn on the device from a generator
        seeded with ``seed``."""
        batch = self.adapt_batch(wav_paths, phonemes, spk_emb)
        dev = self.device
        B, T_in = batch["inputs"].shape
        T_mel = batch["melspecs"].shape[-1]
        if masks is None:
            g = torch.Generator(device=dev).manual_seed(seed)
            masks = [dropout_masks(self.cfg, B, T_in, T_mel, g, device=dev)
                     for _ in range(self._n_inner + 1)]
        elif len(masks) != self._n_inner + 1:
            raise ValueError(f"{len(masks)} passes of masks, want "
                             f"n_inner_test + 1 = {self._n_inner + 1}")
        else:
            masks = [_on_device(m, dev) for m in masks]

        # the serving model is never reparametrised (the loss runs a
        # weightless copy), so requests that run meanwhile see their own
        # weights
        crit = self.params.get("criterion", {})
        if self._tp_mesh is not None:
            loss_fn = self._tp_loss_fn(crit)
            params = _flat_shards({k: self._master[k]
                                   for k in self._param_names})
            state = _flat_shards({k: v for k, v in self._master.items()
                                  if k not in self._param_names})
        else:
            loss_fn = teacher_forced_loss_fn(self.cfg, crit)
            params = {k: self._master[k] for k in self._param_names}
            state = {k: v for k, v in self._master.items()
                     if k not in params}
        with torch.enable_grad():           # also under a caller's no_grad
            qloss, adapted, ms, _ = make_metatest_fn(
                loss_fn, self._inner_tx, self._n_inner)(
                    params, state, batch, batch, masks)
        sd = {k: v.detach() for k, v in {**adapted, **ms}.items()}
        if self._tp_mesh is not None:
            sd = gather_tree_tp(_unflat_shards(sd), self._tp_mesh,
                                self._tp_plan)
        return Voice(state_dict=sd,
                     spk_emb=np.asarray(spk_emb, np.float32),
                     support_loss=float(qloss))

    def _tp_loss_fn(self, crit: dict):
        """:func:`teacher_forced_loss_fn` over the shards of a tp model,
        keyed ``name@i`` (:func:`_flat_shards`), so that the inner loop
        steps each shard as a tensor of its own; the new batch-norm
        state comes back whole and is cut to its shards again."""
        template = self._tp_template({})
        ctx = self._tp_ctx[template]

        def loss_fn(p, ms, b, masks):
            with tp_products(ctx.with_values(_unflat_shards({**p, **ms}))):
                outs, new_ms = template(
                    b["inputs"], b["input_lengths"], b["melspecs"],
                    b["melspec_lengths"], b["speaker_vecs"], masks)
            loss = tacotron2_loss(
                outs, (b["melspecs"], b["stop_labels"]),
                b["melspec_lengths"],
                n_frames_per_step=self.cfg.n_frames_per_step,
                reduction=crit.get("reduction", "none"),
                pos_weight=float(crit.get("pos_weight", 1.0)))
            return loss, {**ms, **_flat_shards(shard_tree_tp(
                new_ms, self._tp_mesh, self._tp_min_dim))}

        return loss_fn

    # ---------------------------------------------------- voice storage
    def save_voice(self, voice: Voice, path: str) -> None:
        """Write ``voice`` as the JAX package writes one: one msgpack
        file (atomic) of ``params``, ``model_state`` (its trees),
        ``spk_emb`` and ``support_loss``; either package loads it."""
        params, state = jax_from_state_dict(voice.state_dict, self.cfg)
        save_checkpoint(path, {
            "params": params,
            "model_state": state,
            "spk_emb": np.asarray(voice.spk_emb, np.float32),
            "support_loss": np.float32(voice.support_loss),
        })

    def load_voice(self, path: str) -> Voice:
        """A voice file written by either package's ``save_voice``."""
        raw = load_checkpoint(path)
        return Voice(
            state_dict=state_dict_from_jax(raw["params"],
                                           raw["model_state"], self.cfg),
            spk_emb=np.asarray(raw["spk_emb"], np.float32),
            support_loss=float(raw["support_loss"]),
        )

    def _voice_model(self, voice: Voice | None) -> Tacotron2NV:
        """The model holding ``voice``'s weights (the base model when
        None), loaded onto the device once per Voice."""
        if voice is None:
            return self.model
        model = self._voice_cache.get(voice)
        if model is None:
            if self._tp_mesh is not None:
                model = self._tp_template(shard_tree_tp(
                    {k: v.to(self.device, torch.float32)
                     for k, v in voice.state_dict.items()},
                    self._tp_mesh, self._tp_min_dim), self.infer_dtype)
            else:
                model = Tacotron2NV(self.model.cfg)
                model.load_state_dict(voice.state_dict, strict=True)
                model = model.to(self.device, self.infer_dtype).eval()
            self._voice_cache[voice] = model
        return model

    # --------------------------------------------------- tensor parallel
    def _tp_template(self, shards: dict,
                     dtype=torch.float32) -> Tacotron2NV:
        """A weightless template of the model at ``dtype`` whose products
        run on ``shards`` (``{name: [shard, ...]}``, their float32 ones
        cast to ``dtype``, as the one-device model is) under
        :meth:`_tp_scope`."""
        with torch.device("meta"):
            template = Tacotron2NV(self.cfg).to(dtype).eval()
        if dtype != torch.float32:
            shards = {k: [v.to(dtype) if v.dtype == torch.float32 else v
                          for v in vs] for k, vs in shards.items()}
        self._tp_ctx[template] = TensorParallel(
            DeviceTransport(self._tp_mesh.devices.ravel()), self._tp_plan,
            template, shards)
        return template

    def _tp_scope(self, model):
        """The partitioned products of ``model`` (a tp template), or
        nothing for a model that holds its weights."""
        return tp_products(self._tp_ctx.get(model))

    # -------------------------------------------------------- synthesize
    def _phonemes(self, text: str) -> list[int]:
        return self.g2p.convert(
            text, convert_mode="text_to_phone_to_idx",
            language=self.params.get("language", "en-us"),
        )[0]

    def _replicas_of(self, model: Tacotron2NV) -> list:
        """``model`` on each device of the mesh (itself on its own
        device), made once per model."""
        reps = self._replicas.get(model)
        if reps is None:
            by_dev = {next(model.parameters()).device: model}
            for dev in self._mesh.devices.ravel():
                if dev not in by_dev:
                    by_dev[dev] = copy.deepcopy(model).to(dev)
            reps = [by_dev[d] for d in self._mesh.devices.ravel()]
            self._replicas[model] = reps
        return reps

    def _decode(self, model, inputs: np.ndarray, in_len: np.ndarray,
                emb: np.ndarray, generator: torch.Generator, pre_masks,
                shard: bool = False):
        """(B, T) phoneme ids → mels (B, n_mel, S·r) on the device and
        host mel_lengths (B,) in decoder steps; with ``shard`` and a
        ``parallel: {dp: N}`` mesh, over its devices (B a multiple of
        N)."""
        with annotate("tts.inputs"):
            args = self._inputs(inputs, in_len, emb, generator, pre_masks,
                                shard)
        return self._decode_inputs(model, args, shard)

    def _inputs(self, inputs, in_len, emb, generator, pre_masks, shard):
        """The decode's inputs: the prenet masks drawn from
        ``generator`` where none are given, and everything copied to the
        device (kept on the host for a ``parallel: {dp: N}`` mesh, which
        copies each device's rows)."""
        dev = self.device
        if pre_masks is None:
            dcfg = self.cfg.decoder_config()
            pre_masks = prenet_masks(dcfg, dcfg.max_decoder_steps,
                                     inputs.shape[0], generator, device=dev)
        if shard and self._mesh is not None:
            return inputs, in_len, emb, pre_masks
        return (torch.as_tensor(inputs, dtype=torch.int64, device=dev),
                torch.as_tensor(in_len, dtype=torch.int64, device=dev),
                torch.as_tensor(emb, dtype=torch.float32, device=dev),
                torch.as_tensor(pre_masks, dtype=torch.float32, device=dev))

    def _decode_inputs(self, model, args, shard: bool):
        """:meth:`_decode` from :meth:`_inputs`' ``args``."""
        if shard and self._mesh is not None:
            mel, mel_len = decode_sharded(
                self._mesh, self._replicas_of(model), self.cfg, *args,
                decode_backend=self.decode_backend, out_device=self.device)
        else:
            with self._tp_scope(model):
                mel, mel_len, _ = tacotron2nv_infer(
                    model, self.cfg, *args, mask_pad=True,
                    decode_backend=self.decode_backend)
        with annotate("tts.sync"):
            return mel, mel_len.cpu().numpy()

    def synthesize(self, text: str, voice: Voice | None = None, *,
                   vocoder: str = "griffinlim", seed: int = 0,
                   spk_emb: np.ndarray | None = None, pre_masks=None,
                   gl_phase=None, voc_noise=None) -> np.ndarray:
        """Text → waveform as the adapted speaker (or the base model with
        an explicit ``spk_emb``).  ``pre_masks`` (S, 2, 1, P), ``gl_phase``
        (Griffin-Lim's starting phase) and ``voc_noise`` (a list of one
        noise, as the vocoder takes it) inject the noise a request would
        otherwise draw from a generator seeded with ``seed``."""
        emb = voice.spk_emb if voice else np.asarray(spk_emb, np.float32)
        with annotate("tts.g2p"):
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
        (B, T) shape, and a ``parallel: {dp: N}`` mesh pads it to a
        multiple of N; filler rows replicate row 0 and are dropped from
        the result.  ``pre_masks`` (S, 2, Bp, P), ``gl_phase`` and
        ``voc_noise`` (the vocoder's, one a text) inject the noise."""
        emb = voice.spk_emb if voice else np.asarray(spk_emb, np.float32)
        with annotate("tts.g2p"):
            seqs = [self._phonemes(t) for t in texts]
        B = len(seqs)
        g = torch.Generator().manual_seed(seed)
        with annotate("tts.inputs"):
            Bp = max(B, pad_batch_to or B)
            Bp = -(-Bp // self._dp) * self._dp
            m = max(int(text_pad_multiple), 1)
            T = -(-max(len(s) for s in seqs) // m) * m
            inputs = np.zeros((Bp, T), np.int64)
            in_len = np.empty((Bp,), np.int64)
            for i, s in enumerate(seqs):
                inputs[i, : len(s)] = s
                in_len[i] = len(s)
            inputs[B:], in_len[B:] = inputs[0], in_len[0]   # filler rows
            args = self._inputs(
                inputs, in_len,
                np.tile(np.asarray(emb, np.float32)[None], (Bp, 1)), g,
                pre_masks, True)
        mel, mel_len = self._decode_inputs(self._voice_model(voice), args,
                                           True)
        r = self.cfg.n_frames_per_step
        mels = [mel[i, :, : max(int(mel_len[i]), 1) * r] for i in range(B)]
        return self._vocode(mels, vocoder, g, gl_phase, voc_noise)

    # ------------------------------------------------------------ vocoders
    def attach_vocoder(self, name: str, vocoder) -> None:
        """Serve ``vocoder`` (the seam of ``vocoders/__init__.py``) as
        ``vocoder=name``, on this model's device: the mel stays there."""
        missing = [a for a in SEAM if not hasattr(vocoder, a)]
        if missing:
            raise ValueError(f"{type(vocoder).__name__} is not a vocoder: "
                             f"it has no {', '.join(missing)}")
        self._vocoders[name] = vocoder.to(self.device)

    def _attached(self, name: str):
        voc = self._vocoders.get(name)
        if voc is None:
            raise ValueError(f"no vocoder {name!r}: attach_vocoder({name!r}, "
                             f"...) first (attached: {sorted(self._vocoders)})")
        return voc

    def _vocode(self, mels: list[torch.Tensor], vocoder: str,
                generator: torch.Generator, init_phase=None,
                voc_noise=None):
        """Device mels (n_mel, T_i) → host waveforms (or host mels for
        ``vocoder="none"``)."""
        wavs = mels
        if vocoder != "none":
            voc = self._attached(vocoder)
            with annotate(f"tts.vocode.{vocoder}"):
                wavs = voc.vocode(mels, generator, phase=init_phase,
                                  noise=voc_noise)
            if not any(isinstance(w, torch.Tensor) for w in wavs):
                return wavs             # copied inside the call
        with annotate("tts.to_host"):
            return [w.cpu().numpy() for w in wavs]


def decode_sharded(mesh: Mesh, models: list, cfg, inputs, in_len, emb,
                   pre_masks, *, decode_backend="auto", out_device=None):
    """The decode of a (Bp, T) batch with its rows split in contiguous
    blocks over the devices of a serving ``mesh`` (``make_mesh(dp=N,
    devices=...)``; Bp a multiple of N): block i decodes on ``models[i]``
    (a replica on device i) with its rows of the (S, 2, Bp, P)
    ``pre_masks``, every block launched before any is read.  Returns the
    mels (Bp, n_mel, S·r), shorter blocks padded with zeros, and the
    lengths (Bp,), both on ``out_device`` (default the first device)."""
    devices = list(mesh.devices.ravel())
    n = len(devices)
    Bp = len(inputs)
    if Bp % n:
        raise ValueError(f"{Bp} rows do not split over {n} devices")
    b = Bp // n
    out_device = devices[0] if out_device is None else out_device
    outs = []
    for i, (dev, model) in enumerate(zip(devices, models)):
        rows = slice(i * b, (i + 1) * b)
        mel, mel_len, _ = tacotron2nv_infer(
            model, cfg,
            torch.as_tensor(inputs[rows], dtype=torch.int64, device=dev),
            torch.as_tensor(in_len[rows], dtype=torch.int64, device=dev),
            torch.as_tensor(emb[rows], dtype=torch.float32, device=dev),
            torch.as_tensor(pre_masks[:, :, rows], dtype=torch.float32,
                            device=dev).contiguous(),
            mask_pad=True, decode_backend=decode_backend,
        )
        outs.append((mel, mel_len))
    T = max(m.shape[-1] for m, _ in outs)
    mel = torch.cat([torch.nn.functional.pad(m.to(out_device),
                                             (0, T - m.shape[-1]))
                     for m, _ in outs])
    return mel, torch.cat([ln.to(out_device) for _, ln in outs])


def _flat_shards(tree: dict) -> dict:
    """``{name: [shard, ...]}`` as ``{"name@i": shard i}``."""
    return {f"{k}@{i}": s for k, v in tree.items() for i, s in enumerate(v)}


def _unflat_shards(flat: dict) -> dict:
    """The inverse of :func:`_flat_shards`."""
    out: dict = {}
    for key, s in flat.items():
        name, i = key.rsplit("@", 1)
        out.setdefault(name, []).append((int(i), s))
    return {k: [s for _, s in sorted(v, key=lambda e: e[0])]
            for k, v in out.items()}


def _on_device(masks, device):
    """One pass's dropout masks (a dict of arrays and lists of arrays) as
    float32 tensors on ``device``."""
    if isinstance(masks, dict):
        return {k: _on_device(v, device) for k, v in masks.items()}
    if isinstance(masks, (list, tuple)):
        return [_on_device(v, device) for v in masks]
    return torch.as_tensor(masks, dtype=torch.float32, device=device)


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
    output: offline-exact for a feed-forward vocoder whose receptive
    field fits inside the context (HiFi-GAN), each window its own else."""

    def __init__(self, vocode_fn, hop: int, chunk: int, ctx: int,
                 tail_frames: int = 0):
        # (n_mel, W) device -> (n,) host array
        self.vocode = vocode_fn
        self.hop, self.chunk, self.ctx = int(hop), int(chunk), int(ctx)
        # the vocoder's tail_frames: a padded final window trims them so
        # that the streamed total is the offline one
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
                win = pad_mel_batch([win], W)[0]
            wav = self.vocode(win)
            if padded:
                wav = wav[: (b - a - self.tail_frames) * self.hop]
            o = (s - a) * self.hop
            n = (e - s) * self.hop
            chunk = wav[o: o + n]
            self.done = e
            if len(chunk):
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
    per-stream pipelines.  Each window goes through
    :meth:`AdaptiveTTS._vocode` with the noise the vocoder's
    ``stream_noise`` gives it from ``seed``, ``gl_phase`` (a tensor, or a
    callable ``(n_freqs, n_frames) -> phase``) and ``voc_noise``."""
    cfg = tts.cfg
    r = cfg.n_frames_per_step
    pctx = _postnet_ctx(cfg)

    def post_fn(x, width):
        with tts._tp_scope(model):
            return x + postnet_residual(model.postnet, x, width=width)

    # windows are padded to the widest a segment stream can produce (left
    # ctx + held-back ctx + a segment's raw frames + final zeros <= 3·ctx)
    post = _StreamingPostnet(post_fn, pctx,
                             pad_to=segment_steps * r + 3 * pctx)
    if vocoder == "none":
        return _StreamCursor(cfg, r, post, _MelRelay)
    voc = tts._attached(vocoder)        # raises now, not at the first chunk
    if not voc.streams:
        raise ValueError(f"vocoder={vocoder!r} is not streamed: it runs over "
                         "the whole mel; use synthesize or synthesize_batch")
    if voc.tail_frames and vocode_ctx_frames < 1:
        raise ValueError(f"vocoder={vocoder!r} needs vocode_ctx_frames >= 1")
    noise_for = voc.stream_noise(seed, phase=gl_phase, noise=voc_noise)
    ap = tts.params["audio_params"]
    return _StreamCursor(cfg, r, post, _StreamingVocoder(
        lambda mel: tts._vocode([mel], vocoder,
                                *noise_for(mel.shape[-1]))[0],
        ap.get("hop_length", ap.get("hop_size")), chunk_frames,
        vocode_ctx_frames, voc.tail_frames))


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
    with tts._tp_scope(model):
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
    postnet → chunked vocoder (one that streams).  The mel path is
    :meth:`synthesize`'s:
    ``vocoder="none"`` streams the offline mel in pieces.

    Noise: the prenet masks are the (S, 2, 1, P) draw :meth:`synthesize`
    makes for ``seed`` (or ``pre_masks``), sliced per segment; each
    window's is the vocoder's ``stream_noise`` of ``seed``, ``gl_phase``
    and ``voc_noise`` (``_stream_cursor``).

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
            with self._tp_scope(model):
                return decoder_infer_segment(model.decoder, dcfg, enc,
                                             in_len, pm, st, n)

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
