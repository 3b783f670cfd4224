"""Few-shot TTS serving API, synthesis path (counterpart of
``msa_tts_tpu/serving.py``).

    tts = AdaptiveTTS.from_experiment("output/maml/vctk_maml",
                                      checkpoint_id="0", device="cuda")
    wav = tts.synthesize("Hello there.", spk_emb=dvec)

Text → phonemes (the JAX package's jax-free G2P) → Tacotron-2 with the
decoder loop as the CUDA kernel on a GPU (its plain PyTorch version on
the CPU) → Griffin-Lim.  Each request draws its prenet dropout masks and
its Griffin-Lim starting phase from a ``torch.Generator`` seeded by the
request's ``seed``; the parity tests inject both instead.

Not in this version (each raises ``NotImplementedError``): speaker
adaptation (``adapt``), ``.ckpt`` (flax msgpack) checkpoints,
``infer_dtype: bfloat16``, ``parallel`` dp/tp serving, and the WaveRNN
and HiFi-GAN vocoders.
"""

from __future__ import annotations

import os
import weakref
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from msa_tts_tpu.utils.g2p import N_SYMBOLS, Grapheme2Phoneme

from .models.cuda_decoder import check_supported, prenet_masks
from .models.tacotron2nv import Tacotron2NV, config_from_params, tacotron2nv_infer
from .ops.audio import griffinlim_logmelspec
from .utils.backend import resolve_kernel_backend


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
        if idt in ("bfloat16", "bf16"):
            raise NotImplementedError(
                "infer_dtype bfloat16: the port decodes in float32 only"
            )
        if idt not in (None, "auto", "float32", "fp32"):
            raise ValueError(
                f"unknown infer_dtype {idt!r}: expected 'auto', "
                "'float32' or 'bfloat16'"
            )
        pcfg = params.get("parallel") or {}
        if int(pcfg.get("dp", 1)) > 1 or int(pcfg.get("tp", 1)) > 1:
            raise NotImplementedError(
                "parallel dp/tp serving is not ported yet"
            )

        self.device = torch.device(
            device if device is not None
            else next(model.parameters()).device
        )
        self.model = model.to(self.device).eval()
        self.decode_backend = params.get("decode_backend") or "auto"
        # raises now, not at the first request, for `cuda` on a CPU or a
        # config the kernel does not lower on a GPU
        if resolve_kernel_backend(self.decode_backend, self.device) == "cuda":
            check_supported(self.cfg.decoder_config())
        self.g2p = Grapheme2Phoneme()
        self._voice_cache: weakref.WeakKeyDictionary = (
            weakref.WeakKeyDictionary()
        )

    # ------------------------------------------------------------- load
    @classmethod
    def from_experiment(cls, experiment_path: str, checkpoint_id: str = "0",
                        *, device=None, **overrides):
        """Load ``params.yml`` and ``checkpoints/checkpoint_{id}.pt`` (the
        reference ``state_dict`` layout) from an experiment directory."""
        from msa_tts_tpu.config import load_params

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
            model = model.to(self.device).eval()
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
                   gl_phase=None) -> np.ndarray:
        """Text → waveform as the adapted speaker (or the base model with
        an explicit ``spk_emb``).  ``pre_masks`` (S, 2, 1, P) and
        ``gl_phase`` inject the noise a request would otherwise draw
        from a generator seeded with ``seed``."""
        emb = voice.spk_emb if voice else np.asarray(spk_emb, np.float32)
        seq = self._phonemes(text)
        g = torch.Generator().manual_seed(seed)
        mel, mel_len = self._decode(
            self._voice_model(voice), np.asarray(seq, np.int64)[None],
            np.asarray([len(seq)]), np.asarray(emb, np.float32)[None], g,
            pre_masks,
        )
        n = max(int(mel_len[0]), 1) * self.cfg.n_frames_per_step
        return self._vocode([mel[0, :, :n]], vocoder, g, gl_phase)[0]

    def synthesize_batch(
        self, texts: Sequence[str], voice: Voice | None = None, *,
        vocoder: str = "griffinlim", seed: int = 0,
        spk_emb: np.ndarray | None = None, text_pad_multiple: int = 1,
        pad_batch_to: int | None = None, pre_masks=None, gl_phase=None,
    ) -> list[np.ndarray]:
        """Batched text → waveforms: one decode over all texts.

        ``text_pad_multiple`` / ``pad_batch_to`` quantize the padded
        (B, T) shape; filler rows replicate row 0 and are dropped from
        the result.  ``pre_masks`` (S, 2, Bp, P) and ``gl_phase`` inject
        the request's noise."""
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
        return self._vocode(mels, vocoder, g, gl_phase)

    # ------------------------------------------------------------ vocoders
    def _vocode(self, mels: list[torch.Tensor], vocoder: str,
                generator: torch.Generator, init_phase=None):
        """Device mels (n_mel, T_i) → host waveforms (or host mels for
        ``vocoder="none"``)."""
        if vocoder == "none":
            return [m.cpu().numpy() for m in mels]
        if vocoder in ("wavernn", "hifigan"):
            raise NotImplementedError(
                f"the {vocoder} vocoder is not ported yet"
            )
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
