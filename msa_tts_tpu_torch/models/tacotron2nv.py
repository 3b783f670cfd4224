"""Speaker-conditioned Tacotron-2 acoustic model, inference path
(counterpart of ``msa_tts_tpu/models/tacotron2nv.py``).

char embedding → conv+BiLSTM encoder (optional residual) → speaker
conditioning concat (``learnable_lookup`` / ``static`` d-vector /
``static+linear`` projected d-vector) → AR decoder → postnet residual.
The ``Tacotron2NV`` module holds the weights under the reference
checkpoint's ``state_dict`` keys.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from ..ops import nn as N
from ..utils.backend import resolve_kernel_backend
from .cuda_decoder import check_supported, cuda_decoder_infer
from .decoder import (
    Decoder,
    DecoderConfig,
    Postnet,
    decoder_infer,
    postnet_apply,
)
from .encoder import Encoder, encoder_apply


class ModelConfig(NamedTuple):
    """Static model hyperparameters (the reference's ``params["model"]``
    vocabulary, inference fields)."""

    n_symbols: int
    symbols_embedding_dim: int
    encoder_n_convolutions: int
    encoder_embedding_dim: int
    encoder_kernel_size: int
    n_mel_channels: int
    n_frames_per_step: int
    speaker_emb_type: str          # learnable_lookup | static | static+linear
    num_speakers: int
    speaker_embedding_dim: int
    speaker_embedding_dim_lin: int
    attention_rnn_dim: int
    decoder_rnn_dim: int
    prenet_dim: int
    max_decoder_steps: int
    gate_threshold: float
    p_attention_dropout: float
    p_decoder_dropout: float
    early_stopping: bool
    postnet_embedding_dim: int
    postnet_kernel_size: int
    postnet_n_convolutions: int
    attention_params: dict
    mask_padding: bool = True
    use_residual_encoder: bool = False
    p_prenet_dropout: float = 0.5

    @property
    def conditioned_embedding_dim(self) -> int:
        d = self.encoder_embedding_dim
        if self.speaker_emb_type in ("learnable_lookup", "static"):
            return d + self.speaker_embedding_dim
        if self.speaker_emb_type == "static+linear":
            return d + self.speaker_embedding_dim_lin
        raise ValueError(
            f"unknown speaker_emb_type: {self.speaker_emb_type}"
        )

    def decoder_config(self) -> DecoderConfig:
        return DecoderConfig(
            n_mel_channels=self.n_mel_channels,
            n_frames_per_step=self.n_frames_per_step,
            encoder_embedding_dim=self.conditioned_embedding_dim,
            attention_rnn_dim=self.attention_rnn_dim,
            decoder_rnn_dim=self.decoder_rnn_dim,
            prenet_dim=self.prenet_dim,
            max_decoder_steps=self.max_decoder_steps,
            gate_threshold=self.gate_threshold,
            p_attention_dropout=self.p_attention_dropout,
            p_decoder_dropout=self.p_decoder_dropout,
            early_stopping=self.early_stopping,
            attention_params=self.attention_params,
            p_prenet_dropout=self.p_prenet_dropout,
        )


def config_from_params(model_params: dict) -> ModelConfig:
    """Build a :class:`ModelConfig` from a reference-style ``model``
    dict."""
    p = dict(model_params)
    return ModelConfig(
        n_symbols=p["n_symbols"],
        symbols_embedding_dim=p["symbols_embedding_dim"],
        encoder_n_convolutions=p["encoder_n_convolutions"],
        encoder_embedding_dim=p["encoder_embedding_dim"],
        encoder_kernel_size=p["encoder_kernel_size"],
        n_mel_channels=p["n_mel_channels"],
        n_frames_per_step=p["n_frames_per_step"],
        speaker_emb_type=p["speaker_emb_type"],
        num_speakers=p.get("num_speakers", 1),
        speaker_embedding_dim=p.get("speaker_embedding_dim", 0),
        speaker_embedding_dim_lin=p.get("speaker_embedding_dim_lin", 0),
        attention_rnn_dim=p["attention_rnn_dim"],
        decoder_rnn_dim=p["decoder_rnn_dim"],
        prenet_dim=p["prenet_dim"],
        max_decoder_steps=p["max_decoder_steps"],
        gate_threshold=p["gate_threshold"],
        p_attention_dropout=p["p_attention_dropout"],
        p_decoder_dropout=p["p_decoder_dropout"],
        early_stopping=not p.get("decoder_no_early_stopping", False),
        postnet_embedding_dim=p["postnet_embedding_dim"],
        postnet_kernel_size=p["postnet_kernel_size"],
        postnet_n_convolutions=p["postnet_n_convolutions"],
        attention_params=p["attention_params"],
        mask_padding=p.get("mask_padding", True),
        use_residual_encoder=p.get("use_residual_encoder", False),
        p_prenet_dropout=p.get("p_prenet_dropout", 0.5),
    )


class Tacotron2NV(nn.Module):
    """The acoustic model's weights.  With a ``generator`` every weight is
    drawn from it with the JAX package's init distributions; without
    one, torch's default init stands until a ``state_dict`` is loaded."""

    def __init__(self, cfg: ModelConfig, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.embedding = nn.Embedding(cfg.n_symbols,
                                      cfg.symbols_embedding_dim)
        if generator is not None:
            N.init_embedding(self.embedding, generator, scaled_uniform=True)
        self.encoder = Encoder(
            cfg.encoder_n_convolutions, cfg.encoder_embedding_dim,
            cfg.encoder_kernel_size, generator=generator,
        )
        if cfg.speaker_emb_type == "learnable_lookup":
            self.speaker_embedder = nn.Embedding(
                cfg.num_speakers, cfg.speaker_embedding_dim
            )
            if generator is not None:
                N.init_embedding(self.speaker_embedder, generator)
        elif cfg.speaker_emb_type == "static+linear":
            self.speaker_lin = nn.Linear(
                cfg.speaker_embedding_dim, cfg.speaker_embedding_dim_lin
            )
            if generator is not None:
                a = 1.0 / math.sqrt(cfg.speaker_embedding_dim)
                N.uniform_(self.speaker_lin.weight, a, generator)
                N.uniform_(self.speaker_lin.bias, a, generator)
        self.decoder = Decoder(cfg.decoder_config(), generator=generator)
        self.postnet = Postnet(
            cfg.n_mel_channels, cfg.postnet_embedding_dim,
            cfg.postnet_kernel_size, cfg.postnet_n_convolutions,
            generator=generator,
        )


def _encode(model: Tacotron2NV, cfg: ModelConfig, inputs, input_lengths,
            speaker_vecs, *, mask_pad: bool = False):
    """Embedding → encoder → speaker conditioning, (B, T, E_cond).

    ``mask_pad`` makes the encoder output at valid positions independent
    of the padded length (see encoder.py:encoder_apply) — used by the
    serving paths.  Everything runs at the model's parameter type (the
    speaker vector is cast to it)."""
    if speaker_vecs.is_floating_point():
        speaker_vecs = speaker_vecs.to(model.embedding.weight.dtype)
    emb = N.embedding(inputs, model.embedding.weight)          # (B, T, D)
    enc_out = encoder_apply(
        model.encoder, emb.transpose(1, 2), input_lengths,
        mask_pad=mask_pad,
    )
    if cfg.use_residual_encoder:
        enc_out = enc_out + emb
    if cfg.speaker_emb_type == "learnable_lookup":
        spk = N.embedding(speaker_vecs, model.speaker_embedder.weight)
    elif cfg.speaker_emb_type == "static":
        spk = speaker_vecs
    elif cfg.speaker_emb_type == "static+linear":
        spk = model.speaker_lin(speaker_vecs)
    else:
        raise ValueError(cfg.speaker_emb_type)
    spk = spk[:, None, :].expand(-1, enc_out.shape[1], -1)
    return torch.cat([enc_out, spk.to(enc_out.dtype)], dim=-1)


def postnet_residual(postnet: Postnet, mel, *, width: int | None = None):
    """The postnet's correction to a float32 mel (B, n_mel, T), computed
    at the postnet's parameter type and returned in the mel's."""
    dt = postnet.convolutions[0][0].conv.weight.dtype
    return postnet_apply(postnet, mel.to(dt), width=width).to(mel.dtype)


@torch.no_grad()
def tacotron2nv_infer(model: Tacotron2NV, cfg: ModelConfig, inputs,
                      input_lengths, speaker_vecs, pre_masks, *,
                      mask_pad: bool = False, decode_backend="auto"):
    """Autoregressive synthesis.

    ``pre_masks``: (S, 2, B, P) raw 0/1 prenet dropout masks.
    ``decode_backend``: ``torch`` runs the plain loop; ``cuda`` and
    ``auto`` run the decoder loop as the CUDA kernel
    (models/cuda_decoder.py) on CUDA tensors, and ``auto`` runs the
    plain loop on CPU tensors.  On CUDA tensors a config the kernel does
    not lower (inference windowing, forward_attn_mask) raises under
    both: the plain loop runs on the card only when asked for by name.

    A model cast to bfloat16 encodes and runs its postnet in bfloat16
    and decodes with bfloat16 products on float32 state (see
    models/decoder.py); the mel comes back in float32.

    Returns ``(mel_outputs_postnet (B, n_mel, S·r), mel_lengths (B,),
    alignments (B, S, T_in))``; ``mel_lengths`` is in decoder steps and
    the buffer past it is padding."""
    enc_cond = _encode(model, cfg, inputs, input_lengths, speaker_vecs,
                       mask_pad=mask_pad)
    dcfg = cfg.decoder_config()
    decode = decoder_infer
    if resolve_kernel_backend(decode_backend, enc_cond.device) == "cuda":
        check_supported(dcfg)
        decode = cuda_decoder_infer
    mel_outputs, _gates, alignments, mel_lengths, _n = decode(
        model.decoder, dcfg, enc_cond.contiguous(), input_lengths,
        pre_masks,
    )
    mel_outputs_postnet = mel_outputs + postnet_residual(model.postnet,
                                                         mel_outputs)
    return mel_outputs_postnet, mel_lengths, alignments
