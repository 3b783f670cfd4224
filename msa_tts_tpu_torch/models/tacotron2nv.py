"""Speaker-conditioned Tacotron-2 acoustic model (counterpart of
``msa_tts_tpu/models/tacotron2nv.py``): the teacher-forced training
forward and autoregressive synthesis.

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
from ..ops.masking import sequence_mask
from ..utils.backend import resolve_kernel_backend
from ..utils.profiling import annotate
from .cuda_decoder import check_supported, cuda_decoder_infer
from .decoder import (
    Decoder,
    DecoderConfig,
    Postnet,
    POSTNET_DROPOUT,
    decoder_forward,
    decoder_infer,
    postnet_apply,
    postnet_forward,
)
from .encoder import DROPOUT as ENC_DROPOUT
from .encoder import Encoder, encoder_forward


class ModelConfig(NamedTuple):
    """Static model hyperparameters (the reference's ``params["model"]``
    vocabulary)."""

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
    freeze_charemb: bool = False
    freeze_encoder: bool = False
    freeze_decoder: bool = False
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
        freeze_charemb=p.get("freeze_charemb", False),
        freeze_encoder=p.get("freeze_encoder", False),
        freeze_decoder=p.get("freeze_decoder", False),
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

    def forward(self, inputs, input_lengths, melspecs, melspec_lengths,
                speaker_vecs, masks):
        """The training forward, :func:`tacotron2nv_forward` on this
        model's config; ``torch.func.functional_call`` runs it on a
        dictionary of parameters and buffers."""
        return tacotron2nv_forward(self, self.cfg, inputs, input_lengths,
                                   melspecs, melspec_lengths, speaker_vecs,
                                   masks)


def _encode(model: Tacotron2NV, cfg: ModelConfig, inputs, input_lengths,
            speaker_vecs, *, mask_pad: bool = False):
    """Embedding → encoder → speaker conditioning, (B, T, E_cond).

    ``mask_pad`` makes the encoder output at valid positions independent
    of the padded length (see encoder.py:encoder_apply) — used by the
    serving paths.  Everything runs at the model's parameter type (the
    speaker vector is cast to it)."""
    return _encode_conditioned(model, cfg, inputs, input_lengths,
                               speaker_vecs, mask_pad=mask_pad)[0]


def _encode_conditioned(model, cfg, inputs, input_lengths, speaker_vecs, *,
                        mask_pad=False, masks=None):
    """:func:`_encode`, or with ``masks`` (the encoder's dropout masks)
    its training mode; returns ``(enc_cond, the encoder's new batch-norm
    state)``."""
    if speaker_vecs.is_floating_point():
        speaker_vecs = speaker_vecs.to(model.embedding.weight.dtype)
    emb = N.embedding_of(model.embedding, inputs)              # (B, T, D)
    if cfg.freeze_charemb:
        emb = emb.detach()
    enc_out, enc_state = encoder_forward(
        model.encoder, emb.transpose(1, 2), input_lengths, masks,
        mask_pad=mask_pad)
    if cfg.use_residual_encoder:
        enc_out = enc_out + emb
    if cfg.freeze_encoder:
        enc_out = enc_out.detach()
    if cfg.speaker_emb_type == "learnable_lookup":
        spk = N.embedding_of(model.speaker_embedder, speaker_vecs)
    elif cfg.speaker_emb_type == "static":
        spk = speaker_vecs
    elif cfg.speaker_emb_type == "static+linear":
        spk = N.linear_of(model.speaker_lin, speaker_vecs)
    else:
        raise ValueError(cfg.speaker_emb_type)
    spk = spk[:, None, :].expand(-1, enc_out.shape[1], -1)
    return torch.cat([enc_out, spk.to(enc_out.dtype)], dim=-1), enc_state


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
    with annotate("tts.encode"):
        enc_cond = _encode(model, cfg, inputs, input_lengths, speaker_vecs,
                           mask_pad=mask_pad)
    dcfg = cfg.decoder_config()
    decode = decoder_infer
    if resolve_kernel_backend(decode_backend, enc_cond.device) == "cuda":
        check_supported(dcfg)
        decode = cuda_decoder_infer
    with annotate("tts.decode"):
        mel_outputs, _gates, alignments, mel_lengths, _n = decode(
            model.decoder, dcfg, enc_cond.contiguous(), input_lengths,
            pre_masks,
        )
    with annotate("tts.postnet"):
        mel_outputs_postnet = mel_outputs + postnet_residual(model.postnet,
                                                             mel_outputs)
    return mel_outputs_postnet, mel_lengths, alignments


# --------------------------------------------------------------------------
# Training
# --------------------------------------------------------------------------

def dropout_masks(cfg: ModelConfig, B: int, T_in: int, T_mel: int,
                  generator: torch.Generator, *, device) -> dict:
    """Raw 0/1 dropout masks for one training forward on a (B, T_in)
    text batch with (B, n_mel, T_mel) targets, drawn on ``generator``'s
    device: ``"encoder"`` one (B, C, T_in) per convolution,
    ``"prenet"`` (T_dec, 2, B, P), ``"attention"`` and ``"decoder"``
    (T_dec, B, H), ``"postnet"`` one (B, C_i, T_mel) per layer."""
    T_dec = T_mel // cfg.n_frames_per_step

    def draw(rate, *shape):
        u = torch.rand(shape, generator=generator, device=generator.device)
        return (u < 1.0 - rate).to(device, torch.float32)

    E, M = cfg.encoder_embedding_dim, cfg.postnet_embedding_dim
    n_post = cfg.postnet_n_convolutions
    return {
        "encoder": [draw(ENC_DROPOUT, B, E, T_in)
                    for _ in range(cfg.encoder_n_convolutions)],
        "prenet": draw(cfg.p_prenet_dropout, T_dec, 2, B, cfg.prenet_dim),
        "attention": draw(cfg.p_attention_dropout, T_dec, B,
                          cfg.attention_rnn_dim),
        "decoder": draw(cfg.p_decoder_dropout, T_dec, B,
                        cfg.decoder_rnn_dim),
        "postnet": [draw(POSTNET_DROPOUT, B,
                         cfg.n_mel_channels if i == n_post - 1 else M, T_mel)
                    for i in range(n_post)],
    }


def mask_rows(masks: dict | None, rows: slice) -> dict | None:
    """``masks`` (as :func:`dropout_masks` draws them) cut to the batch
    rows ``rows``: the batch axis is the first of the encoder's and the
    postnet's, the third of the prenet's, the second of the rest."""
    if masks is None:
        return None
    return {
        "encoder": [m[rows] for m in masks["encoder"]],
        "prenet": masks["prenet"][:, :, rows],
        "attention": masks["attention"][:, rows],
        "decoder": masks["decoder"][:, rows],
        "postnet": [m[rows] for m in masks["postnet"]],
    }


def parse_output(cfg: ModelConfig, outputs, output_lengths):
    """Zero the mel outputs and fill the gate energies with 1e3 at padded
    frames (with ``mask_padding``, as the reference does)."""
    if not cfg.mask_padding or output_lengths is None:
        return outputs
    mel_outputs, mel_outputs_postnet, gate_outputs, alignments = outputs
    valid = sequence_mask(output_lengths, mel_outputs.shape[2])  # (B, T)
    return [torch.where(valid[:, None, :], mel_outputs, 0.0),
            torch.where(valid[:, None, :], mel_outputs_postnet, 0.0),
            torch.where(valid, gate_outputs, 1e3),
            alignments]


def bn_names(cfg: ModelConfig) -> list[str]:
    """The batch norms in the order :func:`tacotron2nv_forward` returns
    their new state: the encoder's, then the postnet's."""
    return ([f"encoder.convolutions.{i}.1"
             for i in range(cfg.encoder_n_convolutions)]
            + [f"postnet.convolutions.{i}.1"
               for i in range(cfg.postnet_n_convolutions)])


def tacotron2nv_forward(model: Tacotron2NV, cfg: ModelConfig, inputs,
                        input_lengths, melspecs, melspec_lengths,
                        speaker_vecs, masks):
    """Teacher-forced forward pass in training mode, with autograd.

    ``masks``: one pass's dropout masks (:func:`dropout_masks`).  The
    ``freeze_*`` flags detach the character embedding, the encoder
    output or the decoder outputs.  Returns ``([mel_outputs,
    mel_outputs_postnet, gate_outputs, alignments], new_state)``, mels
    (B, n_mel, T_mel), ``new_state`` the batch norms' new running
    statistics under their ``state_dict`` names (the model's buffers are
    not written)."""
    enc_cond, enc_state = _encode_conditioned(
        model, cfg, inputs, input_lengths, speaker_vecs,
        masks=masks["encoder"])
    mel_outputs, gate_outputs, alignments = decoder_forward(
        model.decoder, cfg.decoder_config(), enc_cond, melspecs,
        input_lengths, masks)
    if cfg.freeze_decoder:
        mel_outputs = mel_outputs.detach()
        gate_outputs = gate_outputs.detach()
        alignments = alignments.detach()
    post_res, post_state = postnet_forward(model.postnet, mel_outputs,
                                           masks["postnet"])
    outputs = parse_output(
        cfg, [mel_outputs, mel_outputs + post_res, gate_outputs, alignments],
        melspec_lengths)
    new_state = {}
    for name, (mean, var) in zip(bn_names(cfg), enc_state + post_state):
        new_state[f"{name}.running_mean"] = mean
        new_state[f"{name}.running_var"] = var
    return outputs, new_state
