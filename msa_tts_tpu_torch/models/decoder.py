"""Tacotron-2 autoregressive decoder, inference path (counterpart of
``msa_tts_tpu/models/decoder.py``).

``decoder_infer`` here is the plain PyTorch version of the whole-loop
CUDA kernel in ``cuda_decoder.py``: a Python loop over decoder steps
with the same gate-threshold early exit.  The prenet's dropout is always
on, as in the reference; its 0/1 masks are an input (``pre_masks``,
(S, 2, B, P)) so that the kernel, this loop and the JAX package can be
fed the same noise.

A decoder whose parameters are bfloat16 decodes with the kernel's
roundings (the JAX kernel's ``_dot``): the input vector of every matrix
product (prenet layers, both LSTMs, query, location dense, transition
agent, projection and gate) is rounded to bfloat16, products of bfloat16
values are summed in float32, each LSTM's two biases are summed at
bfloat16, and the state, the location convolution, the energies, the
normalisation and the outputs stay float32.  On one device the kernel
then differs from this loop by summation order only.
"""

from __future__ import annotations

import copy
import weakref
from functools import partial
from typing import NamedTuple

import torch
from torch import nn

from ..ops import nn as N
from ..ops import rnn as R
from ..ops.masking import sequence_mask
from . import attention as ATT


class DecoderConfig(NamedTuple):
    n_mel_channels: int
    n_frames_per_step: int
    encoder_embedding_dim: int
    attention_rnn_dim: int
    decoder_rnn_dim: int
    prenet_dim: int
    max_decoder_steps: int
    gate_threshold: float
    p_attention_dropout: float
    p_decoder_dropout: float
    early_stopping: bool
    attention_params: dict
    p_prenet_dropout: float = 0.5


POSTNET_DROPOUT = 0.5  # fixed, as in the reference

# --------------------------------------------------------------------------
# Prenet and postnet
# --------------------------------------------------------------------------

class Prenet(nn.Module):
    def __init__(self, in_dim: int, sizes, *, generator=None):
        super().__init__()
        in_sizes = [in_dim] + list(sizes[:-1])
        self.layers = nn.ModuleList(
            N.LinearNorm(i, o, bias=False, generator=generator)
            for i, o in zip(in_sizes, sizes)
        )


def _same(x):
    return x


def _round_bf16(x):
    """``x`` as a bfloat16 product sees it, kept in float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def prenet_apply(prenet: Prenet, x, masks, keep: float, rnd=_same):
    """Prenet with injected dropout masks ``masks`` (n_layers, B, P) of
    raw 0/1 floats: ``(relu(W x) / keep) · mask`` per layer.  Never
    premultiply the mask by ``1/keep``: for a keep such as 0.7 that is
    an ulp off, and the error compounds through the AR feedback.
    ``rnd`` rounds each layer's input (see :func:`compute_view`)."""
    for i, layer in enumerate(prenet.layers):
        # the 0/1 mask in x's type: a bfloat16 pass stays bfloat16
        x = torch.relu(layer(rnd(x))) / keep * masks[i].to(x.dtype)
    return x


class Postnet(nn.Module):
    def __init__(self, n_mel_channels: int, embedding_dim: int,
                 kernel_size: int, n_convolutions: int, *, generator=None):
        super().__init__()
        self.kernel_size = kernel_size
        convs = []
        for i in range(n_convolutions):
            in_ch = n_mel_channels if i == 0 else embedding_dim
            last = i == n_convolutions - 1
            out_ch = n_mel_channels if last else embedding_dim
            convs.append(nn.Sequential(
                N.ConvNorm(in_ch, out_ch, kernel_size, bias=True,
                           w_init_gain="linear" if last else "tanh",
                           generator=generator),
                nn.BatchNorm1d(out_ch),
            ))
        self.convolutions = nn.ModuleList(convs)


def postnet_apply(postnet: Postnet, x, *, width: int | None = None):
    """Eval-mode postnet on (B, n_mel, T): conv → BN → tanh (except the
    last layer).

    ``width`` makes the stack behave as if the input were only ``width``
    frames wide inside the T-frame buffer: every column at or past
    ``width`` is zeroed before EVERY conv (past the first layer BN turns
    them non-zero, so one mask up front is not enough).  Columns below
    ``width`` of the result then equal the postnet of ``x[..., :width]``;
    the streaming path runs each window at one padded width this way."""
    return postnet_forward(postnet, x, width=width)[0]


def postnet_forward(postnet: Postnet, x, masks=None, *, width=None):
    """:func:`postnet_apply` returning ``(y, new_state)``.  With
    ``masks`` (``masks[i]`` a raw 0/1 mask of layer i's output shape) it
    runs in training mode: batch norms on the batch's statistics,
    dropout at rate 0.5 after every layer (the last included), and
    ``new_state`` holds one ``(running_mean, running_var)`` per layer
    (empty in eval mode)."""
    n = len(postnet.convolutions)
    pad = (postnet.kernel_size - 1) // 2
    valid = (None if width is None
             else torch.arange(x.shape[-1], device=x.device) < width)
    new_state = []
    for i, conv_bn in enumerate(postnet.convolutions):
        if valid is not None:
            x = torch.where(valid, x, 0.0)
        conv = conv_bn[0].conv
        x = N.conv1d_of(conv, x, padding=pad)
        if masks is None:
            x = N.batchnorm1d(conv_bn[1], x)
        else:
            x, bn_state = N.batchnorm1d_train(conv_bn[1], x)
            new_state.append(bn_state)
        if i < n - 1:
            x = torch.tanh(x)
        if masks is not None:
            x = N.dropout(x, masks[i], POSTNET_DROPOUT)
    return x, new_state


# --------------------------------------------------------------------------
# Decoder
# --------------------------------------------------------------------------

class Decoder(nn.Module):
    def __init__(self, cfg: DecoderConfig, *, generator=None):
        super().__init__()
        ap = cfg.attention_params
        E, H, Hd, P = (
            cfg.encoder_embedding_dim, cfg.attention_rnn_dim,
            cfg.decoder_rnn_dim, cfg.prenet_dim,
        )
        MR = cfg.n_mel_channels * cfg.n_frames_per_step
        self.prenet = Prenet(MR, [P, P], generator=generator)
        self.attention_rnn = nn.LSTMCell(P + E, H)
        if ap["attention_type"] == "ForwardAttention":
            self.attention_layer = ATT.ForwardAttention(
                H, E, ap["attention_dim"],
                location_attention=ap.get("location_attention", True),
                attention_location_n_filters=ap[
                    "attention_location_n_filters"],
                attention_location_kernel_size=ap[
                    "attention_location_kernel_size"],
                trans_agent=ap.get("trans_agent", True),
                generator=generator,
            )
        elif ap["attention_type"] == "LSA":
            self.attention_layer = ATT.LSA(
                H, E, ap["attention_dim"],
                ap["attention_location_n_filters"],
                ap["attention_location_kernel_size"],
                generator=generator,
            )
        else:
            raise ValueError(
                f"attention type {ap['attention_type']} not defined"
            )
        self.decoder_rnn = nn.LSTMCell(H + E, Hd)
        self.linear_projection = N.LinearNorm(Hd + E, MR,
                                              generator=generator)
        self.gate_layer = N.LinearNorm(Hd + E, 1, bias=True,
                                       w_init_gain="sigmoid",
                                       generator=generator)
        if generator is not None:
            R.init_lstm_(self.attention_rnn, generator)
            R.init_lstm_(self.decoder_rnn, generator)


class DecoderCarry(NamedTuple):
    attention_hidden: torch.Tensor
    attention_cell: torch.Tensor
    decoder_hidden: torch.Tensor
    decoder_cell: torch.Tensor
    attention_context: torch.Tensor
    attn_state: ATT.AttnState


def _init_carry(cfg: DecoderConfig, batch: int, t_in: int, *, device,
                dtype=torch.float32):
    def z(n):
        return torch.zeros(batch, n, dtype=dtype, device=device)

    return DecoderCarry(
        attention_hidden=z(cfg.attention_rnn_dim),
        attention_cell=z(cfg.attention_rnn_dim),
        decoder_hidden=z(cfg.decoder_rnn_dim),
        decoder_cell=z(cfg.decoder_rnn_dim),
        attention_context=z(cfg.encoder_embedding_dim),
        attn_state=ATT.init_attn_state(batch, t_in, device=device,
                                       dtype=dtype),
    )


def decoder_dtype(decoder: Decoder) -> torch.dtype:
    """The type a decoder computes its products at: its parameters'."""
    return decoder.attention_rnn.weight_ih.dtype


def params_key(decoder: Decoder) -> tuple:
    """Changes when a parameter of ``decoder`` gets new storage or
    another type (as after ``.to()``) or is written in place (its version
    counter moves, as in ``load_state_dict``); a write through ``.data``
    is not seen."""
    return tuple((p.data_ptr(), p._version, p.dtype)
                 for p in decoder.parameters())


# bfloat16 decoder -> (params_key, its float32 view): see compute_view
_VIEWS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


@torch.no_grad()
def compute_view(decoder: Decoder):
    """``(decoder, rnd)`` to run the step with.  A float32 decoder runs
    as it is, ``rnd`` the identity.  A bfloat16 decoder runs as a
    float32 copy of its (bfloat16) values with ``rnd`` rounding to
    bfloat16, applied to the input of every matrix product: float32
    products of bfloat16 values are exact, so this is a bfloat16 product
    with float32 accumulation.  In the copy each LSTM's ``bias_ih`` holds
    the two biases' bfloat16 sum and ``bias_hh`` zeros.  The copy is kept
    per decoder and made again when a parameter changes
    (:func:`params_key`).  Under ``parallel.tp.tp_products`` the
    decoder runs as it is: the partitioned products take its bfloat16
    shards into float32 products (an LSTM's two biases are added one
    after the other in float32, not summed at bfloat16 first)."""
    if decoder_dtype(decoder) != torch.bfloat16:
        return decoder, _same
    if N.tp_active() is not None:
        return decoder, _round_bf16
    key = params_key(decoder)
    hit = _VIEWS.get(decoder)
    if hit is None or hit[0] != key:
        view = copy.deepcopy(decoder).float()
        for name in ("attention_rnn", "decoder_rnn"):
            cell, own = getattr(view, name), getattr(decoder, name)
            cell.bias_ih.copy_(own.bias_ih + own.bias_hh)
            cell.bias_hh.zero_()
        hit = (key, view)
        _VIEWS[decoder] = hit
    return hit[1], _round_bf16


def attention_inputs(decoder: Decoder, cfg: DecoderConfig, encoder_outputs):
    """The attention's projection of the encoder outputs (B, T_in, A),
    computed once per utterance at the decoder's type and returned in
    float32 (as is for a float32 decoder)."""
    prep_fn, _ = _attn_fns(cfg)
    dt = decoder_dtype(decoder)
    return prep_fn(decoder.attention_layer,
                   encoder_outputs.to(dt)).to(torch.float32)


def _attn_fns(cfg: DecoderConfig, training: bool = False):
    """The attention's input projection and step; ``training`` turns off
    inference windowing and monotonic masking, as in the reference."""
    ap = cfg.attention_params
    if ap["attention_type"] == "ForwardAttention":
        def step(attn, query, inputs, processed, st, mask, rnd=_same):
            return ATT.forward_attention(
                attn, query, inputs, processed, st, mask, rnd=rnd,
                location_attention=ap.get("location_attention", True),
                windowing=ap.get("windowing", False),
                norm=ap.get("norm", "softmax"),
                forward_attn=ap.get("forward_attn", True),
                trans_agent=ap.get("trans_agent", True),
                forward_attn_mask=ap.get("forward_attn_mask", False),
                training=training,
                mask_energies=ap.get("mask_energies", False),
            )

        return ATT.preprocess_inputs, step
    return ATT.preprocess_inputs_lsa, ATT.lsa_attention


def _decode_step(decoder: Decoder, attn_step_fn, carry: DecoderCarry,
                 prenet_out, encoder_outputs, processed_inputs, mask,
                 rnd=_same, drop=(_same, _same)):
    """One decoder step.  ``rnd`` rounds the inputs of the matrix
    products (the LSTMs' x and h, the query, the projection's input);
    the cells' c never is.  ``drop``: the dropout applied to the
    attention LSTM's and the decoder LSTM's new h (none in eval mode);
    the carry keeps the dropped h, as in the reference."""
    attn_h, attn_c = R.lstm_cell(
        decoder.attention_rnn,
        rnd(torch.cat([prenet_out, carry.attention_context], dim=-1)),
        (rnd(carry.attention_hidden), carry.attention_cell),
    )
    attn_h = drop[0](attn_h)
    context, alignment, attn_state = attn_step_fn(
        decoder.attention_layer, attn_h, encoder_outputs,
        processed_inputs, carry.attn_state, mask, rnd=rnd,
    )
    dec_h, dec_c = R.lstm_cell(
        decoder.decoder_rnn,
        rnd(torch.cat([attn_h, context], dim=-1)),
        (rnd(carry.decoder_hidden), carry.decoder_cell),
    )
    dec_h = drop[1](dec_h)
    dec_h_ctx = rnd(torch.cat([dec_h, context], dim=-1))
    mel_out = decoder.linear_projection(dec_h_ctx)
    gate = decoder.gate_layer(dec_h_ctx)
    new_carry = DecoderCarry(
        attention_hidden=attn_h,
        attention_cell=attn_c,
        decoder_hidden=dec_h,
        decoder_cell=dec_c,
        attention_context=context,
        attn_state=attn_state,
    )
    return new_carry, (mel_out, gate, alignment)


def _infer_step(decoder: Decoder, cfg: DecoderConfig, attn_step_fn,
                encoder_outputs, processed_inputs, mask, step_masks, s,
                rnd=_same):
    """ONE autoregressive step on the state dict ``s`` (decoder_input,
    carry, not_finished, mel_lengths).  A row is finished once
    ``sigmoid(gate) <= gate_threshold`` is false; ``mel_lengths`` counts
    the steps after which it was still unfinished."""
    prenet_out = prenet_apply(
        decoder.prenet, s["decoder_input"], step_masks,
        1.0 - cfg.p_prenet_dropout, rnd,
    )
    new_carry, (mel_out, gate, alignment) = _decode_step(
        decoder, attn_step_fn, s["carry"], prenet_out,
        encoder_outputs, processed_inputs, mask, rnd,
    )
    dec = (torch.sigmoid(gate[:, 0]) <= cfg.gate_threshold).to(torch.int32)
    not_finished = s["not_finished"] * dec
    new_s = dict(
        decoder_input=mel_out,
        carry=new_carry,
        not_finished=not_finished,
        mel_lengths=s["mel_lengths"] + not_finished,
    )
    return new_s, (mel_out, gate[:, 0], alignment)


def _state_type(encoder_outputs):
    """Encoder outputs at the type of the state and the outputs: a
    bfloat16 tensor's values in float32, anything else as it is."""
    if encoder_outputs.dtype == torch.bfloat16:
        return encoder_outputs.to(torch.float32)
    return encoder_outputs


def parse_decoder_outputs(cfg: DecoderConfig, mels, gates, aligns):
    """Step-major buffers (S, B, MR) / (S, B) / (S, B, T_in) → the
    ``decoder_infer`` layout (B, n_mel, S·r) / (B, S·r) / (B, S, T_in)."""
    S, B, _ = mels.shape
    r = cfg.n_frames_per_step
    mel_outputs = mels.transpose(0, 1).reshape(B, S * r, cfg.n_mel_channels)
    gate_outputs = gates.transpose(0, 1).repeat_interleave(r, dim=1)
    return (mel_outputs.transpose(1, 2), gate_outputs,
            aligns.transpose(0, 1))


def decoder_forward(decoder: Decoder, cfg: DecoderConfig, encoder_outputs,
                    decoder_targets, input_lengths, masks):
    """Teacher-forced decoding in training mode, with autograd.

    Args:
      encoder_outputs: (B, T_in, E).
      decoder_targets: (B, n_mel, T_mel) ground-truth mels, T_mel a
        multiple of ``n_frames_per_step``.
      input_lengths: (B,) encoder valid lengths.
      masks: raw 0/1 dropout masks: ``"prenet"`` (T_dec, 2, B, P),
        ``"attention"`` (T_dec, B, attention_rnn_dim) and ``"decoder"``
        (T_dec, B, decoder_rnn_dim).

    The go frame and the targets shifted by one step run through the
    prenet all at once, then one Python loop runs the T_dec steps.
    Returns ``(mel_outputs (B, n_mel, T_mel), gate_outputs (B, T_mel),
    alignments (B, T_dec, T_in))``."""
    B, n_mel, T_mel = decoder_targets.shape
    r = cfg.n_frames_per_step
    T_dec, T_in = T_mel // r, encoder_outputs.shape[1]
    tgt = decoder_targets.transpose(1, 2).reshape(B, T_dec, n_mel * r)
    tgt = tgt.transpose(0, 1)                            # (T_dec, B, MR)
    dec_in = torch.cat([tgt.new_zeros(1, B, n_mel * r), tgt[:-1]])
    prenet_out = prenet_apply(decoder.prenet, dec_in,
                              masks["prenet"].transpose(0, 1),
                              1.0 - cfg.p_prenet_dropout)
    mask = sequence_mask(input_lengths, T_in)
    prep_fn, attn_step_fn = _attn_fns(cfg, training=True)
    processed_inputs = prep_fn(decoder.attention_layer, encoder_outputs)
    carry = _init_carry(cfg, B, T_in, device=encoder_outputs.device,
                        dtype=encoder_outputs.dtype)
    mels, gates, aligns = [], [], []
    for t in range(T_dec):
        drop = (
            partial(N.dropout, mask=masks["attention"][t],
                    rate=cfg.p_attention_dropout),
            partial(N.dropout, mask=masks["decoder"][t],
                    rate=cfg.p_decoder_dropout),
        )
        carry, (mel, gate, align) = _decode_step(
            decoder, attn_step_fn, carry, prenet_out[t], encoder_outputs,
            processed_inputs, mask, drop=drop,
        )
        mels.append(mel)
        gates.append(gate[:, 0])
        aligns.append(align)
    return parse_decoder_outputs(cfg, torch.stack(mels), torch.stack(gates),
                                 torch.stack(aligns))


@torch.no_grad()
def decoder_infer(decoder: Decoder, cfg: DecoderConfig, encoder_outputs,
                  input_lengths, pre_masks):
    """Autoregressive inference with gate-threshold early stopping.

    ``pre_masks``: (S, 2, B, P) raw 0/1 prenet dropout masks, S =
    ``max_decoder_steps``.  Returns ``(mel_outputs (B, n_mel, S·r),
    gate_outputs (B, S·r), alignments (B, S, T_in), mel_lengths (B,)
    int32, n_steps)``; buffers past the last step run hold zeros (gates
    1e3)."""
    B, T_in, _ = encoder_outputs.shape
    S = cfg.max_decoder_steps
    MR = cfg.n_mel_channels * cfg.n_frames_per_step
    mask = sequence_mask(input_lengths, T_in)
    _, attn_step_fn = _attn_fns(cfg)
    processed_inputs = attention_inputs(decoder, cfg, encoder_outputs)
    encoder_outputs = _state_type(encoder_outputs)
    device, dtype = encoder_outputs.device, encoder_outputs.dtype
    decoder, rnd = compute_view(decoder)

    mels = torch.zeros(S, B, MR, dtype=dtype, device=device)
    gates = torch.full((S, B), 1e3, dtype=dtype, device=device)
    aligns = torch.zeros(S, B, T_in, dtype=dtype, device=device)
    s = dict(
        decoder_input=torch.zeros(B, MR, dtype=dtype, device=device),
        carry=_init_carry(cfg, B, T_in, device=device, dtype=dtype),
        not_finished=torch.ones(B, dtype=torch.int32, device=device),
        mel_lengths=torch.zeros(B, dtype=torch.int32, device=device),
    )
    t = 0
    while t < S:
        if cfg.early_stopping and int(s["not_finished"].sum()) == 0:
            break
        s, (mels[t], gates[t], aligns[t]) = _infer_step(
            decoder, cfg, attn_step_fn, encoder_outputs,
            processed_inputs, mask, pre_masks[t], s, rnd,
        )
        t += 1
    return (*parse_decoder_outputs(cfg, mels, gates, aligns),
            s["mel_lengths"],
            torch.tensor(t, dtype=torch.int32, device=device))


# --------------------------------------------------------------------------
# Streaming (segmented) inference
# --------------------------------------------------------------------------

def decoder_stream_init(cfg: DecoderConfig, batch: int, t_in: int, *,
                        device, dtype=torch.float32) -> dict:
    """Initial carried state for segmented decoding: what
    ``decoder_infer``'s loop carries, plus the absolute ``step``."""
    return dict(
        step=torch.zeros((), dtype=torch.int32, device=device),
        decoder_input=torch.zeros(
            batch, cfg.n_mel_channels * cfg.n_frames_per_step,
            dtype=dtype, device=device,
        ),
        carry=_init_carry(cfg, batch, t_in, device=device, dtype=dtype),
        not_finished=torch.ones(batch, dtype=torch.int32, device=device),
        mel_lengths=torch.zeros(batch, dtype=torch.int32, device=device),
    )


@torch.no_grad()
def decoder_infer_segment(decoder: Decoder, cfg: DecoderConfig,
                          encoder_outputs, input_lengths, pre_masks,
                          state: dict, n_seg: int):
    """Run ``n_seg`` steps from ``state``, with no early exit: rows past
    their gate keep computing, and the caller stops asking for segments.
    The plain PyTorch version of the CUDA segment kernel
    (``cuda_decoder.cuda_decoder_segment``).

    ``pre_masks``: (n_seg, 2, B, P) raw 0/1 prenet masks for the
    segment's steps.  Returns ``(new_state, mels (B, n_mel, n_seg·r),
    gates (B, n_seg), alignments (B, n_seg, T_in))``.  Chained segments
    run the same ops as ``decoder_infer`` and reproduce it exactly."""
    B, T_in, _ = encoder_outputs.shape
    MR = cfg.n_mel_channels * cfg.n_frames_per_step
    mask = sequence_mask(input_lengths, T_in)
    _, attn_step_fn = _attn_fns(cfg)
    processed_inputs = attention_inputs(decoder, cfg, encoder_outputs)
    encoder_outputs = _state_type(encoder_outputs)
    device, dtype = encoder_outputs.device, encoder_outputs.dtype
    decoder, rnd = compute_view(decoder)

    mels = torch.zeros(n_seg, B, MR, dtype=dtype, device=device)
    gates = torch.zeros(n_seg, B, dtype=dtype, device=device)
    aligns = torch.zeros(n_seg, B, T_in, dtype=dtype, device=device)
    s = {k: state[k] for k in
         ("decoder_input", "carry", "not_finished", "mel_lengths")}
    for t in range(n_seg):
        s, (mels[t], gates[t], aligns[t]) = _infer_step(
            decoder, cfg, attn_step_fn, encoder_outputs,
            processed_inputs, mask, pre_masks[t], s, rnd,
        )
    s["step"] = state["step"] + n_seg
    mel_outputs, _, alignments = parse_decoder_outputs(cfg, mels, gates,
                                                       aligns)
    return s, mel_outputs, gates.transpose(0, 1), alignments
