"""Tacotron 2 inference, plain PyTorch: character embedding, three
convolutions with batch norm, a bidirectional LSTM over each row's valid
length, the static speaker vector concatenated, the autoregressive
decoder (prenet with its dropout always on, attention LSTM, forward
attention with the transition agent or location-sensitive attention,
decoder LSTM, mel projection and gate) run to its step cap, and the
postnet residual.

Weights are a ``state_dict`` under the published checkpoint's keys.
Padded text positions are zeroed before and between the convolutions and
the attention energies are masked past each row's length, so that a row
gives what it gives alone.  ``prec`` (``precision.Precision``) rounds
the operands of every product; the location convolution, the energies'
read-out, the softmax and the recurrent state stay float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .precision import Precision

MASK_VALUE = -1e30


def _linear(p: Precision, x, w, b=None, round_x: bool = True):
    y = (p.x(x) if round_x else x) @ p.w(w).T
    return y if b is None else y + b


def _conv1d(p: Precision, x, w, b=None, padding=0, dilation=1):
    return F.conv1d(p.x(x), p.w(w), b, padding=padding, dilation=dilation)


def _bn(sd, name, x, eps=1e-5):
    shape = (1, -1, 1)
    y = (x - sd[f"{name}.running_mean"].reshape(shape)) * torch.rsqrt(
        sd[f"{name}.running_var"].reshape(shape) + eps)
    return y * sd[f"{name}.weight"].reshape(shape) + sd[
        f"{name}.bias"].reshape(shape)


def _lstm_gates(p: Precision, x, h, w_ih, w_hh, b):
    return _linear(p, x, w_ih) + _linear(p, h, w_hh) + b


def _lstm_update(gates, c):
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def _bilstm(p: Precision, sd, x, lengths):
    """(B, T, D) → (B, T, 2H), each direction over the row's valid
    steps only, zeros at padded positions."""
    B, T, _ = x.shape
    valid = (torch.arange(T, device=x.device)[None, :]
             < lengths[:, None]).to(x.dtype)
    outs = []
    for suffix, steps in (("", range(T)), ("_reverse", range(T - 1, -1, -1))):
        w_ih = sd[f"encoder.lstm.weight_ih_l0{suffix}"]
        w_hh = sd[f"encoder.lstm.weight_hh_l0{suffix}"]
        b = (sd[f"encoder.lstm.bias_ih_l0{suffix}"]
             + sd[f"encoder.lstm.bias_hh_l0{suffix}"])
        H = w_hh.shape[1]
        x_proj = _linear(p, x, w_ih) + b
        h = c = x.new_zeros(B, H)
        out = [None] * T
        for t in steps:
            h_new, c_new = _lstm_update(x_proj[:, t] + _linear(p, h, w_hh), c)
            v = valid[:, t, None]
            h = v * h_new + (1.0 - v) * h
            c = v * c_new + (1.0 - v) * c
            out[t] = h_new * v
        outs.append(torch.stack(out, dim=1))
    return torch.cat(outs, dim=-1)


def encode(p: Precision, sd, model: dict, ids, lengths, spk):
    """(B, T) ids, (B,) lengths, (B, D_spk) speaker vectors → (B, T, E)."""
    x = sd["embedding.weight"][ids].transpose(1, 2)          # (B, C, T)
    T = x.shape[-1]
    valid = (torch.arange(T, device=x.device)[None, :]
             < lengths[:, None])[:, None, :]
    x = torch.where(valid, x, 0.0)
    k = model["encoder_kernel_size"]
    for i in range(model["encoder_n_convolutions"]):
        x = _conv1d(p, x, sd[f"encoder.convolutions.{i}.0.conv.weight"],
                    sd[f"encoder.convolutions.{i}.0.conv.bias"],
                    padding=(k - 1) // 2)
        x = torch.relu(_bn(sd, f"encoder.convolutions.{i}.1", x))
        x = torch.where(valid, x, 0.0)
    enc = _bilstm(p, sd, x.transpose(1, 2), lengths)
    spk = spk[:, None, :].expand(-1, T, -1)
    return torch.cat([enc, spk], dim=-1)


def decode(p: Precision, sd, model: dict, enc, lengths, pre_masks):
    """The autoregressive loop over ``max_decoder_steps`` steps with the
    (S, 2, B, P) 0/1 prenet masks.  Returns mels (B, n_mel, S·r) and the
    rows' lengths in steps (counted by the gate, as served)."""
    ap = model["attention_params"]
    lsa = ap["attention_type"] == "LSA"
    B, T, E = enc.shape
    S = model["max_decoder_steps"]
    r = model["n_frames_per_step"]
    n_mel = model["n_mel_channels"]
    keep = 1.0 - model.get("p_prenet_dropout", 0.5)
    H, Hd = model["attention_rnn_dim"], model["decoder_rnn_dim"]
    dev = enc.device
    mask = torch.arange(T, device=dev)[None, :] < lengths[:, None]
    A = "decoder.attention_layer."
    processed = _linear(p, enc, sd[A + ("memory_layer" if lsa else
                                        "inputs_layer") + ".linear_layer.weight"])
    conv_w = sd[A + ("location_layer.location_conv.conv.weight" if lsa
                     else "location_layer.location_conv1d.weight")]
    pad = (conv_w.shape[-1] - 1) // 2
    b_att = sd["decoder.attention_rnn.bias_ih"] + sd["decoder.attention_rnn.bias_hh"]
    b_dec = sd["decoder.decoder_rnn.bias_ih"] + sd["decoder.decoder_rnn.bias_hh"]
    v_b = None if lsa else sd[A + "v.linear_layer.bias"]

    x_in = enc.new_zeros(B, n_mel * r)
    ah = ac = enc.new_zeros(B, H)
    dh = dc = enc.new_zeros(B, Hd)
    ctx = enc.new_zeros(B, E)
    w_prev = enc.new_zeros(B, T)
    w_cum = enc.new_zeros(B, T)
    alpha = torch.full((B, T), 1e-7, device=dev)
    alpha[:, 0] = 1.0
    u = torch.full((B, 1), 0.5, device=dev)
    not_finished = torch.ones(B, dtype=torch.int32, device=dev)
    mel_len = torch.zeros(B, dtype=torch.int32, device=dev)
    mels = []
    for t in range(S):
        h = x_in
        for i in range(2):
            h = torch.relu(_linear(p, h, sd[f"decoder.prenet.layers.{i}."
                                            "linear_layer.weight"]))
            h = h / keep * pre_masks[t, i]
        ah, ac = _lstm_update(_lstm_gates(
            p, torch.cat([h, ctx], -1), ah, sd["decoder.attention_rnn.weight_ih"],
            sd["decoder.attention_rnn.weight_hh"], b_att), ac)
        q = _linear(p, ah, sd[A + "query_layer.linear_layer.weight"])
        loc = F.conv1d(torch.stack([w_prev, w_cum], 1), p.w(conv_w),
                       padding=pad)
        loc = _linear(p, loc.transpose(1, 2),
                      sd[A + "location_layer.location_dense.linear_layer.weight"])
        e = _linear(p, torch.tanh(q[:, None, :] + loc + processed),
                    sd[A + "v.linear_layer.weight"], v_b, round_x=False)[..., 0]
        e = torch.where(mask, e, MASK_VALUE)
        align = torch.softmax(e, dim=-1)
        w_cum = w_cum + align
        if not lsa:
            shifted = F.pad(alpha[:, :-1], (1, 0))
            alpha = ((1.0 - u) * alpha + u * shifted + 1e-8) * align
            align = alpha = alpha / alpha.sum(dim=1, keepdim=True)
        w_prev = align
        ctx = torch.einsum("bt,bte->be", align, enc)
        if not lsa:
            u = torch.sigmoid(_linear(p, torch.cat([ctx, ah], -1),
                                      sd[A + "ta.weight"], sd[A + "ta.bias"]))
        dh, dc = _lstm_update(_lstm_gates(
            p, torch.cat([ah, ctx], -1), dh, sd["decoder.decoder_rnn.weight_ih"],
            sd["decoder.decoder_rnn.weight_hh"], b_dec), dc)
        dctx = torch.cat([dh, ctx], -1)
        x_in = _linear(p, dctx, sd["decoder.linear_projection.linear_layer.weight"],
                       sd["decoder.linear_projection.linear_layer.bias"])
        gate = _linear(p, dctx, sd["decoder.gate_layer.linear_layer.weight"],
                       sd["decoder.gate_layer.linear_layer.bias"])[:, 0]
        not_finished = not_finished * (torch.sigmoid(gate)
                                       <= model["gate_threshold"]).int()
        mel_len = mel_len + not_finished
        mels.append(x_in)
    mel = torch.stack(mels, 1).reshape(B, S * r, n_mel).transpose(1, 2)
    return mel, mel_len


def postnet(p: Precision, sd, model: dict, mel):
    """The postnet's residual added to the mel."""
    n = model["postnet_n_convolutions"]
    k = model["postnet_kernel_size"]
    x = mel
    for i in range(n):
        x = _conv1d(p, x, sd[f"postnet.convolutions.{i}.0.conv.weight"],
                    sd[f"postnet.convolutions.{i}.0.conv.bias"],
                    padding=(k - 1) // 2)
        x = _bn(sd, f"postnet.convolutions.{i}.1", x)
        if i < n - 1:
            x = torch.tanh(x)
    return mel + x


def synthesize_mels(p: Precision, sd, model: dict, ids: list, spk, pre_masks):
    """Phoneme-id lists → the postnet's mels (B, n_mel, S·r) trimmed to
    the longest row's length, and each row's length in frames."""
    dev = spk.device
    sd = p.params(sd)
    spk = p.vec(spk)
    T = max(len(s) for s in ids)
    inp = torch.zeros(len(ids), T, dtype=torch.int64, device=dev)
    for i, s in enumerate(ids):
        inp[i, : len(s)] = torch.as_tensor(s, device=dev)
    lengths = torch.as_tensor([len(s) for s in ids], device=dev)
    enc = encode(p, sd, model, inp, lengths, spk)
    mel, mel_len = decode(p, sd, model, enc, lengths, pre_masks)
    frames = (mel_len.clamp(min=1) * model["n_frames_per_step"]).tolist()
    return postnet(p, sd, model, mel), frames
