"""Random weights for a configuration, made on the device from the seed.

Every leaf of the three models (the Tacotron-2 acoustic model, WaveRNN,
HiFi-GAN) is listed here from the configuration's sizes, under the
published checkpoints' ``state_dict`` keys, with the distribution it is
drawn from: uniform in [lo, hi), scaled by the leaf's fan-in as the
published initialisers scale it.  All leaves of a model come from one
``torch.rand`` call on a generator on the device, cut into views; a leaf
that a configuration fixes (a mean filter, the gate's bias) is a
constant.  The served system and the reference get the same tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from reference.g2p import N_SYMBOLS


def model_params(cfg: dict) -> dict:
    """The configuration's ``model`` with the sizes it takes from
    elsewhere: the mel channels (``audio_params``) and the vocabulary."""
    return {**cfg["model"], "n_mel_channels": cfg["audio_params"]["n_mels"],
            "n_symbols": N_SYMBOLS}


def _xavier(fan_in: int, fan_out: int, gain: float = 1.0):
    a = gain * math.sqrt(6.0 / (fan_in + fan_out))
    return (-a, a)


def _bn(spec: dict, name: str, n: int) -> None:
    spec[f"{name}.weight"] = ((n,), (0.5, 1.5))
    spec[f"{name}.bias"] = ((n,), (-0.1, 0.1))
    spec[f"{name}.running_mean"] = ((n,), (-0.1, 0.1))
    spec[f"{name}.running_var"] = ((n,), (0.5, 1.5))
    spec[f"{name}.num_batches_tracked"] = ((), 0)


def _lstm(spec, name, n_in, H, suffix=""):
    u = (-1.0 / math.sqrt(H), 1.0 / math.sqrt(H))
    spec[f"{name}.weight_ih{suffix}"] = ((4 * H, n_in), u)
    spec[f"{name}.weight_hh{suffix}"] = ((4 * H, H), u)
    spec[f"{name}.bias_ih{suffix}"] = ((4 * H,), u)
    spec[f"{name}.bias_hh{suffix}"] = ((4 * H,), u)


def tacotron_spec(model: dict, gate_bias: float) -> dict:
    """name → (shape, (lo, hi) or a constant) for the acoustic model with
    a static speaker vector."""
    g_relu, g_tanh = math.sqrt(2.0), 5.0 / 3.0
    D = model["symbols_embedding_dim"]
    C = model["encoder_embedding_dim"]
    k = model["encoder_kernel_size"]
    E = C + model["speaker_embedding_dim"]
    H, Hd, P = (model["attention_rnn_dim"], model["decoder_rnn_dim"],
                model["prenet_dim"])
    MR = model["n_mel_channels"] * model["n_frames_per_step"]
    ap = model["attention_params"]
    A, nf, lk = (ap["attention_dim"], ap["attention_location_n_filters"],
                 ap["attention_location_kernel_size"])
    s = {}
    a = math.sqrt(3.0) * math.sqrt(2.0 / (N_SYMBOLS + D))
    s["embedding.weight"] = ((N_SYMBOLS, D), (-a, a))
    for i in range(model["encoder_n_convolutions"]):
        cin = D if i == 0 else C
        s[f"encoder.convolutions.{i}.0.conv.weight"] = (
            (C, cin, k), _xavier(cin * k, C * k, g_relu))
        s[f"encoder.convolutions.{i}.0.conv.bias"] = ((C,), (-0.05, 0.05))
        _bn(s, f"encoder.convolutions.{i}.1", C)
    for suffix in ("_l0", "_l0_reverse"):
        _lstm(s, "encoder.lstm", C, C // 2, suffix)
    s["decoder.prenet.layers.0.linear_layer.weight"] = ((P, MR), _xavier(MR, P))
    s["decoder.prenet.layers.1.linear_layer.weight"] = ((P, P), _xavier(P, P))
    _lstm(s, "decoder.attention_rnn", P + E, H)
    L = "decoder.attention_layer."
    s[L + "query_layer.linear_layer.weight"] = ((A, H), _xavier(H, A, g_tanh))
    s[L + "location_layer.location_dense.linear_layer.weight"] = (
        (A, nf), _xavier(nf, A, g_tanh))
    if ap["attention_type"] == "LSA":
        s[L + "memory_layer.linear_layer.weight"] = ((A, E), _xavier(E, A, g_tanh))
        s[L + "v.linear_layer.weight"] = ((1, A), _xavier(A, 1))
        s[L + "location_layer.location_conv.conv.weight"] = (
            (nf, 2, lk), _xavier(2 * lk, nf * lk))
    else:
        s[L + "inputs_layer.linear_layer.weight"] = ((A, E), _xavier(E, A, g_tanh))
        s[L + "v.linear_layer.weight"] = ((1, A), _xavier(A, 1))
        s[L + "v.linear_layer.bias"] = ((1,), (-0.05, 0.05))
        b = 1.0 / math.sqrt(H + E)
        s[L + "ta.weight"] = ((1, H + E), (-b, b))
        s[L + "ta.bias"] = ((1,), (-b, b))
        s[L + "location_layer.location_conv1d.weight"] = (
            (nf, 2, lk), _xavier(2 * lk, nf * lk))
    _lstm(s, "decoder.decoder_rnn", H + E, Hd)
    s["decoder.linear_projection.linear_layer.weight"] = (
        (MR, Hd + E), _xavier(Hd + E, MR))
    s["decoder.linear_projection.linear_layer.bias"] = ((MR,), (-0.05, 0.05))
    s["decoder.gate_layer.linear_layer.weight"] = ((1, Hd + E), _xavier(Hd + E, 1))
    s["decoder.gate_layer.linear_layer.bias"] = ((1,), float(gate_bias))
    M, n_mel = model["postnet_embedding_dim"], model["n_mel_channels"]
    kp = model["postnet_kernel_size"]
    n = model["postnet_n_convolutions"]
    for i in range(n):
        cin = n_mel if i == 0 else M
        cout = n_mel if i == n - 1 else M
        gain = 1.0 if i == n - 1 else g_tanh
        s[f"postnet.convolutions.{i}.0.conv.weight"] = (
            (cout, cin, kp), _xavier(cin * kp, cout * kp, gain))
        s[f"postnet.convolutions.{i}.0.conv.bias"] = ((cout,), (-0.05, 0.05))
        _bn(s, f"postnet.convolutions.{i}.1", cout)
    return s


def wavernn_spec(v: dict, n_mels: int) -> dict:
    c, ro, rnn, fc = (v["compute_dims"], v["res_out_dims"], v["rnn_dims"],
                      v["fc_dims"])
    d = ro // 4
    k = 2 * v["pad"] + 1
    s = {}

    def lin(name, n_out, n_in, bias=True):
        b = 1.0 / math.sqrt(n_in)
        s[f"{name}.weight"] = ((n_out, n_in), (-b, b))
        if bias:
            s[f"{name}.bias"] = ((n_out,), (-b, b))

    R = "upsample.resnet."
    b = 1.0 / math.sqrt(n_mels * k)
    s[R + "conv_in.weight"] = ((c, n_mels, k), (-b, b))
    _bn(s, R + "batch_norm", c)
    for i in range(v["res_blocks"]):
        b = 1.0 / math.sqrt(c)
        s[f"{R}layers.{i}.conv1.weight"] = ((c, c, 1), (-b, b))
        s[f"{R}layers.{i}.conv2.weight"] = ((c, c, 1), (-b, b))
        _bn(s, f"{R}layers.{i}.batch_norm1", c)
        _bn(s, f"{R}layers.{i}.batch_norm2", c)
    b = 1.0 / math.sqrt(c)
    s[R + "conv_out.weight"] = ((ro, c, 1), (-b, b))
    s[R + "conv_out.bias"] = ((ro,), (-b, b))
    for i, f in enumerate(v["upsample_factors"]):
        s[f"upsample.up_layers.{2 * i + 1}.weight"] = (
            (1, 1, 1, 2 * f + 1), 1.0 / (2 * f + 1))
    lin("I", rnn, n_mels + d + 1)
    u = (-1.0 / math.sqrt(rnn), 1.0 / math.sqrt(rnn))
    for name, n_in in (("rnn1", rnn), ("rnn2", rnn + d)):
        s[f"{name}.weight_ih_l0"] = ((3 * rnn, n_in), u)
        s[f"{name}.weight_hh_l0"] = ((3 * rnn, rnn), u)
        s[f"{name}.bias_ih_l0"] = ((3 * rnn,), u)
        s[f"{name}.bias_hh_l0"] = ((3 * rnn,), u)
    lin("fc1", fc, rnn + d)
    lin("fc2", fc, fc + d)
    lin("fc3", 30, fc)
    # the output's bias by part: mixture weights and means near 0, the
    # log scales near -4, so that the logistics' scales (~0.02) leave the
    # samples inside [-1, 1] instead of clamped at its ends
    s["fc3.bias"] = ((30,), [(20, -0.1, 0.1), (10, -4.5, -3.5)])
    return s


def hifigan_spec(h: dict, n_mels: int, gain: float) -> dict:
    """Weights U(±gain/√fan_in): ``gain`` keeps the random generator's
    waveform away from both silence and tanh's saturation."""
    s = {}

    def conv(name, shape, fan_in):
        b = gain / math.sqrt(fan_in)
        s[f"{name}.weight"] = (shape, (-b, b))
        s[f"{name}.bias"] = ((shape[0] if "ups" not in name else shape[1],),
                             (-0.01, 0.01))

    ch = h["upsample_initial_channel"]
    conv("conv_pre", (ch, n_mels, 7), n_mels * 7)
    nk = len(h["resblock_kernel_sizes"])
    for i, (u, k) in enumerate(zip(h["upsample_rates"],
                                   h["upsample_kernel_sizes"])):
        c = ch // 2 ** (i + 1)
        conv(f"ups.{i}", (2 * c, c, k), 2 * c * k // u)
        for j, (kk, dils) in enumerate(zip(h["resblock_kernel_sizes"],
                                           h["resblock_dilation_sizes"])):
            for m in range(len(dils)):
                names = ([f"convs1.{m}", f"convs2.{m}"] if h["resblock"] == "1"
                         else [f"convs.{m}"])
                for nm in names:
                    conv(f"resblocks.{i * nk + j}.{nm}", (c, c, kk), c * kk)
    conv("conv_post", (1, ch // 2 ** len(h["upsample_rates"]), 7),
         ch // 2 ** len(h["upsample_rates"]) * 7)
    return s


def _segments(shape, rng) -> list:
    """(count, lo, hi) runs of a drawn leaf, in order."""
    if isinstance(rng, tuple):
        return [(int(np.prod(shape)), *rng)]
    return list(rng)


def make(spec: dict, generator: torch.Generator, device) -> dict:
    """The ``state_dict`` of ``spec``: every drawn leaf cut from one
    float32 ``torch.rand`` on ``generator``'s device; a leaf's range is
    (lo, hi) or a list of (count, lo, hi) runs."""
    drawn = [(k, shape, rng) for k, (shape, rng) in spec.items()
             if isinstance(rng, (tuple, list))]
    total = sum(int(np.prod(shape)) for _, shape, _ in drawn)
    u = torch.rand(total, generator=generator, device=device)
    out, o = {}, 0
    for k, shape, rng in drawn:
        parts = []
        for n, lo, hi in _segments(shape, rng):
            parts.append(u[o: o + n] * (hi - lo) + lo)
            o += n
        out[k] = torch.cat(parts).view(shape)
    for k, (shape, c) in spec.items():
        if k.endswith("num_batches_tracked"):
            out[k] = torch.zeros((), dtype=torch.int64, device=device)
        elif not isinstance(c, (tuple, list)):
            out[k] = torch.full(shape, float(c), device=device)
    return {k: out[k] for k in spec}


def all_weights(cfg: dict, seed: int, device) -> dict:
    """``{"tacotron": sd, "wavernn": sd, "hifigan": sd}`` for the
    configuration's model and the vocoders it attaches."""
    g = torch.Generator(device=device).manual_seed(seed % (2 ** 63))
    n_mels = cfg["audio_params"]["n_mels"]
    out = {"tacotron": make(tacotron_spec(model_params(cfg), cfg["gate_bias"]),
                            g, device)}
    voc = cfg["vocoders"]
    if "wavernn" in voc:
        out["wavernn"] = make(wavernn_spec(voc["wavernn"], n_mels), g, device)
    if "hifigan" in voc:
        out["hifigan"] = make(hifigan_spec(
            voc["hifigan"], n_mels, cfg["random_init"]["hifigan_gain"]),
            g, device)
    return out
