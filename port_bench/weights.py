"""Random weights for a configuration, made on the device from the seed.

Every leaf of each model (the Tacotron-2 acoustic model here, each
vocoder in its part, ``parts/<vocoder>.py``) is listed from the
configuration's sizes, under the published checkpoints' ``state_dict``
keys, with the distribution it is drawn from: uniform in [lo, hi), scaled
by the leaf's fan-in as the published initialisers scale it.  All leaves
of a model come from one ``torch.rand`` call on a generator on the
device, cut into views; a leaf that a configuration fixes (a mean filter,
the gate's bias) is a constant.  The served system and the reference get
the same tensors.
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


def bn(spec: dict, name: str, n: int) -> None:
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
        bn(s, f"encoder.convolutions.{i}.1", C)
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
        bn(s, f"postnet.convolutions.{i}.1", cout)
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


# the vocoders of the first configurations, in the order they drew their
# weights; any other draws after these, in the configuration's order
DRAWN_FIRST = ("wavernn", "hifigan")


def vocoder_order(cfg: dict) -> list:
    """The configuration's vocoders in the order their weights are
    drawn."""
    voc = list(cfg["vocoders"])
    return ([n for n in DRAWN_FIRST if n in voc]
            + [n for n in voc if n not in DRAWN_FIRST])


def all_weights(cfg: dict, seed: int, device) -> dict:
    """``{"tacotron": sd, <vocoder>: sd, ...}`` for the configuration's
    model and each vocoder that has weights (``parts/<vocoder>.py``), all
    drawn from one generator in ``vocoder_order``."""
    import parts

    g = torch.Generator(device=device).manual_seed(seed % (2 ** 63))
    out = {"tacotron": make(tacotron_spec(model_params(cfg), cfg["gate_bias"]),
                            g, device)}
    for name, part in parts.of(cfg).items():
        spec = part.weight_spec()
        if spec:
            out[name] = make(spec, g, device)
    return out
