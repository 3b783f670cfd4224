"""WaveRNN's operations and the sample-loop kernel's bytes, from shapes.

A sample step of one fold row applies the two GRUs' matrices, the three
fully connected layers and the input projection's sample column once;
the rest of the input projection is one product over all rows and steps
before the loop; the conditioning network runs on the padded mel.
"""

from __future__ import annotations

N_CLASSES = 30          # mixture of logistics: 10 x (weight, mean, scale)


def loop_matrix_weights(v: dict) -> int:
    rnn, fc = v["rnn_dims"], v["fc_dims"]
    d = v["res_out_dims"] // 4
    return (3 * rnn * rnn * 2 + 3 * rnn * (rnn + d) + 3 * rnn * rnn
            + fc * (rnn + d) + fc * (fc + d) + N_CLASSES * fc + rnn)


def loop_ops(v: dict, rows: int, steps: int) -> float:
    return 2.0 * rows * steps * loop_matrix_weights(v)


def loop_launch_bytes(v: dict, rows: int, steps: int,
                      weight_bytes: int) -> float:
    """One sample-loop launch: the matrices at ``weight_bytes`` and the
    biases in float32 once; the hoisted projection, the aux features and
    both noises in; the samples out; float32, each once."""
    rnn, fc = v["rnn_dims"], v["fc_dims"]
    d = v["res_out_dims"] // 4
    K = N_CLASSES // 3
    biases = 3 * rnn * 4 + 2 * fc + N_CLASSES + rnn
    weights = weight_bytes * loop_matrix_weights(v) + 4 * biases
    streams = 4 * rows * steps * (rnn + 3 * d + K + 1 + 1)
    return float(weights + streams)


def projection_ops(v: dict, n_mels: int, rows: int, steps: int) -> float:
    d = v["res_out_dims"] // 4
    return 2.0 * rows * steps * v["rnn_dims"] * (n_mels + d)


def conditioning_ops(v: dict, n_mels: int, mels: int, frames: int) -> float:
    """The conditioning network and the upsampling's mean filters for
    ``mels`` mels padded to ``frames`` frames (before the 2·pad)."""
    c, ro = v["compute_dims"], v["res_out_dims"]
    k = 2 * v["pad"] + 1
    t = frames + 2 * v["pad"]
    res = (n_mels * c * k + v["res_blocks"] * 2 * c * c + c * ro) * (t - 2 * v["pad"])
    ups, n = 0, t
    for s in v["upsample_factors"]:
        n *= s
        ups += n_mels * n * (2 * s + 1)
    return 2.0 * mels * (res + ups)
