"""Tacotron 2's operations and the decoder kernel's bytes, from shapes.

One multiply-add is two operations.  A decoder step of one row applies
every matrix of the step once (prenet, both LSTMs, the query, the
transition agent, projection and gate) and, at every text position, the
location convolution, the location dense, the energies' read-out and the
context sum.
"""

from __future__ import annotations


def _dims(m: dict):
    E = m["encoder_embedding_dim"] + m["speaker_embedding_dim"]
    MR = m["n_mel_channels"] * m["n_frames_per_step"]
    return E, m["attention_rnn_dim"], m["decoder_rnn_dim"], m["prenet_dim"], MR


def step_matrix_weights(m: dict) -> int:
    """The matrix weights one decoder step applies to a row once."""
    E, H, Hd, P, MR = _dims(m)
    A = m["attention_params"]["attention_dim"]
    n = P * MR + P * P
    n += 4 * H * (P + E) + 4 * H * H
    n += A * H
    if m["attention_params"]["attention_type"] != "LSA":
        n += H + E                                   # transition agent
    n += 4 * Hd * (H + E) + 4 * Hd * Hd
    n += (MR + 1) * (Hd + E)                         # projection and gate
    return n


def step_position_macs(m: dict) -> int:
    """Multiply-adds per text position of one row's step."""
    ap = m["attention_params"]
    E = m["encoder_embedding_dim"] + m["speaker_embedding_dim"]
    nf, k, A = (ap["attention_location_n_filters"],
                ap["attention_location_kernel_size"], ap["attention_dim"])
    return 2 * nf * k + nf * A + A + E


def decoder_ops(m: dict, rows: int, t_in: int, steps: int) -> float:
    """The decoder loop's operations for ``rows`` rows of ``t_in`` text
    positions over ``steps`` steps (the encoder's projection for the
    attention, done once a row, is in :func:`encoder_ops`)."""
    return 2.0 * rows * steps * (step_matrix_weights(m)
                                 + t_in * step_position_macs(m))


def decoder_launch_bytes(m: dict, t_ins: list, steps: int,
                         weight_bytes: int) -> float:
    """One decoder-loop launch over rows of ``t_ins`` text positions:
    every matrix weight at ``weight_bytes`` and every vector in float32
    once; the encoder outputs, their projection, the text mask and the
    prenet masks in; the mels, gates, alignments and lengths out; all
    float32, each once."""
    rows, t_in = len(t_ins), sum(t_ins)
    E, H, Hd, P, MR = _dims(m)
    ap = m["attention_params"]
    A, nf, k = (ap["attention_dim"], ap["attention_location_n_filters"],
                ap["attention_location_kernel_size"])
    vectors = 4 * H + 4 * Hd + MR + 1 + A + 2        # biases, v, agent
    n_w = step_matrix_weights(m) + nf * 2 * k + nf * A
    weights = weight_bytes * n_w + 4 * vectors
    inputs = 4 * t_in * (E + A + 1) + 4 * steps * 2 * rows * P
    outputs = 4 * steps * (rows * (MR + 1) + t_in) + 4 * rows
    return float(weights + inputs + outputs)


def encoder_ops(m: dict, rows: int, t_in: int) -> float:
    """Convolutions, the bidirectional LSTM and the attention's
    projection of the encoder outputs, for ``rows`` rows of ``t_in``
    valid positions."""
    C, k = m["encoder_embedding_dim"], m["encoder_kernel_size"]
    D = m["symbols_embedding_dim"]
    E = C + m["speaker_embedding_dim"]
    A = m["attention_params"]["attention_dim"]
    H = C // 2
    convs = sum((D if i == 0 else C) * C * k
                for i in range(m["encoder_n_convolutions"]))
    lstm = 2 * (4 * H * C + 4 * H * H)
    return 2.0 * rows * t_in * (convs + lstm + A * E)


def postnet_ops(m: dict, rows: int, frames: int) -> float:
    n_mel, M, k = (m["n_mel_channels"], m["postnet_embedding_dim"],
                   m["postnet_kernel_size"])
    n = m["postnet_n_convolutions"]
    macs = sum((n_mel if i == 0 else M) * (n_mel if i == n - 1 else M) * k
               for i in range(n))
    return 2.0 * rows * frames * macs
