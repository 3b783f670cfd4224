"""WaveRNN inference with the mixture-of-logistics output (fatchord's
WaveRNN), plain PyTorch: the conditioning network (MelResNet) and the
upsampling (nearest-neighbour stretches, each followed by a mean filter),
the conditioning folded into overlapping segments that are generated as
rows of one batch, the sample loop (input projection, two GRUs with
residuals, three fully connected layers, the sample drawn from the
chosen logistic with the given noise), and the equal-power crossfade
that unfolds the rows, in float64.

Mels shorter than the batch's longest are padded with their own minimum
to a multiple of ``bucket`` frames, then by ``pad`` zero frames on both
sides, as the served vocoder pads them; the folds of a batch are rounded
up to a multiple of four rows, which the noise's shape carries.

``forced_loop`` runs the same step teacher-forced: each step's input is
a given sample stream's previous sample, and it returns the sample the
reference draws at each step, so that a given stream can be judged step
by step.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .precision import Precision

LOG_SCALE_MIN = math.log(1e-14)


def _bn(sd, name, x, eps=1e-5):
    shape = (1, -1, 1)
    y = (x - sd[f"{name}.running_mean"].reshape(shape)) * torch.rsqrt(
        sd[f"{name}.running_var"].reshape(shape) + eps)
    return y * sd[f"{name}.weight"].reshape(shape) + sd[
        f"{name}.bias"].reshape(shape)


def _stretch(x, s: int):
    return x.unsqueeze(-1).expand(*x.shape, s).reshape(*x.shape[:-1],
                                                       x.shape[-1] * s)


def upsample(sd: dict, v: dict, mels):
    """(B, n_mels, T + 2·pad) → (mels_up (B, T·hop, n_mels), aux
    (B, T·hop, res_out)), float32 (the served vocoder's conditioning runs
    in float32)."""
    R = "upsample.resnet."
    x = F.conv1d(mels, sd[R + "conv_in.weight"])
    x = F.relu(_bn(sd, R + "batch_norm", x))
    for i in range(v["res_blocks"]):
        L = f"{R}layers.{i}."
        y = F.relu(_bn(sd, L + "batch_norm1", F.conv1d(x, sd[L + "conv1.weight"])))
        x = _bn(sd, L + "batch_norm2", F.conv1d(y, sd[L + "conv2.weight"])) + x
    aux = F.conv1d(x, sd[R + "conv_out.weight"], sd[R + "conv_out.bias"])
    hop = int(np.prod(v["upsample_factors"]))
    aux = _stretch(aux, hop).transpose(1, 2)
    m = mels
    B, C, _ = m.shape
    for i, s in enumerate(v["upsample_factors"]):
        m = _stretch(m, s)
        w = sd[f"upsample.up_layers.{2 * i + 1}.weight"][:, :, 0, :]
        m = F.conv1d(m.reshape(B * C, 1, -1), w, padding=s).reshape(B, C, -1)
    indent = v["pad"] * hop
    m = m[:, :, indent: m.shape[-1] - indent]
    return m.transpose(1, 2), aux


def fold_counts(T: int, target: int, overlap: int):
    n = (T - overlap) // (target + overlap)
    if T - (n * (overlap + target) + overlap) != 0:
        n += 1
    return n, -(-n // 4) * 4


def _fold(x, target: int, overlap: int):
    T = x.shape[0]
    L = target + 2 * overlap
    n, n_pad = fold_counts(T, target, overlap)
    flat = F.pad(x, (0, 0, 0, max((n_pad - 1) * (target + overlap) + L - T, 0)))
    idx = (torch.arange(n_pad, device=x.device)[:, None] * (target + overlap)
           + torch.arange(L, device=x.device)[None, :])
    return flat[idx], n


def _gru(p, x, h, w_ih, w_hh, b_ih, b_hh):
    gi = p.x(x) @ w_ih.T + b_ih
    gh = p.x(h) @ w_hh.T + b_hh
    i_r, i_z, i_n = gi.chunk(3, -1)
    h_r, h_z, h_n = gh.chunk(3, -1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h


def sample_loop(p: Precision, sd: dict, v: dict, i_static, aux, n1, n2,
                forced=None):
    """Time-major ``i_static`` (T, R, rnn) and ``aux`` (T, R, 3·d); noise
    ``n1`` (T, R, K) added to the mixture logits before the choice,
    ``n2`` (T, R) the logistic draw.  Returns samples (R, T): the
    reference's own stream, or with ``forced`` (R, T) the sample it draws
    at each step after the forced stream's previous samples."""
    T, Rows, _ = i_static.shape
    d = v["res_out_dims"] // 4
    K = 10
    W = {k: p.w(sd[k]) for k in sd if k.startswith(("rnn", "fc"))
         and "weight" in k}
    w_x = p.w(sd["I.weight"])[:, 0]
    x = i_static.new_zeros(Rows, 1)
    h1 = i_static.new_zeros(Rows, v["rnn_dims"])
    h2 = torch.zeros_like(h1)
    out = torch.empty(T, Rows, device=i_static.device)
    for t in range(T):
        a = aux[t]
        z = i_static[t] + x * w_x
        h1 = _gru(p, z, h1, W["rnn1.weight_ih_l0"], W["rnn1.weight_hh_l0"],
                  sd["rnn1.bias_ih_l0"], sd["rnn1.bias_hh_l0"])
        z = z + h1
        h2 = _gru(p, torch.cat([z, a[:, :d]], 1), h2, W["rnn2.weight_ih_l0"],
                  W["rnn2.weight_hh_l0"], sd["rnn2.bias_ih_l0"],
                  sd["rnn2.bias_hh_l0"])
        z = torch.cat([z + h2, a[:, d: 2 * d]], 1)
        z = F.relu(p.x(z) @ W["fc1.weight"].T + sd["fc1.bias"])
        z = torch.cat([z, a[:, 2 * d:]], 1)
        z = F.relu(p.x(z) @ W["fc2.weight"].T + sd["fc2.bias"])
        logits = p.x(z) @ W["fc3.weight"].T + sd["fc3.bias"]
        sel = torch.argmax(logits[:, :K] + n1[t], dim=-1, keepdim=True)
        mean = logits[:, K: 2 * K].gather(1, sel)[:, 0]
        log_scale = torch.clamp(logits[:, 2 * K:].gather(1, sel)[:, 0],
                                min=LOG_SCALE_MIN)
        s = torch.clamp(mean + torch.exp(log_scale) * n2[t], -1.0, 1.0)
        out[t] = s
        x = (s if forced is None else forced[:, t])[:, None]
    return out.transpose(0, 1)


def xfade_unfold(y: np.ndarray, target: int, overlap: int) -> np.ndarray:
    num_folds, length = y.shape
    target = length - 2 * overlap
    silence_len = overlap // 2
    fade_len = overlap - silence_len
    t = np.linspace(-1, 1, fade_len, dtype=np.float64)
    fade_in = np.concatenate([np.zeros(silence_len), np.sqrt(0.5 * (1 + t))])
    fade_out = np.concatenate([np.sqrt(0.5 * (1 - t)), np.zeros(silence_len)])
    y = y.astype(np.float64).copy()
    y[:, :overlap] *= fade_in
    y[:, -overlap:] *= fade_out
    out = np.zeros(num_folds * (target + overlap) + overlap)
    for i in range(num_folds):
        s = i * (target + overlap)
        out[s: s + target + 2 * overlap] += y[i]
    return out


def conditioning(p: Precision, sd: dict, v: dict, mels: list,
                 bucket: int = 32):
    """Log-mels (n_mels, T_i) → the sample loop's time-major inputs
    ``(i_static (L, R, rnn), aux (L, R, 3·d))`` over every fold of every
    mel (R = mels x the padded fold count) and the real fold count."""
    target, overlap = v["target"], v["overlap"]
    T = -(-max(m.shape[-1] for m in mels) // bucket) * bucket
    batch = torch.stack([torch.cat([m, m.min().expand(m.shape[0], T - m.shape[1])], 1)
                         for m in mels])
    batch = F.pad(batch, (v["pad"], v["pad"]))
    mels_up, aux = upsample(sd, v, batch)
    folds = [_fold(m, target, overlap) for m in mels_up]
    n_folds = folds[0][1]
    folded = torch.cat([f for f, _ in folds])                  # (R, L, C)
    aux_f = torch.cat([_fold(a, target, overlap)[0] for a in aux])
    d = v["res_out_dims"] // 4
    W_I = p.w(sd["I.weight"])
    static = torch.cat([folded, aux_f[:, :, :d]], 2)
    i_static = (p.x(static) @ W_I[:, 1:].T + sd["I.bias"]).transpose(0, 1)
    return (i_static.contiguous(),
            aux_f[:, :, d:].transpose(0, 1).contiguous(), n_folds)


def raw_samples(p: Precision, sd: dict, v: dict, mels: list, noises: list,
                forced=None, bucket: int = 32):
    """The sample loop's folds ``(B, n_pad, L)`` for log-mels (n_mels,
    T_i), and the real fold count.  ``noises``: one ``(n1 (L, n_pad, K),
    n2 (L, n_pad))`` pair per mel; ``forced`` (B, n_pad, L): a stream to
    follow step by step (:func:`sample_loop`).  The loop's matrices are at
    ``p``'s precision; its conditioning runs in float32."""
    i_static, aux, n_folds = conditioning(p, sd, v, mels, bucket)
    n1 = torch.cat([n[0] for n in noises], 1)
    n2 = torch.cat([n[1] for n in noises], 1)
    if forced is not None:
        forced = forced.reshape(-1, forced.shape[-1]).float()
    samples = sample_loop(p, sd, v, i_static, aux, n1, n2, forced)
    return samples.reshape(len(mels), -1, samples.shape[-1]), n_folds


def unfold(v: dict, samples, n_folds: int, lens: list) -> list:
    """Raw folds (B, n_pad, L) → float64 waveforms of ``(T_i − 1)·hop``
    samples."""
    hop = int(np.prod(v["upsample_factors"]))
    samples = samples.cpu().numpy().astype(np.float64)
    return [xfade_unfold(samples[i, :n_folds], v["target"], v["overlap"])[
        : max(t - 1, 1) * hop] for i, t in enumerate(lens)]


def generate(p: Precision, sd: dict, v: dict, mels: list, noises: list,
             bucket: int = 32):
    """Log-mels (n_mels, T_i) → float64 waveforms of ``(T_i − 1)·hop``
    samples (see :func:`raw_samples`)."""
    samples, n_folds = raw_samples(p, sd, v, mels, noises, bucket=bucket)
    return unfold(v, samples, n_folds, [m.shape[-1] for m in mels])
