"""WaveRNN vocoder (sample-level autoregressive, mixture-of-logistics or
Gaussian output), counterpart of ``msa_tts_tpu/vocoders/wavernn.py``.

``WaveRNNModel`` is an ``nn.Module`` whose ``state_dict`` keys are the
reference checkpoint's (``upsample.resnet.*``, ``upsample.up_layers.*``,
``I``, ``rnn1``, ``rnn2``, ``fc1``-``fc3``), so such a checkpoint loads
with ``strict=True``.  Generation is batched over the fold axis
(``fold_with_overlap``): one sample loop runs every fold of every
utterance, as the CUDA kernel of ``cuda_gen.py`` on a GPU and as
:func:`sample_loop`, its plain PyTorch version, on the CPU; the
equal-power crossfade unfold is the reference's, in float64 on the host.
The sampling noise is pre-drawn (from an explicit ``torch.Generator``,
or injected as tensors), so both loops compute the same function of the
same inputs.

Training (``trainers/wavernn_train.py``): :func:`wavernn_forward` runs
the GRUs as ``nn.GRU`` (cuDNN on a GPU) under
``torch.func.functional_call`` (``WaveRNNModel.forward``), and
:func:`discretized_mix_logistic_loss` / :func:`gaussian_loss` score its
logits.  The batch norms of the conditioning network normalise with
their running statistics in training too (fixed preprocessing, as in the
JAX package); :func:`melresnet_apply` with ``train=True`` gives the
batch-statistics pass and the statistics it would leave.  The samplers
that draw their own noise (:func:`sample_from_discretized_mix_logistic`,
:func:`sample_from_gaussian`) take a ``torch.Generator`` or the draws
themselves.
"""

from __future__ import annotations

import math
import os
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.nn import batchnorm1d, batchnorm1d_train, uniform_
from ..ops.rnn import init_gru_
from ..utils.backend import load_device, resolve_kernel_backend
from ..utils.batching import pad_mel_batch
from ..utils.profiling import annotate
from . import Vocoder

LOG_SCALE_MIN = float(np.log(1e-14))
LOG_STD_MIN = -7.0
GEN_LAYERS = ("I", "rnn1", "rnn2", "fc1", "fc2", "fc3")


class WaveRNNConfig(NamedTuple):
    mode: str = "MOL"                  # MOL | GAUSS
    n_mels: int = 80
    rnn_dims: int = 512
    fc_dims: int = 512
    compute_dims: int = 128
    res_out_dims: int = 128
    res_blocks: int = 10
    hop_length: int = 256
    sample_rate: int = 22050
    pad: int = 2
    upsample_factors: tuple = (4, 8, 8)
    use_upsample_net: bool = True
    use_aux_net: bool = True

    @property
    def n_classes(self) -> int:
        if self.mode == "MOL":
            return 30
        if self.mode == "GAUSS":
            return 2
        raise ValueError(self.mode)

    @property
    def aux_dims(self) -> int:
        return self.res_out_dims // 4


def config_from_params(**params) -> WaveRNNConfig:
    ap = params["audio_params"]
    return WaveRNNConfig(
        mode=params.get("voc_mode", "MOL"),
        n_mels=ap["n_mels"],
        rnn_dims=params["rnn_dims"],
        fc_dims=params["fc_dims"],
        compute_dims=params["compute_dims"],
        res_out_dims=params["res_out_dims"],
        res_blocks=params["res_blocks"],
        hop_length=ap["hop_length"],
        sample_rate=ap["sample_rate"],
        pad=params["pad"],
        upsample_factors=tuple(params["upsample_factors"]),
        use_upsample_net=params.get("use_upsample_net", True),
        use_aux_net=params.get("use_aux_net", True),
    )


# --------------------------------------------------------------------------
# Modules
# --------------------------------------------------------------------------

class ResBlock(nn.Module):
    def __init__(self, dims: int):
        super().__init__()
        self.conv1 = nn.Conv1d(dims, dims, 1, bias=False)
        self.conv2 = nn.Conv1d(dims, dims, 1, bias=False)
        self.batch_norm1 = nn.BatchNorm1d(dims)
        self.batch_norm2 = nn.BatchNorm1d(dims)


class MelResNet(nn.Module):
    """(B, n_mels, T) → (B, res_out, T − 2·pad); the batch norms
    normalise with their running statistics (fixed preprocessing, as the
    JAX package's generation and training paths both run them)."""

    def __init__(self, cfg: WaveRNNConfig):
        super().__init__()
        c = cfg.compute_dims
        self.conv_in = nn.Conv1d(cfg.n_mels, c, cfg.pad * 2 + 1, bias=False)
        self.batch_norm = nn.BatchNorm1d(c)
        self.layers = nn.ModuleList(
            ResBlock(c) for _ in range(cfg.res_blocks))
        self.conv_out = nn.Conv1d(c, cfg.res_out_dims, 1)

    def forward(self, x):
        return melresnet_apply(self, x)


def melresnet_apply(resnet: MelResNet, x, *, train: bool = False):
    """The conditioning network.  ``train=False``: the batch norms use
    their running statistics, and the output is returned.  ``train=True``:
    they normalise with the batch's statistics, and ``(output, new
    statistics)`` is returned, the statistics as ``{buffer name:
    tensor}`` under the resnet's ``state_dict`` names (``batch_norm.
    running_mean``, ``layers.0.batch_norm1.running_var``, ...), moved
    toward the batch's as torch's momentum 0.1 moves them; the module's
    buffers are read, never written."""
    new = {}

    def bn(name, mod, y):
        if not train:
            return batchnorm1d(mod, y)
        y, (mean, var) = batchnorm1d_train(mod, y)
        new[f"{name}.running_mean"], new[f"{name}.running_var"] = mean, var
        return y

    x = F.relu(bn("batch_norm", resnet.batch_norm, resnet.conv_in(x)))
    for i, layer in enumerate(resnet.layers):
        y = F.relu(bn(f"layers.{i}.batch_norm1", layer.batch_norm1,
                      layer.conv1(x)))
        x = bn(f"layers.{i}.batch_norm2", layer.batch_norm2,
               layer.conv2(y)) + x
    out = resnet.conv_out(x)
    return (out, new) if train else out


def stretch_time(x, scale: int):
    """Nearest-neighbour stretch of the last axis by ``scale`` (each
    value repeated): an expand and a reshape, whose backward is a sum
    over the copies (``repeat_interleave``'s goes through an index)."""
    return x.unsqueeze(-1).expand(*x.shape, scale).reshape(
        *x.shape[:-1], x.shape[-1] * scale)


class Stretch2d(nn.Module):
    """Nearest-neighbour stretch along time; holds no weights (it keeps
    the reference's ``up_layers`` numbering: convs at odd indices)."""

    def __init__(self, scale: int):
        super().__init__()
        self.scale = int(scale)

    def forward(self, x):
        return stretch_time(x, self.scale)


class UpsampleNetwork(nn.Module):
    def __init__(self, cfg: WaveRNNConfig):
        super().__init__()
        self.resnet = MelResNet(cfg)
        self.up_layers = nn.ModuleList()
        if cfg.use_upsample_net:
            if int(np.prod(cfg.upsample_factors)) != cfg.hop_length:
                raise ValueError(
                    "upsample_factors must multiply to hop_length "
                    f"({cfg.upsample_factors} vs {cfg.hop_length})")
            for s in cfg.upsample_factors:
                conv = nn.Conv2d(1, 1, (1, 2 * s + 1), padding=(0, s),
                                 bias=False)
                with torch.no_grad():
                    conv.weight.fill_(1.0 / (2 * s + 1))
                self.up_layers.append(Stretch2d(s))
                self.up_layers.append(conv)


def _linear_interp_time(x, scale: int):
    """Linear interpolation along the last axis to ``T·scale`` samples
    with ``align_corners=True`` semantics (the output grid spans exactly
    [0, T−1]), written out as the JAX package writes it."""
    T = x.shape[-1]
    T_out = T * scale
    coords = torch.arange(T_out, dtype=x.dtype, device=x.device) * (
        (T - 1) / max(T_out - 1, 1))
    i0 = torch.floor(coords).to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=T - 1)
    frac = coords - i0.to(x.dtype)
    return x[..., i0] * (1.0 - frac) + x[..., i1] * frac


def upsample_apply(up: UpsampleNetwork, cfg: WaveRNNConfig, mels):
    """mels: (B, n_mels, T), already extended by ``cfg.pad`` frames on
    both sides → ``(mels_up (B, T'·hop, n_mels), aux (B, T'·hop,
    res_out) or None)``.

    ``use_upsample_net=True``: the learned stretch + mean-filter pyramid
    with the resnet's aux features stretched nearest-neighbour.
    ``use_upsample_net=False``: linear interpolation by ``hop_length``
    (align_corners), ``pad·hop`` trimmed from both ends, scaled by 0.045;
    aux interpolated linearly from the resnet's frames."""
    aux = None
    if not cfg.use_upsample_net:
        scale = cfg.hop_length
        if cfg.use_aux_net:
            aux = _linear_interp_time(up.resnet(mels), scale).transpose(1, 2)
        indent = cfg.pad * scale
        m = _linear_interp_time(mels, scale)
        m = m[:, :, indent: m.shape[-1] - indent] * 0.045
        return m.transpose(1, 2), aux

    total_scale = int(np.prod(cfg.upsample_factors))
    if cfg.use_aux_net:
        aux = stretch_time(up.resnet(mels), total_scale).transpose(1, 2)
    m = mels
    B, C, _ = m.shape
    for i, s in enumerate(cfg.upsample_factors):
        m = up.up_layers[2 * i](m)
        # one shared (2s+1) mean filter across all channels
        w = up.up_layers[2 * i + 1].weight[:, :, 0, :]
        m = F.conv1d(m.reshape(B * C, 1, -1), w, padding=s).reshape(B, C, -1)
    indent = cfg.pad * total_scale
    m = m[:, :, indent: m.shape[-1] - indent]
    return m.transpose(1, 2), aux


class WaveRNNModel(nn.Module):
    """The WaveRNN weights under the reference's ``state_dict`` keys.
    ``generator`` draws the JAX package's initial distributions
    (U(±1/√fan_in) for linears and convs, U(±1/√H) for the GRUs)."""

    def __init__(self, cfg: WaveRNNConfig,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        extra = cfg.aux_dims if cfg.use_aux_net else 0
        self.upsample = UpsampleNetwork(cfg)
        self.I = nn.Linear(cfg.n_mels + extra + 1, cfg.rnn_dims)
        self.rnn1 = nn.GRU(cfg.rnn_dims, cfg.rnn_dims, batch_first=True)
        self.rnn2 = nn.GRU(cfg.rnn_dims + extra, cfg.rnn_dims,
                           batch_first=True)
        self.fc1 = nn.Linear(cfg.rnn_dims + extra, cfg.fc_dims)
        self.fc2 = nn.Linear(cfg.fc_dims + extra, cfg.fc_dims)
        self.fc3 = nn.Linear(cfg.fc_dims, cfg.n_classes)
        if generator is not None:
            self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        for m in self.modules():
            if isinstance(m, nn.Linear):
                a = 1.0 / math.sqrt(m.in_features)
            elif isinstance(m, nn.Conv1d):
                a = 1.0 / math.sqrt(m.in_channels * m.kernel_size[0])
            else:
                continue
            uniform_(m.weight, a, generator)
            if m.bias is not None:
                uniform_(m.bias, a, generator)
        init_gru_(self.rnn1, generator)
        init_gru_(self.rnn2, generator)


    def forward(self, x, mels):
        """Teacher-forced logits with the GRUs as ``nn.GRU``: the
        training forward, for ``torch.func.functional_call``."""
        return wavernn_forward(self, self.cfg, x, mels)


def wavernn_forward(model: WaveRNNModel, cfg: WaveRNNConfig, x, mels):
    """Teacher-forced pass.  x: (B, T) previous samples; mels:
    (B, n_mels, T_mel) → logits (B, T, n_classes).  Each GRU is one
    ``nn.GRU`` call (cuDNN on a GPU)."""
    mels_up, aux = upsample_apply(model.upsample, cfg, mels)
    d = cfg.aux_dims
    if cfg.use_aux_net:
        a1, a2, a3, a4 = (aux[:, :, i * d: (i + 1) * d] for i in range(4))
        inp = torch.cat([x[:, :, None], mels_up, a1], dim=2)
    else:
        inp = torch.cat([x[:, :, None], mels_up], dim=2)
    h = model.I(inp)
    h = model.rnn1(h)[0] + h
    h2_in = torch.cat([h, a2], dim=2) if cfg.use_aux_net else h
    h = model.rnn2(h2_in)[0] + h
    h = torch.cat([h, a3], dim=2) if cfg.use_aux_net else h
    h = F.relu(model.fc1(h))
    h = torch.cat([h, a4], dim=2) if cfg.use_aux_net else h
    h = F.relu(model.fc2(h))
    return model.fc3(h)


# --------------------------------------------------------------------------
# Mixture-of-logistics and Gaussian outputs: losses and samplers
# --------------------------------------------------------------------------

def _floor(x, value: float):
    """``max(x, value)`` against a tensor: at a tie the gradient splits
    0.5 / 0.5 as ``jnp.maximum``'s does (``clamp_min`` passes all of it)."""
    return torch.maximum(x, torch.full_like(x, value))


def discretized_mix_logistic_loss(y_hat, y, num_classes: int = 65536,
                                  log_scale_min: float = LOG_SCALE_MIN):
    """Mean negative log-likelihood of ``y`` (B, T, 1) in [−1, 1] under
    the discretized logistic mixture ``y_hat`` (B, T, 3·K): the CDF's
    tails at the ±1 edges, the log of the bin's mass where it exceeds
    1e-5, else the log density at the bin centre."""
    K = y_hat.shape[-1] // 3
    logit_probs = y_hat[..., :K]
    means = y_hat[..., K: 2 * K]
    log_scales = _floor(y_hat[..., 2 * K:], log_scale_min)
    centered = y - means
    inv_stdv = torch.exp(-log_scales)
    plus_in = inv_stdv * (centered + 1.0 / (num_classes - 1))
    min_in = inv_stdv * (centered - 1.0 / (num_classes - 1))
    cdf_delta = torch.sigmoid(plus_in) - torch.sigmoid(min_in)
    log_cdf_plus = plus_in - F.softplus(plus_in)
    log_one_minus_cdf_min = -F.softplus(min_in)
    mid_in = inv_stdv * centered
    log_pdf_mid = mid_in - log_scales - 2.0 * F.softplus(mid_in)
    inner = torch.where(cdf_delta > 1e-5,
                        torch.log(_floor(cdf_delta, 1e-12)),
                        log_pdf_mid - float(np.log((num_classes - 1) / 2)))
    log_probs = torch.where(
        y < -0.999, log_cdf_plus,
        torch.where(y > 0.999, log_one_minus_cdf_min, inner))
    log_probs = log_probs + F.log_softmax(logit_probs, dim=-1)
    return -torch.logsumexp(log_probs, dim=-1).mean()


def gaussian_loss(y_hat, y, log_std_min: float = LOG_STD_MIN):
    """The Gaussian output's loss as the JAX package writes it (the mean
    of ``-0.5 · (−log 2π − 2·log σ − (y − μ)² / σ²)``)."""
    mean = y_hat[..., :1]
    log_std = _floor(y_hat[..., 1:], log_std_min)
    log_probs = -0.5 * (-math.log(2.0 * math.pi) - 2.0 * log_std
                        - (y - mean) ** 2 * torch.exp(-2.0 * log_std))
    return log_probs.mean()


def _uniform(shape, generator, device):
    """U(1e-5, 1 − 1e-5), the range both samplers draw from."""
    lo, hi = 1e-5, 1.0 - 1e-5
    return lo + (hi - lo) * torch.rand(shape, generator=generator,
                                       device=device)


def sample_from_discretized_mix_logistic(logits, generator=None, *, u1=None,
                                         u2=None,
                                         log_scale_min: float = LOG_SCALE_MIN):
    """logits (B, 3·K) → samples (B,) in [−1, 1]: the component by the
    Gumbel-max of ``u1`` (B, K), the sample by the logistic of ``u2``
    (B,), both uniform in (1e-5, 1 − 1e-5), drawn from ``generator``
    where not given."""
    K = logits.shape[-1] // 3
    if u1 is None:
        u1 = _uniform(logits[:, :K].shape, generator, logits.device)
    if u2 is None:
        u2 = _uniform(logits.shape[:1], generator, logits.device)
    sel = torch.argmax(logits[:, :K] - torch.log(-torch.log(u1)), dim=-1,
                       keepdim=True)
    mean = logits[:, K: 2 * K].gather(1, sel)[:, 0]
    log_scale = _floor(logits[:, 2 * K:], log_scale_min).gather(1, sel)[:, 0]
    x = mean + torch.exp(log_scale) * (torch.log(u2) - torch.log1p(-u2))
    return torch.clamp(x, -1.0, 1.0)


def sample_from_gaussian(y_hat, generator=None, *, eps=None,
                         log_std_min: float = LOG_STD_MIN,
                         scale_factor: float = 1.0):
    """y_hat (..., 2) → samples clipped to ±``scale_factor``: mean plus
    σ times ``eps``, a standard normal drawn from ``generator`` where not
    given."""
    mean = y_hat[..., 0]
    log_std = _floor(y_hat[..., 1], log_std_min)
    if eps is None:
        eps = torch.randn(mean.shape, generator=generator,
                          device=mean.device)
    return torch.clamp(mean + torch.exp(log_std) * eps, -scale_factor,
                       scale_factor)


# --------------------------------------------------------------------------
# Folding
# --------------------------------------------------------------------------

def _fold_counts(T: int, target: int, overlap: int):
    """``(num_folds, n_pad_folds)`` for a (T, F) conditioning signal;
    ``n_pad_folds`` rounds the fold count up to a multiple of 4 (the JAX
    package's bucket, kept so both draw the same noise shapes)."""
    num_folds = (T - overlap) // (target + overlap)
    extended = num_folds * (overlap + target) + overlap
    if T - extended != 0:
        num_folds += 1
    n_pad = -(-num_folds // 4) * 4
    return num_folds, n_pad


def _fold_device(x, target: int, overlap: int):
    """Fold (T, F) conditioning on its device into ``(n_pad_folds,
    target + 2·overlap, F)`` overlapping segments by one gather.  Returns
    ``(folded, num_folds)`` with the real fold count."""
    T = x.shape[0]
    L = target + 2 * overlap
    num_folds, n_pad = _fold_counts(T, target, overlap)
    last_start = (n_pad - 1) * (target + overlap)
    flat = F.pad(x, (0, 0, 0, max(last_start + L - T, 0)))
    idx = (torch.arange(n_pad, device=x.device)[:, None] * (target + overlap)
           + torch.arange(L, device=x.device)[None, :])
    return flat[idx], num_folds


def fold_with_overlap(x: np.ndarray, target: int, overlap: int) -> np.ndarray:
    """(1, T, F) → (num_folds, target + 2·overlap, F) with shared overlap
    regions.  An input shorter than ``overlap`` becomes one padded fold
    (the unclamped floor division would give none)."""
    _, total_len, features = x.shape
    num_folds = max((total_len - overlap) // (target + overlap), 0)
    extended_len = num_folds * (overlap + target) + overlap
    remaining = total_len - extended_len
    if remaining != 0:
        num_folds += 1
        padding = target + 2 * overlap - remaining
        x = np.pad(x, ((0, 0), (0, padding), (0, 0)))
    folded = np.zeros((num_folds, target + 2 * overlap, features), x.dtype)
    for i in range(num_folds):
        start = i * (target + overlap)
        folded[i] = x[0, start: start + target + 2 * overlap]
    return folded


def xfade_and_unfold(y: np.ndarray, target: int, overlap: int) -> np.ndarray:
    """Equal-power crossfade and overlap-add unfold, float64."""
    num_folds, length = y.shape
    target = length - 2 * overlap
    total_len = num_folds * (target + overlap) + overlap

    silence_len = overlap // 2
    fade_len = overlap - silence_len
    silence = np.zeros(silence_len, dtype=np.float64)
    t = np.linspace(-1, 1, fade_len, dtype=np.float64)
    fade_in = np.concatenate([silence, np.sqrt(0.5 * (1 + t))])
    fade_out = np.concatenate([np.sqrt(0.5 * (1 - t)), silence])

    y = y.astype(np.float64).copy()
    y[:, :overlap] *= fade_in
    y[:, -overlap:] *= fade_out

    unfolded = np.zeros(total_len, dtype=np.float64)
    for i in range(num_folds):
        start = i * (target + overlap)
        unfolded[start: start + target + 2 * overlap] += y[i]
    return unfolded


# --------------------------------------------------------------------------
# Generation
# --------------------------------------------------------------------------

def _mm(x, w):
    """x @ w.T with x rounded to the weight's dtype and f32 products and
    sums: for bf16 weights both operands are bf16 values held in f32."""
    if w.dtype == torch.float32:
        return x @ w.T
    return x.to(w.dtype).to(torch.float32) @ w.to(torch.float32).T


@torch.no_grad()
def cast_generation_params(model: WaveRNNModel, dtype) -> dict:
    """The sample-loop weights as a nested dict of detached tensors with
    the MATRICES cast to ``dtype`` (None or float32: as they are); biases
    stay f32.  The module's own full-precision weights are untouched."""
    dtype = torch.float32 if dtype is None else dtype
    out = {}
    for name in GEN_LAYERS:
        mod = getattr(model, name)
        layer = {}
        for k, v in mod.named_parameters():
            k = k.removesuffix("_l0")
            v = v.detach()
            layer[k] = (v.to(dtype) if k.startswith("weight")
                        else v.to(torch.float32))
        out[name] = layer
    return out


def sample_loop(params: dict, cfg: WaveRNNConfig, i_static, a_rest,
                noise1, noise2):
    """The sample loop, plain PyTorch: the function the CUDA kernel of
    ``cuda_gen.py`` computes.  Time-major inputs: ``i_static`` (T, B,
    rnn) the hoisted conditioning projection, ``a_rest`` (T, B, 3·aux)
    (last axis empty without the aux net), ``noise1`` / ``noise2`` from
    :func:`generation_noise`.  Returns samples (B, T) f32."""
    T, B, _ = i_static.shape
    d = cfg.aux_dims
    dev = i_static.device
    if cfg.mode not in ("MOL", "GAUSS"):
        raise ValueError(cfg.mode)
    # bf16 matrices as f32 tensors holding bf16 values, converted once
    p = {name: {k: (v.to(torch.float32) if k.startswith("weight") else v)
                for k, v in layer.items()}
         for name, layer in params.items()}
    wdt = params["rnn1"]["weight_ih"].dtype

    def mm(x, w):
        if wdt != torch.float32:
            x = x.to(wdt).to(torch.float32)
        return x @ w.T

    def cell(layer, x, h):
        gi = mm(x, layer["weight_ih"]) + layer["bias_ih"]
        gh = mm(h, layer["weight_hh"]) + layer["bias_hh"]
        i_r, i_z, i_n = gi.chunk(3, dim=-1)
        h_r, h_z, h_n = gh.chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        return (1.0 - z) * n + z * h

    w_x = params["I"]["weight"][:, 0].to(torch.float32)
    x = torch.zeros(B, 1, device=dev)
    h1 = torch.zeros(B, cfg.rnn_dims, device=dev)
    h2 = torch.zeros(B, cfg.rnn_dims, device=dev)
    K = cfg.n_classes // 3
    out = torch.empty(T, B, device=dev)
    for t in range(T):
        a_t = a_rest[t]
        z = i_static[t] + x * w_x
        h1 = cell(p["rnn1"], z, h1)
        z = z + h1
        inp2 = torch.cat([z, a_t[:, :d]], dim=1) if cfg.use_aux_net else z
        h2 = cell(p["rnn2"], inp2, h2)
        z = z + h2
        if cfg.use_aux_net:
            z = torch.cat([z, a_t[:, d: 2 * d]], dim=1)
        z = F.relu(mm(z, p["fc1"]["weight"]) + p["fc1"]["bias"])
        if cfg.use_aux_net:
            z = torch.cat([z, a_t[:, 2 * d:]], dim=1)
        z = F.relu(mm(z, p["fc2"]["weight"]) + p["fc2"]["bias"])
        logits = mm(z, p["fc3"]["weight"]) + p["fc3"]["bias"]
        if cfg.mode == "MOL":
            # torch.argmax returns the first maximal index
            sel = torch.argmax(logits[:, :K] + noise1[t], dim=-1,
                               keepdim=True)
            mean = logits[:, K: 2 * K].gather(1, sel)[:, 0]
            log_scale = torch.clamp(
                logits[:, 2 * K:].gather(1, sel)[:, 0], min=LOG_SCALE_MIN)
            sample = mean + torch.exp(log_scale) * noise2[t]
        else:
            log_std = torch.clamp(logits[:, 1], min=LOG_STD_MIN)
            sample = logits[:, 0] + torch.exp(log_std) * noise1[t]
        sample = torch.clamp(sample, -1.0, 1.0)
        out[t] = sample
        x = sample[:, None]
    return out.transpose(0, 1)


def hoisted_inputs(params: dict, cfg: WaveRNNConfig, mels_up, aux):
    """The part of the input projection ``I`` that does not depend on
    the generated sample, as one (B·T, F) product outside the loop, and
    the aux slices the loop reads: ``(i_static (T, B, rnn), a_rest
    (T, B, 3·aux))``, time-major and contiguous."""
    d = cfg.aux_dims
    W_I = params["I"]["weight"]
    if cfg.use_aux_net:
        static_in = torch.cat([mels_up, aux[:, :, :d]], dim=2)
        a_rest = aux[:, :, d:]
    else:
        static_in = mels_up
        a_rest = mels_up.new_zeros(mels_up.shape[:2] + (0,))
    i_static = _mm(static_in, W_I[:, 1:]) + params["I"]["bias"]
    return (i_static.transpose(0, 1).contiguous(),
            a_rest.transpose(0, 1).contiguous())


@torch.no_grad()
def generate_samples(params: dict, cfg: WaveRNNConfig, mels_up, aux,
                     noise1, noise2, *, backend: str = "auto",
                     kernel_w: dict | None = None):
    """Samples (B, T) for folded conditioning ``mels_up`` (B, T, n_mels)
    and ``aux`` (B, T, res_out) or None, from pre-drawn noise.

    ``backend``: ``cuda`` runs the whole loop as one launch of the CUDA
    kernel, ``torch`` the plain :func:`sample_loop`; ``auto`` is the
    kernel for CUDA tensors and the plain loop for CPU tensors.
    ``kernel_w``: ``cuda_gen.kernel_weights(params, cfg)`` when the caller
    keeps it; packed here otherwise."""
    i_static, a_rest = hoisted_inputs(params, cfg, mels_up, aux)
    if resolve_kernel_backend(backend, mels_up.device) == "cuda":
        from .cuda_gen import cuda_generate, kernel_weights

        return cuda_generate(kernel_w or kernel_weights(params, cfg), cfg,
                             i_static, a_rest, noise1.contiguous(),
                             noise2.contiguous())
    return sample_loop(params, cfg, i_static, a_rest, noise1, noise2)


def generation_noise(cfg: WaveRNNConfig, generator: torch.Generator,
                     T: int, B: int, *, device=None):
    """Per-step sampling noise in two draws, on ``device``.  MOL: (gumbel
    (T, B, K) for the mixture choice, logistic (T, B) for the sample);
    GAUSS: (standard normal (T, B), zeros).

    A CPU generator asked for noise on a CUDA device does not draw
    (T, B, K) numbers on the host and copy them: it gives one integer,
    which seeds a generator on that device, and the draw happens there.
    The caller's seed still fixes the noise, but the same seed yields
    other noise on the card than on the CPU."""
    gdev = generator.device
    if (device is not None and torch.device(device).type == "cuda"
            and gdev.type != "cuda"):
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
        generator = torch.Generator(device=device).manual_seed(seed)
        gdev = generator.device
    if cfg.mode == "MOL":
        K = cfg.n_classes // 3
        lo, hi = 1e-5, 1.0 - 1e-5
        u1 = torch.rand((T, B, K), generator=generator, device=gdev)
        u2 = torch.rand((T, B), generator=generator, device=gdev)
        u1 = lo + (hi - lo) * u1
        u2 = lo + (hi - lo) * u2
        n1 = -torch.log(-torch.log(u1))
        n2 = torch.log(u2) - torch.log1p(-u2)
    elif cfg.mode == "GAUSS":
        n1 = torch.randn((T, B), generator=generator, device=gdev)
        n2 = torch.zeros((T, B), device=gdev)
    else:
        raise ValueError(cfg.mode)
    return n1.to(device or gdev), n2.to(device or gdev)


def _fresh_generator() -> torch.Generator:
    """An entropy-seeded generator for callers that pass none."""
    return torch.Generator().manual_seed(
        int.from_bytes(os.urandom(8), "little") >> 1)


_DTYPES = {None: None, "float32": torch.float32, "fp32": torch.float32,
           "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}


class WaveRNN(Vocoder):
    """Reference-API vocoder wrapper with batched generation.

    ``gen_dtype``: the sample loop's weight matrices (``bfloat16`` by
    default, as in the JAX package; f32 sums and gates either way).
    ``gen_backend``: ``auto`` (the CUDA kernel on a GPU, the plain loop
    on the CPU), ``cuda`` or ``torch``; resolved from the model's device
    at each call, so nothing falls back silently.

    ``device``: with a ``model`` the caller placed, None follows that
    model's device.  When the vocoder builds its own model (from ``cfg``
    or the reference's ``ref_params``) it goes onto the GPU, raising
    without one, unless ``device="cpu"`` is asked for."""

    name = "wavernn"
    tail_frames = 1

    def __init__(self, model: WaveRNNModel | None = None,
                 cfg: WaveRNNConfig | None = None, *,
                 generator: torch.Generator | None = None,
                 gen_dtype: str | None = "bfloat16",
                 gen_backend: str = "auto", device=None, **ref_params):
        if cfg is None:
            if model is not None:
                cfg = model.cfg
            else:
                cfg = config_from_params(**ref_params)
                gen_dtype = ref_params.get("gen_dtype", gen_dtype)
                gen_backend = ref_params.get("gen_backend", gen_backend)
        self.cfg = cfg
        if model is None:
            device = load_device("cuda" if device is None else device)
            model = WaveRNNModel(
                cfg, generator or torch.Generator().manual_seed(0))
        if gen_dtype not in _DTYPES:
            raise ValueError(f"unknown gen_dtype {gen_dtype!r}")
        self.gen_dtype = _DTYPES[gen_dtype]
        self.gen_backend = gen_backend
        self.model = model.eval()
        self.to(device if device is not None
                else next(model.parameters()).device)

    def to(self, device) -> "WaveRNN":
        """Move the weights to ``device`` and recast the sample-loop
        twin; raises for ``gen_backend='cuda'`` off a GPU."""
        self.device = torch.device(device)
        self.model = self.model.to(self.device)
        resolve_kernel_backend(self.gen_backend, self.device)
        self._gen_params = cast_generation_params(self.model, self.gen_dtype)
        self._kernel_w = None
        return self

    def _samples(self, mels_up, aux, n1, n2):
        """Folded conditioning and noise → samples, by ``gen_backend``;
        the kernel's packed weights are made at the first launch."""
        if (self._kernel_w is None and resolve_kernel_backend(
                self.gen_backend, self.device) == "cuda"):
            from .cuda_gen import kernel_weights

            self._kernel_w = kernel_weights(self._gen_params, self.cfg)
        return generate_samples(self._gen_params, self.cfg, mels_up, aux,
                                n1, n2, backend=self.gen_backend,
                                kernel_w=self._kernel_w)

    # --------------------------------------------------------- pipelines
    def _noise(self, generator, noise, L: int, n_pad: int):
        if noise is not None:
            n1, n2 = noise
            return (torch.as_tensor(n1, dtype=torch.float32,
                                    device=self.device),
                    torch.as_tensor(n2, dtype=torch.float32,
                                    device=self.device))
        return generation_noise(self.cfg, generator, L, n_pad,
                                device=self.device)

    @torch.no_grad()
    def _run_folded(self, mels, target: int, overlap: int, noises):
        """(B, n_mels, T) pad-extended mels on the device → samples
        (B, n_pad, L) on the device and the real fold count.  ``noises``:
        one ``(noise1 (L, n_pad[, K]), noise2 (L, n_pad))`` pair per
        utterance."""
        cfg = self.cfg
        with annotate("wavernn.condition"):
            mels_up, aux = upsample_apply(self.model.upsample, cfg, mels)
        with annotate("wavernn.fold"):
            num_folds, _ = _fold_counts(mels_up.shape[1], target, overlap)
            folded = torch.stack(
                [_fold_device(m, target, overlap)[0] for m in mels_up])
            B, n_pad, L, F_ = folded.shape
            aux_flat = None
            if aux is not None:
                aux_flat = torch.stack(
                    [_fold_device(a, target, overlap)[0] for a in aux]
                ).reshape(B * n_pad, L, -1)
            # (B, L, n_pad, ...) → (L, B·n_pad, ...): time-major, the
            # batch axis in the folds' concatenation order
            n1 = torch.stack([n[0] for n in noises]).movedim(0, 1)
            n2 = torch.stack([n[1] for n in noises]).movedim(0, 1)
            n1 = n1.reshape((L, B * n_pad) + tuple(n1.shape[3:]))
            n2 = n2.reshape((L, B * n_pad))
        with annotate("wavernn.loop"):
            samples = self._samples(folded.reshape(B * n_pad, L, F_),
                                    aux_flat, n1, n2)
        return samples.reshape(B, n_pad, L), num_folds

    def _pad_batch(self, mels_list, bucket_frames: int = 32):
        """Log-mels (n_mels, T_i) on the device → ``(B, n_mels, T +
        2·pad)`` as the upsampling network takes them, and the common
        bucketed length T.  0.0 is full-scale energy in the log-mel
        domain, so each mel is padded with its own floor, which the
        upsampler's convs may read (``pad_mel_batch``)."""
        mels = pad_mel_batch(mels_list, bucket_frames)[: len(mels_list)]
        return F.pad(mels, (self.cfg.pad, self.cfg.pad)), mels.shape[-1]

    def generate_batch(self, mels_list, target: int = 2_750,
                       overlap: int = 550, generator=None, generators=None,
                       noises=None, bucket_frames: int = 32,
                       verbose: bool = True):
        """Vocode several utterances in ONE sample loop.

        ``mels_list``: (n_mels, T_i) log-mels, tensors (they stay on
        their device) or arrays; lengths may differ: each is padded with
        its own silence floor to a common bucketed length, and samples
        past its true length are discarded.  Noise: ``noises`` injects
        one ``(noise1, noise2)`` pair per utterance, else ``generators``
        gives one generator per utterance, else all draw from
        ``generator`` in turn.  A row then equals a single-utterance run
        with that noise.  Returns float64 waveforms of length
        ``max(T_i − 1, 1)·hop``."""
        cfg = self.cfg
        B = len(mels_list)
        mels_list = [torch.as_tensor(m, dtype=torch.float32).to(self.device)
                     for m in mels_list]
        t_lens = [m.shape[-1] for m in mels_list]
        mels, T = self._pad_batch(mels_list, bucket_frames)
        L = target + 2 * overlap
        # the pad-extended mel upsamples to T·hop samples in both modes
        _, n_pad = _fold_counts(T * cfg.hop_length, target, overlap)
        if noises is None:
            if generators is None:
                generator = generator or _fresh_generator()
                generators = [generator] * B
            noises = [None] * B
        else:
            generators = [None] * B
        noises = [self._noise(g, n, L, n_pad)
                  for g, n in zip(generators, noises)]
        t0 = time.time()
        samples, n_folds = self._run_folded(mels, target, overlap, noises)
        with annotate("tts.to_host"):
            samples = samples.cpu().numpy()
        with annotate("wavernn.unfold"):
            samples = samples.astype(np.float64)
            outs = []
            for i in range(B):
                # at least one hop of output even for a 1-frame mel
                wave_len = max(t_lens[i] - 1, 1) * cfg.hop_length
                out = xfade_and_unfold(samples[i, :n_folds], target, overlap)
                outs.append(out[:wave_len])
        if verbose:
            n = sum(len(o) for o in outs)
            rate_khz = n / max(time.time() - t0, 1e-9) / 1000.0
            print(f"WaveRNN batch x{B}: {n} samples, gen_rate: "
                  f"{rate_khz:.1f} kHz -- x_realtime: "
                  f"{rate_khz * 1000 / cfg.sample_rate:.2f}")
        return outs

    def vocode(self, mels, generator=None, *, phase=None, noise=None):
        """``noise``: one ``(noise1, noise2)`` pair a mel."""
        return self.generate_batch(mels, generator=generator, noises=noise,
                                   verbose=False)

    def generate(self, mels, batched: bool = True, target: int = 11_000,
                 overlap: int = 550, generator=None, noise=None,
                 verbose: bool = True):
        """mels: (1, n_mels, T_mel) or (n_mels, T_mel) log-mel →
        waveform, float64, of length ``(T_mel − 1)·hop``; folded and
        crossfaded when ``batched``.  ``noise`` injects the ``(noise1,
        noise2)`` pair (shapes of :func:`generation_noise` for the fold
        count, or for one row of the full length when not batched)."""
        cfg = self.cfg
        mels = torch.as_tensor(mels, dtype=torch.float32).to(self.device)
        if mels.dim() == 2:
            mels = mels[None]
        wave_len = (mels.shape[-1] - 1) * cfg.hop_length
        n_up = mels.shape[-1] * cfg.hop_length
        mels = F.pad(mels, (cfg.pad, cfg.pad))
        generator = generator or (None if noise is not None
                                  else _fresh_generator())
        t0 = time.time()
        if batched:
            _, n_pad = _fold_counts(n_up, target, overlap)
            pair = self._noise(generator, noise, target + 2 * overlap, n_pad)
            samples, n_folds = self._run_folded(mels, target, overlap, [pair])
            samples = samples[0, :n_folds].cpu().numpy().astype(np.float64)
        else:
            with torch.no_grad():
                mels_up, aux = upsample_apply(self.model.upsample, cfg, mels)
                n1, n2 = self._noise(generator, noise, mels_up.shape[1], 1)
                samples = self._samples(mels_up, aux, n1, n2)
            samples = samples.cpu().numpy().astype(np.float64)
        if verbose:
            n = samples.size
            rate_khz = n / max(time.time() - t0, 1e-9) / 1000.0
            print(f"WaveRNN: {n} samples, gen_rate: {rate_khz:.1f} kHz "
                  f"-- x_realtime: {rate_khz * 1000 / cfg.sample_rate:.2f}")
        if batched:
            output = xfade_and_unfold(samples, target, overlap)
        else:
            output = samples[0]
        return output[:wave_len]


# --------------------------------------------------------------------------
# Checkpoints
# --------------------------------------------------------------------------

def wavernn_params_from_state_dict(sd: dict, cfg: WaveRNNConfig,
                                   ) -> WaveRNNModel:
    """A reference WaveRNN ``state_dict`` (tensors or arrays) loaded into
    a :class:`WaveRNNModel` with ``strict=True``."""
    model = WaveRNNModel(cfg)
    model.load_state_dict(
        {k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()},
        strict=True)
    return model


def get_wavernn(device="cuda", **params) -> WaveRNN:
    """Reference-API loader: build a WaveRNN from params and load its
    checkpoint (``params["checkpoint_path"]``) onto ``device``: the GPU
    unless ``device="cpu"`` is asked for (without a CUDA device the
    default raises)."""
    device = load_device(device)
    cfg = config_from_params(**params)
    sd = torch.load(params["checkpoint_path"], map_location="cpu",
                    weights_only=True)
    model = wavernn_params_from_state_dict(sd, cfg)
    print("Loaded WaveRNN checkpoint.\n")
    return WaveRNN(
        model, cfg, device=device,
        gen_dtype=params.get("gen_dtype", "bfloat16"),
        gen_backend=params.get("gen_backend", "auto"),
    )
