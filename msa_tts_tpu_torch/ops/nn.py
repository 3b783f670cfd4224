"""Neural-net primitives (counterpart of ``msa_tts_tpu/ops/nn.py``).

Modules are named as the reference names them (``LinearNorm`` holds
``linear_layer``, ``ConvNorm`` holds ``conv``) so that ``state_dict``
keys are the reference checkpoint's.  Initializers draw from an explicit
``torch.Generator`` with the JAX package's distributions:
xavier-uniform by nonlinearity gain for linear and conv weights, zero
biases, U(±1/√H) for LSTM cells.
"""

from __future__ import annotations

import contextlib
import contextvars
import math

import torch
import torch.nn.functional as F
from torch import nn

_GAINS = {
    "linear": 1.0,
    "sigmoid": 1.0,
    "tanh": 5.0 / 3.0,
    "relu": math.sqrt(2.0),
}


def calculate_gain(nonlinearity: str) -> float:
    return _GAINS[nonlinearity]


@torch.no_grad()
def uniform_(t: torch.Tensor, a: float, generator: torch.Generator):
    """Fill ``t`` with U(-a, a) drawn on the generator's device."""
    u = torch.rand(t.shape, generator=generator, device=generator.device)
    t.copy_((u * 2.0 - 1.0) * a)
    return t


# ----------------------------------------------------------------- linear

class LinearNorm(nn.Module):
    """``nn.Linear`` under the reference's ``linear_layer`` key."""

    def __init__(self, in_features: int, out_features: int, *,
                 bias: bool = True, w_init_gain: str = "linear",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.linear_layer = nn.Linear(in_features, out_features, bias=bias)
        self.w_init_gain = w_init_gain
        if generator is not None:
            self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        lin = self.linear_layer
        a = calculate_gain(self.w_init_gain) * math.sqrt(
            6.0 / (lin.in_features + lin.out_features)
        )
        uniform_(lin.weight, a, generator)
        if lin.bias is not None:
            lin.bias.zero_()

    def forward(self, x):
        return self.linear_layer(x)


def linear(x, weight, bias=None):
    """``x @ weight.T + bias`` with the torch (out, in) weight layout."""
    return F.linear(x, weight, bias)


# ----------------------------------------------------------------- conv1d

class ConvNorm(nn.Module):
    """``nn.Conv1d`` under the reference's ``conv`` key, 'same' padding
    for odd kernels."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, *, bias: bool = True,
                 w_init_gain: str = "linear",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.conv = nn.Conv1d(
            in_channels, out_channels, kernel_size,
            padding=(kernel_size - 1) // 2, bias=bias,
        )
        self.w_init_gain = w_init_gain
        if generator is not None:
            self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        c = self.conv
        k = c.kernel_size[0]
        a = calculate_gain(self.w_init_gain) * math.sqrt(
            6.0 / (c.in_channels * k + c.out_channels * k)
        )
        uniform_(c.weight, a, generator)
        if c.bias is not None:
            c.bias.zero_()

    def forward(self, x):
        return self.conv(x)


def conv1d(x, weight, bias=None, *, padding: int = 0):
    """1-D convolution on ``(B, C, T)`` inputs (torch NCW layout)."""
    return F.conv1d(x, weight, bias, padding=padding)


# ------------------------------------------------------------- batch norm

def batchnorm1d(bn: nn.BatchNorm1d, x, *, eps: float | None = None):
    """Eval-mode BatchNorm over ``(B, C, T)`` or ``(B, C)`` from the
    running statistics, written as the JAX package writes it
    (``(x - mean) · rsqrt(var + eps) · weight + bias``)."""
    eps = bn.eps if eps is None else eps
    shape = (1, -1) if x.dim() == 2 else (1, -1, 1)
    y = (x - bn.running_mean.reshape(shape)) * torch.rsqrt(
        bn.running_var.reshape(shape) + eps
    )
    return y * bn.weight.reshape(shape) + bn.bias.reshape(shape)


# the data group of a sharded step (synced_batchnorm); None: local moments
_BN_GROUP = contextvars.ContextVar("bn_group", default=None)


@contextlib.contextmanager
def synced_batchnorm(group):
    """Within this context (of the calling thread only),
    :func:`batchnorm1d_train` takes its moments over ``group`` (a mesh's
    ``AxisGroup``; None: this process's batch alone)."""
    token = _BN_GROUP.set(group)
    try:
        yield
    finally:
        _BN_GROUP.reset(token)


def batchnorm1d_train(bn: nn.BatchNorm1d, x, *, momentum: float = 0.1,
                      eps: float = 1e-5):
    """Training-mode BatchNorm over ``(B, C, T)`` or ``(B, C)``: normalise
    with the batch's mean and biased variance (padded columns included)
    and return ``(y, (running_mean, running_var))``, the running
    statistics moved toward the batch's mean and unbiased variance.  The
    module's buffers are read, never written.

    Under :func:`synced_batchnorm` the batch is the data group's: each
    rank holds an equal block of its rows, the mean and then the mean
    squared deviation are summed over the group (in float32, through the
    differentiable all-reduce of ``parallel/collectives.py``) and divided
    by the global count, which the unbiased variance uses too: the
    moments of the joined batch, as GSPMD computes them for the JAX
    package's sharded step."""
    dims = (0,) if x.dim() == 2 else (0, 2)
    shape = (1, -1) if x.dim() == 2 else (1, -1, 1)
    group = _BN_GROUP.get()
    if group is None or group.pg is None:
        mean = x.mean(dim=dims)
        var = x.var(dim=dims, unbiased=False)
        n = x.numel() // x.shape[1]
    else:
        from ..parallel.collectives import all_reduce_sum

        n = x.numel() // x.shape[1] * group.size
        xf = x.float()
        mean = all_reduce_sum(xf.sum(dim=dims), group) / n
        d = xf - mean.reshape(shape)
        var = all_reduce_sum((d * d).sum(dim=dims), group) / n
        mean, var = mean.to(x.dtype), var.to(x.dtype)
    unbiased = var * n / max(n - 1, 1)
    new_state = ((1 - momentum) * bn.running_mean + momentum * mean,
                 (1 - momentum) * bn.running_var + momentum * unbiased)
    y = (x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + eps)
    return (y * bn.weight.reshape(shape) + bn.bias.reshape(shape),
            new_state)


# ---------------------------------------------------------------- dropout

def dropout(x, mask, rate: float):
    """Inverted dropout with an injected raw 0/1 ``mask`` of ``x``'s
    shape: ``where(mask, x / keep, 0)``; the identity when ``rate`` is 0.
    The mask is never premultiplied by ``1/keep`` (an ulp off for a keep
    such as 0.9)."""
    if rate == 0.0:
        return x
    return torch.where(mask != 0, x / (1.0 - rate), 0.0)


# -------------------------------------------------------------- embedding

@torch.no_grad()
def init_embedding(emb: nn.Embedding, generator: torch.Generator, *,
                   scaled_uniform: bool = False):
    """The reference char-embedding init U(±√3·√(2/(V+D))) when
    ``scaled_uniform``, else N(0, 1)."""
    V, D = emb.weight.shape
    if scaled_uniform:
        uniform_(emb.weight, math.sqrt(3.0) * math.sqrt(2.0 / (V + D)),
                 generator)
    else:
        emb.weight.copy_(torch.randn(
            emb.weight.shape, generator=generator, device=generator.device
        ))
    return emb


def embedding(ids, weight):
    return F.embedding(ids, weight)
