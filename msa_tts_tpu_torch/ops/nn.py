"""Neural-net primitives (counterpart of ``msa_tts_tpu/ops/nn.py``).

Modules are named as the reference names them (``LinearNorm`` holds
``linear_layer``, ``ConvNorm`` holds ``conv``) so that ``state_dict``
keys are the reference checkpoint's.  Initializers draw from an explicit
``torch.Generator`` with the JAX package's distributions:
xavier-uniform by nonlinearity gain for linear and conv weights, zero
biases, U(±1/√H) for LSTM cells.

The ``*_of`` products take the module that holds the weights, so that
under ``parallel.tp.tp_products`` they run partitioned (``parallel/
tp.py``); outside it they are the plain ops on the module's tensors.
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


# the tensor-parallel products in force (parallel.tp.tp_products); None:
# every module's tensors are whole
_TP = contextvars.ContextVar("tp_products", default=None)


def tp_active():
    """The ``parallel.tp.TensorParallel`` of the calling thread, or None."""
    return _TP.get()


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
        return linear_of(self.linear_layer, x)


def linear_of(lin: nn.Linear, x):
    """``lin(x)`` (``x @ weight.T + bias``, the torch (out, in) weight
    layout), partitioned under ``tp_products``."""
    tp = _TP.get()
    return lin(x) if tp is None else tp.linear(lin, x)


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


def conv1d_of(conv: nn.Conv1d, x, *, padding: int = 0):
    """1-D convolution of ``(B, C, T)`` inputs (torch NCW layout) with
    ``conv``'s weight and bias, partitioned under ``tp_products``."""
    tp = _TP.get()
    if tp is None:
        return F.conv1d(x, conv.weight, conv.bias, padding=padding)
    return tp.conv1d(conv, x, padding)


# ------------------------------------------------------------- batch norm

def _bn_tensors(bn: nn.BatchNorm1d):
    """``bn``'s weight, bias, running mean and variance, whole."""
    names = ("weight", "bias", "running_mean", "running_var")
    tp = _TP.get()
    if tp is None:
        return tuple(getattr(bn, n) for n in names)
    return tuple(tp.full(bn, n) for n in names)


def batchnorm1d(bn: nn.BatchNorm1d, x, *, eps: float | None = None):
    """Eval-mode BatchNorm over ``(B, C, T)`` or ``(B, C)`` from the
    running statistics, written as the JAX package writes it
    (``(x - mean) · rsqrt(var + eps) · weight + bias``)."""
    eps = bn.eps if eps is None else eps
    shape = (1, -1) if x.dim() == 2 else (1, -1, 1)
    weight, bias, running_mean, running_var = _bn_tensors(bn)
    y = (x - running_mean.reshape(shape)) * torch.rsqrt(
        running_var.reshape(shape) + eps
    )
    return y * weight.reshape(shape) + bias.reshape(shape)


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
    package's sharded step.  Under ``tp_products`` the scales and
    statistics are joined for use and the new statistics cut back to
    their shards."""
    weight, bias, running_mean, running_var = _bn_tensors(bn)
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
    new_state = ((1 - momentum) * running_mean + momentum * mean,
                 (1 - momentum) * running_var + momentum * unbiased)
    tp = _TP.get()
    if tp is not None:
        new_state = tuple(tp.local_state(bn, k, v) for k, v in zip(
            ("running_mean", "running_var"), new_state))
    y = (x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + eps)
    return (y * weight.reshape(shape) + bias.reshape(shape),
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


def embedding_of(emb: nn.Embedding, ids):
    """The rows of ``emb``'s table at ``ids``, partitioned under
    ``tp_products``."""
    tp = _TP.get()
    return F.embedding(ids, emb.weight) if tp is None else tp.embedding(
        emb, ids)
