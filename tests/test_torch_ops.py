"""PyTorch port ops (msa_tts_tpu_torch/ops, utils/backend) against the JAX
package's ops on the same numpy inputs, atol 1e-6 (f32 on the CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msa_tts_tpu.ops import masking as JM
from msa_tts_tpu.ops import nn as JN
from msa_tts_tpu.ops import rnn as JR
from msa_tts_tpu_torch.ops import masking as M
from msa_tts_tpu_torch.ops import nn as N
from msa_tts_tpu_torch.ops import rnn as R
from msa_tts_tpu_torch.utils.backend import resolve_kernel_backend

ATOL = 1e-6


def _r(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32
    )


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(
        np.asarray(a.detach() if hasattr(a, "detach") else a),
        np.asarray(b), atol=atol, rtol=0,
    )


def _holding(module, **tensors):
    """``module`` with its tensors set to ``tensors`` (numpy arrays)."""
    with torch.no_grad():
        for k, v in tensors.items():
            getattr(module, k).copy_(torch.from_numpy(v))
    return module


def test_linear():
    x, w, b = _r(0, 4, 7, 12), _r(1, 5, 12), _r(2, 5)
    ref = JN.linear({"weight": jnp.asarray(w), "bias": jnp.asarray(b)},
                    jnp.asarray(x))
    lin = _holding(torch.nn.Linear(12, 5), weight=w, bias=b)
    _close(N.linear_of(lin, torch.from_numpy(x)), ref)


def test_conv1d_same_padding():
    x, w, b = _r(0, 3, 6, 11), _r(1, 4, 6, 5), _r(2, 4)
    ref = JN.conv1d({"weight": jnp.asarray(w), "bias": jnp.asarray(b)},
                    jnp.asarray(x), padding=2)
    conv = _holding(torch.nn.Conv1d(6, 4, 5), weight=w, bias=b)
    _close(N.conv1d_of(conv, torch.from_numpy(x), padding=2), ref)


def test_batchnorm_eval():
    x = _r(0, 3, 6, 9)
    w, b, mean = _r(1, 6), _r(2, 6), _r(3, 6)
    var = np.abs(_r(4, 6)) + 0.5
    ref, _ = JN.batchnorm1d(
        {"weight": jnp.asarray(w), "bias": jnp.asarray(b)},
        {"running_mean": jnp.asarray(mean), "running_var": jnp.asarray(var)},
        jnp.asarray(x), train=False,
    )
    bn = torch.nn.BatchNorm1d(6)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(w))
        bn.bias.copy_(torch.from_numpy(b))
        bn.running_mean.copy_(torch.from_numpy(mean))
        bn.running_var.copy_(torch.from_numpy(var))
    _close(N.batchnorm1d(bn, torch.from_numpy(x)), ref)


def test_embedding():
    w = _r(0, 11, 5)
    ids = np.array([[0, 3, 10], [7, 7, 1]], np.int64)
    ref = JN.embedding({"weight": jnp.asarray(w)}, jnp.asarray(ids))
    emb = _holding(torch.nn.Embedding(11, 5), weight=w)
    _close(N.embedding_of(emb, torch.from_numpy(ids)), ref)


def test_sequence_mask():
    lens = np.array([3, 1, 5])
    ref = JM.sequence_mask(jnp.asarray(lens), 6)
    out = M.sequence_mask(torch.from_numpy(lens), 6)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def _lstm_params(seed, n_in, H):
    return {k: _r(seed + i, *shape) * 0.3 for i, (k, shape) in enumerate([
        ("weight_ih", (4 * H, n_in)), ("weight_hh", (4 * H, H)),
        ("bias_ih", (4 * H,)), ("bias_hh", (4 * H,)),
    ])}


def test_lstm_cell():
    n_in, H = 7, 6
    p = _lstm_params(0, n_in, H)
    x, h, c = _r(10, 3, n_in), _r(11, 3, H), _r(12, 3, H)
    ref = JR.lstm_cell({k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(x), (jnp.asarray(h), jnp.asarray(c)))
    cell = torch.nn.LSTMCell(n_in, H)
    cell.load_state_dict({k: torch.from_numpy(v) for k, v in p.items()})
    out = R.lstm_cell(cell, torch.from_numpy(x),
                      (torch.from_numpy(h), torch.from_numpy(c)))
    for a, b in zip(out, ref):
        _close(a, b)


def test_bilstm_ragged_lengths():
    """Packed-sequence semantics: the reverse pass starts at each row's
    last valid step and padded outputs are zero."""
    B, T, D, H = 3, 9, 8, 5
    fw, bw = _lstm_params(0, D, H), _lstm_params(20, D, H)
    x = _r(40, B, T, D)
    lens = np.array([9, 4, 6], np.int64)
    ref = JR.bilstm(
        {"forward": {k: jnp.asarray(v) for k, v in fw.items()},
         "backward": {k: jnp.asarray(v) for k, v in bw.items()}},
        jnp.asarray(x), jnp.asarray(lens),
    )
    lstm = torch.nn.LSTM(D, H, batch_first=True, bidirectional=True)
    sd = {f"{k}_l0": torch.from_numpy(v) for k, v in fw.items()}
    sd.update({f"{k}_l0_reverse": torch.from_numpy(v) for k, v in bw.items()})
    lstm.load_state_dict(sd)
    with torch.no_grad():
        out = R.bilstm(lstm, torch.from_numpy(x), torch.from_numpy(lens))
    _close(out, ref)
    assert float(out[1, 4:].abs().max()) == 0.0


@pytest.mark.parametrize("choice,device,want", [
    ("auto", "cpu", "torch"), (None, "cpu", "torch"),
    ("torch", "cpu", "torch"), ("TORCH", "cpu", "torch"),
    ("auto", "cuda", "cuda"), ("cuda", "cuda", "cuda"),
    ("torch", "cuda", "torch"),
])
def test_resolve_kernel_backend(choice, device, want):
    assert resolve_kernel_backend(choice, device) == want


@pytest.mark.parametrize("choice,device", [
    ("cuda", "cpu"), ("pallas", "cpu"), ("xla", "cuda"),
])
def test_resolve_kernel_backend_rejects(choice, device):
    with pytest.raises(ValueError):
        resolve_kernel_backend(choice, device)
