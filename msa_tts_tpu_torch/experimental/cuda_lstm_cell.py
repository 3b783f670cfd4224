"""Fused LSTM cell as a CUDA kernel (counterpart of
``msa_tts_tpu/experimental/pallas_lstm_cell.py``).

``cuda_lstm_cell`` computes one LSTM step in one launch of
``csrc/lstm_cell.cu``: the recurrent product, the gates and the state
update, so the (B, 4H) gate pre-activations never reach device memory.
The input projection ``x @ W_ih^T + b`` is computed outside (for a scan
it is one large product over all steps).  ``lstm_cell_reference`` is its
plain PyTorch version; ``lstm_scan`` is its path: the kernel once a step
over a sequence.  No product path of the package calls it (the decoder
kernels fuse their LSTMs into the whole step); it is kept as the tested
starting point for a standalone cell.

Weight layout: ``w_hh_t`` is the transposed recurrent weight (H, 4H),
gates i, f, g, o along the second axis, f32 or bf16 (then ``h`` is
rounded to bf16 before the product; sums are f32).  H must be a multiple
of 8, the kernel's block of hidden units.  What the TPU kernel needed
and this one does not carry over: ``block_h`` and ``interpret``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..kernels.build import load

# Incremented once per launch of the cell kernel, and nowhere else.
CELL_LAUNCHES = 0

UNITS = 8     # hidden units per block of the kernel: H % UNITS == 0


def prepare_weights(cell) -> dict:
    """An LSTM cell's torch-layout parameters (an ``nn.LSTMCell`` or a
    dict with its keys) in the kernel's layout: ``{"w_ih": (4H, in),
    "bias": (4H,) both biases summed, "w_hh_t": (H, 4H)}``."""
    get = cell.get if isinstance(cell, dict) else cell.__getattr__
    return {
        "w_ih": get("weight_ih"),
        "bias": get("bias_ih") + get("bias_hh"),
        "w_hh_t": get("weight_hh").T.contiguous(),
    }


def lstm_cell_reference(x_proj, h, c, w_hh_t):
    """One LSTM step, plain PyTorch: the function the kernel computes.
    ``x_proj`` (B, 4H) holds the input projection and both biases."""
    if w_hh_t.dtype == torch.float32:
        gates = x_proj + h @ w_hh_t
    else:
        gates = x_proj + (h.to(w_hh_t.dtype).to(torch.float32)
                          @ w_hh_t.to(torch.float32))
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


@functools.cache
def _lib():
    lib = load("lstm_cell")
    lib.lstm_cell_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p]
    lib.lstm_cell_launch.restype = ctypes.c_int
    lib.lstm_cell_smem_bytes.argtypes = [ctypes.c_int]
    lib.lstm_cell_smem_bytes.restype = ctypes.c_size_t
    lib.lstm_cell_units.argtypes = []
    lib.lstm_cell_units.restype = ctypes.c_int
    lib.lstm_cell_error_string.argtypes = [ctypes.c_int]
    lib.lstm_cell_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, x, shape, dtypes, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {x.dtype}, expected one of "
                        f"{dtypes}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _validate(x_proj, h, c, w_hh_t, h_out, c_out):
    """Raise unless the kernel takes these tensors; returns the library."""
    device = h.device
    if device.type != "cuda":
        raise ValueError(f"cuda_lstm_cell needs CUDA tensors, got {device}")
    if h.dim() != 2:
        raise ValueError("h must be (B, H)")
    B, H = h.shape
    if B < 1 or H < 1 or H % UNITS:
        raise ValueError(f"H={H} must be a positive multiple of {UNITS} "
                         f"and B={B} positive")
    f32 = (torch.float32,)
    _check("x_proj", x_proj, (B, 4 * H), f32, device)
    _check("h", h, (B, H), f32, device)
    _check("c", c, (B, H), f32, device)
    _check("w_hh_t", w_hh_t, (H, 4 * H), (torch.float32, torch.bfloat16),
           device)
    _check("h_out", h_out, (B, H), f32, device)
    _check("c_out", c_out, (B, H), f32, device)
    ins = {t.data_ptr() for t in (x_proj, h, c)}
    if h_out.data_ptr() in ins or c_out.data_ptr() in ins \
            or h_out.data_ptr() == c_out.data_ptr():
        raise ValueError("the outputs must not alias the inputs or each "
                         "other")
    lib = _lib()
    if lib.lstm_cell_units() != UNITS:
        raise RuntimeError("lstm_cell: the library's unit block differs")
    smem = lib.lstm_cell_smem_bytes(H)
    if smem > 227 * 1024:
        raise ValueError(
            f"H={H} needs {smem} bytes of shared memory per block (more "
            "than the 227 KB a Hopper block can use)")
    return lib


def _launch(lib, x_proj, h, c, w_hh_t, h_out, c_out):
    """One launch on the current stream from validated tensors."""
    global CELL_LAUNCHES
    B, H = h.shape
    ptrs = (ctypes.c_void_p * 6)(
        x_proj.data_ptr(), h.data_ptr(), c.data_ptr(), w_hh_t.data_ptr(),
        h_out.data_ptr(), c_out.data_ptr())
    stream = torch.cuda.current_stream(h.device).cuda_stream
    rc = lib.lstm_cell_launch(ptrs, B, H,
                              int(w_hh_t.dtype == torch.bfloat16),
                              ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError("lstm_cell launch failed: "
                           + lib.lstm_cell_error_string(rc).decode())
    CELL_LAUNCHES += 1


@torch.no_grad()
def cuda_lstm_cell(x_proj, h, c, w_hh_t, *, out=None):
    """Drop-in for :func:`lstm_cell_reference` as one kernel launch:
    returns ``(h_new, c_new)``, each (B, H) f32.  ``out``: an optional
    ``(h_out, c_out)`` pair of (B, H) f32 buffers to write into (they
    must not be ``h`` or ``c``).

    Takes contiguous CUDA tensors (f32; ``w_hh_t`` f32 or bf16) and
    raises on anything else: there is no fallback to the plain version."""
    if out is None:
        out = (torch.empty_like(h), torch.empty_like(c))
    lib = _validate(x_proj, h, c, w_hh_t, *out)
    with torch.cuda.device(h.device):
        _launch(lib, x_proj, h, c, w_hh_t, *out)
    return out


@torch.no_grad()
def lstm_scan(x_proj_seq, h0, c0, w_hh_t, *, backend: str = "auto"):
    """An LSTM over a sequence from its hoisted input projection
    ``x_proj_seq`` (T, B, 4H): one cell a step, the kernel on CUDA
    tensors (one launch a step; the arguments are checked once, at the
    first step) and the plain cell on CPU tensors (``backend`` as in
    ``utils.backend``).  Returns ``(h_seq (T, B, H), (h_T, c_T))``."""
    from ..utils.backend import resolve_kernel_backend

    T, B, _ = x_proj_seq.shape
    H = h0.shape[1]
    if resolve_kernel_backend(backend, h0.device) != "cuda":
        h, c, hs = h0, c0, []
        for t in range(T):
            h, c = lstm_cell_reference(x_proj_seq[t], h, c, w_hh_t)
            hs.append(h)
        return torch.stack(hs), (h, c)
    if not x_proj_seq.is_contiguous():
        raise ValueError("x_proj_seq is not contiguous")
    h_seq = torch.empty(T, B, H, dtype=torch.float32, device=h0.device)
    cs = (torch.empty_like(c0), torch.empty_like(c0))
    h, c = h0.contiguous(), c0.contiguous()
    lib = _validate(x_proj_seq[0], h, c, w_hh_t, h_seq[0], cs[0])
    with torch.cuda.device(h0.device):
        for t in range(T):
            _launch(lib, x_proj_seq[t], h, c, w_hh_t, h_seq[t], cs[t & 1])
            h, c = h_seq[t], cs[t & 1]
    return h_seq, (h, c.clone())
