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
rounded to bf16 before the product; sums are f32).  The kernel reads it
packed (:func:`pack_weights`, made once per weight tensor and kept by
:func:`packed_weights`): a cluster of ``KSPLIT`` blocks owns ``UNITS``
hidden units, so H must be a multiple of 8.  What the TPU kernel needed
and this one does not carry over: ``block_h`` and ``interpret``.
"""

from __future__ import annotations

import ctypes
import functools
import weakref

import torch

from ..kernels.build import load
from ..kernels.mma import frag_index

# Incremented once per launch of the cell kernel, and nowhere else.
CELL_LAUNCHES = 0

# The kernel's constants (csrc/lstm_cell.cu), mirrored for the packing
# and the shared-memory plan.
UNITS = 8       # hidden units per cluster: H % UNITS == 0
KSPLIT = 2      # blocks per cluster, each one share of the inputs K
NW = 8          # warps per block
ROWS = 16       # batch rows of one m16 tile (and of an f32 pass)
MT_MAX = 4      # bf16: m16 tiles per pass over the weights
TILES = UNITS // 2  # bf16: n8 tiles per cluster (4 gates of 2 units)
RING_BF16 = 4   # bf16: k-steps (TILES x 8 bytes) in flight per lane
RING_F32 = 3    # f32: groups of 4 inputs (64 bytes) in flight per lane
KQ = 32 // UNITS  # f32: lanes of a warp along K
SMEM_MAX = 227 * 1024


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


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def k_steps(H: int) -> int:
    """bf16: the 16-input k-steps of K (padded with zero rows)."""
    return _cdiv(H, 16)


@torch.no_grad()
def pack_weights(w_hh_t: torch.Tensor) -> torch.Tensor:
    """``w_hh_t`` (H, 4H) in the kernel's layout, on its device and in its
    type.  Column ``g·H + U·j + u`` (gate g of unit U·j + u) goes to
    cluster j.

    f32: (H/U, H/4, 4, U, 4) = [j, q, k, u, gate] holds
    ``w_hh_t[4q + k, gate·H + U·j + u]`` (U = ``UNITS``): a lane of unit
    u reads one float4 (the four gates) per input.

    bf16: (H/U, KS, U/4, 32, 2, 4) = [j, s, pair, lane, tile, e], the
    B fragments of ``mma.sync.m16n8k16`` for k-step s (inputs 16s ..
    16s + 15, zero beyond H): n8 tile ``2·pair + tile`` holds units
    ``2·(2·pair + tile) + n // 4``, gate ``n % 4`` in its column n, and
    lane l's value e is its (n, k) entry at ``frag_index(True)[.][l, e]``;
    a lane's 16 bytes of each pair of tiles are one copy."""
    H, U = w_hh_t.shape[0], UNITS
    if w_hh_t.dtype != torch.bfloat16:
        return (w_hh_t.reshape(H // 4, 4, 4, H // U, U)
                .permute(3, 0, 1, 4, 2).contiguous())
    KS = k_steps(H)
    wp = torch.nn.functional.pad(w_hh_t, (0, 0, 0, 16 * KS - H))
    t = (wp.reshape(KS, 16, 4, H // U, U).permute(3, 0, 4, 2, 1)
         .reshape(H // U, KS, TILES, 8, 16))
    fr, fc = (torch.as_tensor(a, device=w_hh_t.device)
              for a in frag_index(True))
    return (t[..., fr, fc].reshape(H // U, KS, TILES // 2, 2, 32, 4)
            .permute(0, 1, 2, 4, 3, 5).contiguous())


@torch.no_grad()
def unpack_weights(packed: torch.Tensor, H: int) -> torch.Tensor:
    """The inverse of :func:`pack_weights`: ``w_hh_t`` (H, 4H)."""
    U = UNITS
    if packed.dtype != torch.bfloat16:
        return packed.permute(1, 2, 4, 0, 3).reshape(H, 4 * H)
    KS = k_steps(H)
    frags = packed.permute(0, 1, 2, 4, 3, 5).reshape(H // U, KS, TILES, 32,
                                                     4)
    t = torch.zeros(H // U, KS, TILES, 8, 16, dtype=packed.dtype,
                    device=packed.device)
    fr, fc = (torch.as_tensor(a, device=packed.device)
              for a in frag_index(True))
    t[..., fr, fc] = frags
    return (t.reshape(H // U, KS, U, 4, 16).permute(1, 4, 3, 0, 2)
            .reshape(16 * KS, 4 * H)[:H])


# (data_ptr, dtype, device, shape) -> (weakref to the weight, its
# version counter, the packing); see packed_weights
_PACKED: dict = {}
_PACKED_MAX = 8


def packed_weights(w_hh_t: torch.Tensor) -> torch.Tensor:
    """:func:`pack_weights` kept per weight tensor, keyed on its storage,
    type and version counter: packed again when the tensor is written in
    place (its version moves), never for a tensor it was not made from.
    A write through ``.data`` is not seen.  Each packing is a second copy
    of the weight on its device; the last few are kept."""
    key = (w_hh_t.data_ptr(), w_hh_t.dtype, w_hh_t.device,
           tuple(w_hh_t.shape))
    hit = _PACKED.get(key)
    if hit is not None and hit[0]() is w_hh_t \
            and hit[1] == w_hh_t._version:
        return hit[2]
    packed = pack_weights(w_hh_t)
    for k in [k for k, v in _PACKED.items() if v[0]() is None]:
        del _PACKED[k]
    _PACKED.pop(key, None)
    while len(_PACKED) >= _PACKED_MAX:
        del _PACKED[next(iter(_PACKED))]
    _PACKED[key] = (weakref.ref(w_hh_t), w_hh_t._version, packed)
    return packed


def bf16_tiles(B: int) -> int:
    """bf16: the m16 tiles of one pass over the weights (1-4)."""
    return min(_cdiv(B, ROWS), MT_MAX)


def smem_bytes(B: int, H: int, bf16: bool) -> int:
    """Dynamic shared memory of one block at (B, H), as the kernel lays
    it out: the weight ring, one region a warp (its staged h, then its
    partial sums) and the block's sum."""
    mt = bf16_tiles(B) if bf16 else 1
    red = ROWS * mt * 4 * UNITS * 4
    if bf16:
        n = _cdiv(_cdiv(k_steps(H), KSPLIT), NW)
        ring, hs = NW * 32 * RING_BF16 * TILES * 8, n * mt * 32 * 32
    else:
        n = _cdiv(_cdiv(H // 4, KSPLIT), NW * KQ)
        ring, hs = NW * 32 * RING_F32 * 64, n * ROWS * KQ * 16
    return ring + NW * max(hs, red) + red


@functools.cache
def _lib():
    lib = load("lstm_cell")
    lib.lstm_cell_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p]
    lib.lstm_cell_launch.restype = ctypes.c_int
    lib.lstm_cell_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int]
    lib.lstm_cell_smem_bytes.restype = ctypes.c_size_t
    for fn in (lib.lstm_cell_units, lib.lstm_cell_ksplit):
        fn.argtypes = []
        fn.restype = ctypes.c_int
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
    if x.data_ptr() % 16:
        raise ValueError(f"{name} is not 16-byte aligned")


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
    bf16 = w_hh_t.dtype == torch.bfloat16
    smem = smem_bytes(B, H, bf16)
    if smem > SMEM_MAX:
        raise ValueError(
            f"H={H} needs {smem} bytes of shared memory per block (more "
            f"than the {SMEM_MAX} a Hopper block can use)")
    lib = _lib()
    if (lib.lstm_cell_units(), lib.lstm_cell_ksplit()) != (UNITS, KSPLIT) \
            or lib.lstm_cell_smem_bytes(B, H, int(bf16)) != smem:
        raise RuntimeError("lstm_cell: the library's layout differs from "
                           "the wrapper's")
    return lib


def _launch(lib, ptrs, B, H, bf16, chained, stream):
    """One launch on ``stream`` from validated pointers (``chained``: the
    stream's previous launch is this kernel's, a scan's previous step)."""
    global CELL_LAUNCHES
    rc = lib.lstm_cell_launch(ptrs, B, H, bf16, chained, stream)
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
    B, H = h.shape
    with torch.cuda.device(h.device):
        packed = packed_weights(w_hh_t)
        ptrs = (ctypes.c_void_p * 6)(
            x_proj.data_ptr(), h.data_ptr(), c.data_ptr(),
            packed.data_ptr(), out[0].data_ptr(), out[1].data_ptr())
        stream = torch.cuda.current_stream(h.device).cuda_stream
        _launch(lib, ptrs, B, H, int(w_hh_t.dtype == torch.bfloat16), 0,
                ctypes.c_void_p(stream))
    return out


@torch.no_grad()
def lstm_scan(x_proj_seq, h0, c0, w_hh_t, *, backend: str = "auto"):
    """An LSTM over a sequence from its hoisted input projection
    ``x_proj_seq`` (T, B, 4H): one cell a step, the kernel on CUDA
    tensors (one launch a step; the arguments are checked, the weights
    packed and the launch's arguments built once, at the first step,
    then only the pointers move; each later step is launched to start
    as the one before ends, fetching its weights while that one
    finishes) and the plain cell on CPU tensors
    (``backend`` as in ``utils.backend``).  Returns
    ``(h_seq (T, B, H), (h_T, c_T))``."""
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
    cs = torch.empty(2, B, H, dtype=torch.float32, device=h0.device)
    h, c = h0.contiguous(), c0.contiguous()
    lib = _validate(x_proj_seq[0], h, c, w_hh_t, h_seq[0], cs[0])
    bf16 = int(w_hh_t.dtype == torch.bfloat16)
    with torch.cuda.device(h0.device):
        packed = packed_weights(w_hh_t)
        stream = ctypes.c_void_p(
            torch.cuda.current_stream(h0.device).cuda_stream)
        ptrs = (ctypes.c_void_p * 6)(
            x_proj_seq.data_ptr(), h.data_ptr(), c.data_ptr(),
            packed.data_ptr(), h_seq.data_ptr(), cs.data_ptr())
        x0, hs0, cs0 = (x_proj_seq.data_ptr(), h_seq.data_ptr(),
                        cs.data_ptr())
        x_step, h_step = 16 * B * H, 4 * B * H    # bytes a step
        for t in range(T):
            if t:
                ptrs[0] = x0 + t * x_step
                ptrs[1] = hs0 + (t - 1) * h_step
                ptrs[2] = cs0 + ((t - 1) & 1) * h_step
                ptrs[4] = hs0 + t * h_step
                ptrs[5] = cs0 + (t & 1) * h_step
            _launch(lib, ptrs, B, H, bf16, int(t > 0), stream)
    return h_seq, (h_seq[T - 1], cs[(T - 1) & 1].clone())
