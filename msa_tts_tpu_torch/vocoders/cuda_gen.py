"""WaveRNN sample loop as one CUDA kernel launch (counterpart of
``msa_tts_tpu/vocoders/pallas_gen.py``).

``cuda_generate`` runs all T steps for all B fold rows in one persistent
cooperative launch of ``csrc/wavernn_loop.cu`` and returns what
``wavernn.sample_loop`` (its plain PyTorch version) returns, from the
same pre-drawn noise.  Weight matrices may be f32 or bf16 (inputs of
each product rounded to bf16, f32 sums and gates).

What the TPU kernel needed and this one does not carry over: the time
chunks and their padding of T, the row groups, the (rows, 8) lane-width
scratch for the previous sample, the VMEM limit and the 1,536-row gate.
Any B and T are served; rows are tiled inside the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..kernels.build import load
from .wavernn import WaveRNNConfig

# Incremented once per launch of the sample-loop kernel, and nowhere
# else: a run reads it to show that its vocoding went through the kernel.
GEN_LAUNCHES = 0

_W_NAMES = (
    "rnn1_ih", "rnn1_hh", "rnn1_bih", "rnn1_bhh",
    "rnn2_ih_z", "rnn2_ih_a", "rnn2_hh", "rnn2_bih", "rnn2_bhh",
    "fc1_z", "fc1_a", "fc1_b", "fc2_z", "fc2_a", "fc2_b",
    "fc3_w", "fc3_b", "w_x",
)
_MATRICES = ("rnn1_ih", "rnn1_hh", "rnn2_ih_z", "rnn2_ih_a", "rnn2_hh",
             "fc1_z", "fc1_a", "fc2_z", "fc2_a", "fc3_w")


def split_generation_params(params: dict, cfg: WaveRNNConfig) -> dict:
    """Repack the sample-loop weights as the JAX package's kernel takes
    them: every matrix transposed to (in, out), the concat-input layers
    (rnn2, fc1, fc2) split into their z- and aux-addressed halves (zero
    blocks without the aux net), biases as (1, out) f32 rows, and the
    sample column of ``I`` as ``w_x``.  Weight dtypes are preserved (run
    ``cast_generation_params`` first for bf16 weights).  The CUDA kernel
    takes :func:`kernel_weights`, packed straight from ``params``; this
    layout is kept for exchanging weights with the JAX kernel."""
    d = cfg.aux_dims

    def t(w):
        return w.transpose(0, 1)

    def b(v):
        return v.to(torch.float32)[None, :]

    p = {
        "rnn1_ih": t(params["rnn1"]["weight_ih"]),
        "rnn1_hh": t(params["rnn1"]["weight_hh"]),
        "rnn1_bih": b(params["rnn1"]["bias_ih"]),
        "rnn1_bhh": b(params["rnn1"]["bias_hh"]),
        "rnn2_hh": t(params["rnn2"]["weight_hh"]),
        "rnn2_bih": b(params["rnn2"]["bias_ih"]),
        "rnn2_bhh": b(params["rnn2"]["bias_hh"]),
        "fc3_w": t(params["fc3"]["weight"]),
        "fc3_b": b(params["fc3"]["bias"]),
        "w_x": b(params["I"]["weight"][:, 0]),
    }
    r2 = t(params["rnn2"]["weight_ih"])     # (rnn[+d], 3·rnn)
    f1 = t(params["fc1"]["weight"])
    f2 = t(params["fc2"]["weight"])
    if cfg.use_aux_net:
        p["rnn2_ih_z"], p["rnn2_ih_a"] = r2[: cfg.rnn_dims], r2[cfg.rnn_dims:]
        p["fc1_z"], p["fc1_a"] = f1[: cfg.rnn_dims], f1[cfg.rnn_dims:]
        p["fc2_z"], p["fc2_a"] = f2[: cfg.fc_dims], f2[cfg.fc_dims:]
    else:
        p["rnn2_ih_z"], p["fc1_z"], p["fc2_z"] = r2, f1, f2
        p["rnn2_ih_a"] = r2.new_zeros((d, 3 * cfg.rnn_dims))
        p["fc1_a"] = f1.new_zeros((d, cfg.fc_dims))
        p["fc2_a"] = f2.new_zeros((d, cfg.fc_dims))
    p["fc1_b"] = b(params["fc1"]["bias"])
    p["fc2_b"] = b(params["fc2"]["bias"])
    return p


@torch.no_grad()
def kernel_weights(params: dict, cfg: WaveRNNConfig) -> dict:
    """The sample-loop weights in the kernel's memory layout, straight
    from the module's (out, in) matrices: every matrix contiguous, so a
    warp reads one output's row with neighbouring lanes on neighbouring
    addresses; the concat-input layers (rnn2, fc1, fc2) split by columns
    into their z- and aux-addressed parts (None without the aux net: the
    kernel skips those products); biases and ``w_x`` flat f32.  The same
    values as :func:`split_generation_params`, transposed.  A second
    copy of the sample-loop weights on their device (15 MB in f32 at the
    default width): callers that vocode repeatedly keep it (``WaveRNN``
    does)."""
    def vec(v):
        return v.to(torch.float32).contiguous()

    w = {
        "rnn1_ih": params["rnn1"]["weight_ih"].contiguous(),
        "rnn1_hh": params["rnn1"]["weight_hh"].contiguous(),
        "rnn1_bih": vec(params["rnn1"]["bias_ih"]),
        "rnn1_bhh": vec(params["rnn1"]["bias_hh"]),
        "rnn2_hh": params["rnn2"]["weight_hh"].contiguous(),
        "rnn2_bih": vec(params["rnn2"]["bias_ih"]),
        "rnn2_bhh": vec(params["rnn2"]["bias_hh"]),
        "fc1_b": vec(params["fc1"]["bias"]),
        "fc2_b": vec(params["fc2"]["bias"]),
        "fc3_w": params["fc3"]["weight"].contiguous(),
        "fc3_b": vec(params["fc3"]["bias"]),
        "w_x": vec(params["I"]["weight"][:, 0]),
    }
    for name, layer, key, n_z in (("rnn2_ih", "rnn2", "weight_ih",
                                   cfg.rnn_dims),
                                  ("fc1", "fc1", "weight", cfg.rnn_dims),
                                  ("fc2", "fc2", "weight", cfg.fc_dims)):
        m = params[layer][key]
        w[name + "_z"] = m[:, :n_z].contiguous()
        w[name + "_a"] = (m[:, n_z:].contiguous() if cfg.use_aux_net
                          else None)
    return w


@functools.cache
def _lib():
    lib = load("wavernn_loop")
    lib.wavernn_loop_launch.argtypes = [ctypes.c_void_p] * 3
    lib.wavernn_loop_launch.restype = ctypes.c_int
    for fn in (lib.wavernn_loop_scratch_floats, lib.wavernn_loop_smem_bytes):
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = ctypes.c_size_t
    lib.wavernn_loop_error_string.argtypes = [ctypes.c_int]
    lib.wavernn_loop_error_string.restype = ctypes.c_char_p
    lib.wavernn_loop_n_ptrs.argtypes = []
    lib.wavernn_loop_n_ptrs.restype = ctypes.c_int
    return lib


def _check(name, x, shape, dtype, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


@torch.no_grad()
def cuda_generate(w: dict, cfg: WaveRNNConfig, i_static, a_rest, noise1,
                  noise2):
    """Drop-in for :func:`wavernn.sample_loop` running the whole loop in
    one CUDA kernel launch.  ``w``: :func:`kernel_weights`; the other
    arguments as there: ``i_static`` (T, B, rnn), ``a_rest`` (T, B,
    3·aux) (last axis empty without the aux net), MOL noise (T, B, K) and
    (T, B), Gaussian noise (T, B) and anything.  Returns samples (B, T).

    Takes contiguous CUDA float32 tensors (weight matrices f32 or bf16,
    all of one type) and raises on anything else: there is no fallback
    to the plain version."""
    global GEN_LAUNCHES
    device = i_static.device
    if device.type != "cuda":
        raise ValueError(f"cuda_generate needs CUDA tensors, got {device}")
    if cfg.mode not in ("MOL", "GAUSS"):
        raise ValueError(cfg.mode)
    if i_static.dim() != 3:
        raise ValueError("i_static must be (T, B, rnn_dims)")
    T, B, R = i_static.shape
    F_, NC = cfg.fc_dims, cfg.n_classes
    D = cfg.aux_dims if cfg.use_aux_net else 0
    gauss = cfg.mode == "GAUSS"
    K = 0 if gauss else NC // 3
    if T < 1 or B < 1:
        raise ValueError(f"empty generation: T={T}, B={B}")
    if R != cfg.rnn_dims or R % 4 or F_ % 4:
        raise ValueError(
            f"rnn_dims {R} (config {cfg.rnn_dims}) and fc_dims {F_} must "
            "be multiples of 4 (the kernel loads weights 4 at a time)")
    f32 = torch.float32
    _check("i_static", i_static, (T, B, R), f32, device)
    _check("a_rest", a_rest, (T, B, 3 * D), f32, device)
    if gauss:
        _check("noise1", noise1, (T, B), f32, device)
        n1, n2 = None, noise1
    else:
        _check("noise1", noise1, (T, B, K), f32, device)
        _check("noise2", noise2, (T, B), f32, device)
        n1, n2 = noise1, noise2
    wdt = w["rnn1_ih"].dtype
    if wdt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"weight matrices are {wdt}: expected float32 or "
                        "bfloat16")
    da = cfg.aux_dims
    shapes = {
        "rnn1_ih": (3 * R, R), "rnn1_hh": (3 * R, R), "rnn1_bih": (3 * R,),
        "rnn1_bhh": (3 * R,), "rnn2_ih_z": (3 * R, R),
        "rnn2_ih_a": (3 * R, da), "rnn2_hh": (3 * R, R),
        "rnn2_bih": (3 * R,), "rnn2_bhh": (3 * R,), "fc1_z": (F_, R),
        "fc1_a": (F_, da), "fc1_b": (F_,), "fc2_z": (F_, F_),
        "fc2_a": (F_, da), "fc2_b": (F_,), "fc3_w": (NC, F_),
        "fc3_b": (NC,), "w_x": (R,),
    }
    for k in _W_NAMES:
        if not D and k.endswith("_a"):
            # no aux net: no such product, the kernel gets a null pointer
            if w[k] is not None:
                raise ValueError(f"{k} given for a net without the aux net")
            continue
        _check(k, w[k], shapes[k], wdt if k in _MATRICES else f32, device)

    lib = _lib()
    dims = (ctypes.c_int * 9)(T, B, R, F_, D, NC, K, int(gauss),
                              int(wdt == torch.bfloat16))
    smem = lib.wavernn_loop_smem_bytes(dims)
    if smem > 227 * 1024:
        raise ValueError(
            f"widths need {smem} bytes of shared memory per block (more "
            "than the 227 KB a Hopper block can use)")
    out = torch.empty(B, T, dtype=f32, device=device)
    scratch = torch.empty(lib.wavernn_loop_scratch_floats(dims), dtype=f32,
                          device=device)
    tensors = (i_static, a_rest if D else None, n1, n2,
               *(w[k] for k in _W_NAMES), out, scratch)
    if len(tensors) != lib.wavernn_loop_n_ptrs():
        raise RuntimeError("wavernn_loop: pointer list does not match the "
                           "library's")
    ptrs = (ctypes.c_void_p * len(tensors))(
        *(None if t is None else t.data_ptr() for t in tensors))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.wavernn_loop_launch(ptrs, dims, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError("wavernn_loop launch failed: "
                           + lib.wavernn_loop_error_string(rc).decode())
    GEN_LAUNCHES += 1
    return out
