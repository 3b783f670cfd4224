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

Every block of the launch owns a fixed set of output rows of all five
layers.  With bf16 weights and few fold rows it keeps them in shared
memory for the whole launch, in the fragment order of the tensor-core
instruction; with f32 weights, and with bf16 from
``WEIGHTS_BY_PHASE_ROWS`` rows on, it copies the coming phase's rows
into one shared-memory buffer, so that the rest stages the rows'
activations in larger chunks.
:func:`kernel_weights` packs the rows so (one slice per block, so the
packing names the grid), :func:`unpack_kernel_weights` is its inverse,
and :func:`smem_plan` mirrors the kernel's shared-memory layout, so a
width whose slices do not fit is refused with the numbers before
anything is launched.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..kernels.build import load
from ..kernels.mma import frag_index as _frag_index
from ..utils import profiling
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
    layout is kept for exchanging weights with the JAX kernel, and
    ``_W_NAMES`` / ``_MATRICES`` name its keys."""
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


# ----------------------------------------------------------------------
# The kernel's layout, mirrored: csrc/wavernn_loop.cu::make_plan
# ----------------------------------------------------------------------

H100_SMS = 132              # the grid the packing assumes off the card
SMEM_MAX = 232_448          # bytes of shared memory a Hopper block can use
GRU_PER_TILE = 5            # units (3 gate rows each) in a 16-row tile
FC_PER_TILE = 8             # fc outputs in a tile's lower half
N_BUFFERS = 2               # the kernel's staging buffers
N_STAMPS = 20               # 4 clock stamps x 5 phases a step
GR_MAX = 10                 # most rows of the kernel's sample groups
_PLAN_FIELDS = (
    "slg", "slf", "tg", "tf", "t3", "ks_r", "ks_rd", "ks_f", "ks_fd",
    "w_bytes", "by_phase", "w_smem", "m_rows", "ksplit", "ch", "ps",
    "ch_fc", "ps_fc", "p_r", "p_rd", "p_f", "p_fd", "stride_a", "stride_h",
    "off_stage", "off_part", "off_misc", "total",
)
# bf16 weights are copied in phase by phase from this many fold rows on
# (below it the resident slice's smaller chunks are faster: the H100's
# crossover, PERF.md); f32 weights always are.
WEIGHTS_BY_PHASE_ROWS = 64
# the seven matrices: (key in kernel_weights, layer, parameter, tile kind)
_MATS = (
    ("rnn1_ih", "rnn1", "weight_ih", "gru"),
    ("rnn1_hh", "rnn1", "weight_hh", "gru"),
    ("rnn2_ih", "rnn2", "weight_ih", "gru"),
    ("rnn2_hh", "rnn2", "weight_hh", "gru"),
    ("fc1", "fc1", "weight", "fc"),
    ("fc2", "fc2", "weight", "fc"),
    ("fc3", "fc3", "weight", "fc3"),
)
_VECS = (
    ("rnn1_bih", "rnn1", "bias_ih"), ("rnn1_bhh", "rnn1", "bias_hh"),
    ("rnn2_bih", "rnn2", "bias_ih"), ("rnn2_bhh", "rnn2", "bias_hh"),
    ("fc1_b", "fc1", "bias"), ("fc2_b", "fc2", "bias"),
    ("fc3_b", "fc3", "bias"),
)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _part_pitch(ch: int) -> int:
    """Partial-sum row pitch for ch staged rows (>= ch, 8 mod 16)."""
    return (ch + 7) // 16 * 16 + 8


def smem_plan(R: int, F_: int, D: int, NC: int, K: int, n_blocks: int,
              bf16: bool, by_phase: bool = True) -> dict:
    """The kernel's shared-memory layout for these widths on a grid of
    ``n_blocks``: tile counts, the byte ``sections`` of a block's slice
    of the seven matrices (``w_bytes`` in all), the shared memory they
    take (``w_smem``: with ``by_phase``, always so in f32, the largest
    phase's rows, which the kernel copies in phase by phase, else the
    whole slice), the row pitches of the exchange buffers, the staged
    chunk ``ch`` (the most rows of 40, 32, 24, 16, 8 whose two staging
    buffers fit beside the weights), ``ch_fc`` (an fc phase's chunk; by
    phase, since its rows hold no hidden state, the same two buffers hold
    more, as far as the partial sums' room allows) with the partial-sum
    pitches ``ps`` and ``ps_fc``, byte offsets and the ``total``.
    ``fits`` is false when not even 8 rows fit; ``total`` is then the
    need at 8.  The library's ``wavernn_loop_plan`` computes the same
    numbers; the wrapper holds the two equal before a launch."""
    pl = {"slg": _cdiv(R, n_blocks), "slf": _cdiv(F_, n_blocks)}
    pl["tg"] = _cdiv(pl["slg"], GRU_PER_TILE)
    pl["tf"] = _cdiv(pl["slf"], FC_PER_TILE)
    pl["t3"] = _cdiv(NC, 16)
    pl["ks_r"], pl["ks_rd"] = _cdiv(R, 16), _cdiv(R + D, 16)
    pl["ks_f"], pl["ks_fd"] = _cdiv(F_, 16), _cdiv(F_ + D, 16)
    tg, tf, t3 = pl["tg"], pl["tf"], pl["t3"]
    if bf16:
        sec = [tg * pl["ks_r"] * 512, tg * pl["ks_r"] * 512,
               tg * pl["ks_rd"] * 512, tg * pl["ks_r"] * 512,
               tf * pl["ks_rd"] * 256, tf * pl["ks_fd"] * 256,
               t3 * pl["ks_f"] * 512]
    else:
        g3, sf = 3 * pl["slg"], pl["slf"]
        sec = [g3 * (R + 4) * 4, g3 * (R + 4) * 4, g3 * (R + D + 4) * 4,
               g3 * (R + 4) * 4, sf * (R + D + 4) * 4,
               sf * (F_ + D + 4) * 4, NC * (F_ + 4) * 4]
    pl["sections"] = sec
    pl["w_bytes"] = sum(sec)
    pl["by_phase"] = int(by_phase or not bf16)
    pl["w_smem"] = max(sec[0] + sec[1], sec[2] + sec[3], sec[4], sec[5],
                       sec[6]) if pl["by_phase"] else pl["w_bytes"]
    pl["m_rows"] = 16 * max(2 * tg, tf, t3)
    pl["ksplit"] = 2 if bf16 else 8
    # row pitches of the exchange buffers, in global and shared memory
    for key, ks, k in (("p_r", "ks_r", R), ("p_rd", "ks_rd", R + D),
                       ("p_f", "ks_f", F_), ("p_fd", "ks_fd", F_ + D)):
        pl[key] = 32 * pl[ks] + 16 if bf16 else 4 * k
    pl["stride_a"] = max(pl["p_r"], pl["p_rd"], pl["p_f"], pl["p_fd"])
    pl["stride_h"] = pl["p_r"]
    misc = (4 * GR_MAX + GR_MAX * (K + 1) * 4 + 15) & ~15
    pl["off_stage"] = pl["w_smem"]
    pl["ch"] = 0
    for ch in (40, 32, 24, 16, 8):
        pl["ps"] = _part_pitch(ch)
        stage = N_BUFFERS * ch * (pl["stride_a"] + pl["stride_h"])
        part = (2 if bf16 else 1) * pl["ksplit"] * pl["m_rows"] * pl["ps"] * 4
        pl["off_part"] = pl["off_stage"] + stage
        pl["off_misc"] = pl["off_part"] + part
        pl["total"] = pl["off_misc"] + misc
        if pl["total"] <= SMEM_MAX:
            pl["ch"] = ch
            pl["ch_fc"], pl["ps_fc"] = ch, pl["ps"]
            c = ch + 8
            while (pl["by_phase"] and N_BUFFERS * c * pl["stride_a"] <= stage
                   and 16 * tf * _part_pitch(c) <= pl["m_rows"] * pl["ps"]):
                pl["ch_fc"], pl["ps_fc"] = c, _part_pitch(c)
                c += 8
            break
    else:
        pl["ch_fc"] = pl["ps_fc"] = 0
    pl["fits"] = pl["ch"] > 0
    return pl


def _cfg_dims(cfg: WaveRNNConfig):
    """(R, F, D, NC, K) as the kernel counts them."""
    gauss = cfg.mode == "GAUSS"
    return (cfg.rnn_dims, cfg.fc_dims,
            cfg.aux_dims if cfg.use_aux_net else 0, cfg.n_classes,
            0 if gauss else cfg.n_classes // 3)


def kernel_plan(cfg: WaveRNNConfig, n_blocks: int, bf16: bool,
                by_phase: bool = True) -> dict:
    """:func:`smem_plan` for ``cfg``; raises, with the numbers, for
    widths whose weights in shared memory and smallest staging do not
    fit a block's shared memory."""
    R, F_, D, NC, K = _cfg_dims(cfg)
    pl = smem_plan(R, F_, D, NC, K, n_blocks, bf16, by_phase)
    if not pl["fits"]:
        raise ValueError(
            f"rnn_dims {R}, fc_dims {F_}, aux_dims {D}, {NC} classes on "
            f"{n_blocks} blocks need {pl['total']} bytes of shared memory "
            f"per block ({pl['w_smem']} of "
            f"{'one phase' if pl['by_phase'] else 'every phase'}'s "
            "weights, the rest "
            f"staging for 8 rows), more than the {SMEM_MAX} a Hopper "
            "block can use")
    return pl


def _tile_rows(kind: str, n_out: int, n_blocks: int, tiles: int):
    """Which row of the layer's matrix sits in row r of tile ``ti`` of
    block ``j`` (-1: none): (n_blocks, tiles, 16 or 8).  Units go
    round-robin over the blocks (unit u belongs to block u % n_blocks);
    a GRU tile holds 5 units x 3 gates, row (unit % 5)·3 + gate; an fc
    tile 8 outputs; fc3 is whole in every block."""
    j = np.arange(n_blocks)[:, None, None]
    ti = np.arange(tiles)[None, :, None]
    if kind == "gru":
        r = np.arange(16)[None, None, :]
        u = j + (ti * GRU_PER_TILE + r // 3) * n_blocks
        ok = (r < 3 * GRU_PER_TILE) & (u < n_out)
        src = (r % 3) * n_out + u
    elif kind == "fc":
        r = np.arange(FC_PER_TILE)[None, None, :]
        src = j + (ti * FC_PER_TILE + r) * n_blocks
        ok = src < n_out
    else:
        r = np.arange(16)[None, None, :]
        src = ti * 16 + r + 0 * j
        ok = src < n_out
    return np.where(ok, src, -1)


def _slice_rows(kind: str, n_out: int, n_blocks: int, slots: int):
    """f32 slices: which row of the layer's matrix is row i of block j's
    section (-1: none): (n_blocks, rows).  A GRU unit's three gate rows
    follow each other (row 3·slot + gate), an fc output is row slot, fc3
    is whole in every block."""
    j = np.arange(n_blocks)[:, None]
    if kind == "gru":
        i = np.arange(3 * slots)[None, :]
        u = j + (i // 3) * n_blocks
        return np.where(u < n_out, (i % 3) * n_out + u, -1)
    if kind == "fc":
        u = j + np.arange(slots)[None, :] * n_blocks
        return np.where(u < n_out, u, -1)
    return np.arange(n_out)[None, :] + 0 * j


def _sections(cfg: WaveRNNConfig, n_blocks: int):
    """Per bf16 section: (key, kind, tiles, k-steps, outputs per gate),
    in the kernel's order."""
    R, F_, _, NC, _ = _cfg_dims(cfg)
    pl = kernel_plan(cfg, n_blocks, True)
    return (
        ("rnn1_ih", "gru", pl["tg"], pl["ks_r"], R),
        ("rnn1_hh", "gru", pl["tg"], pl["ks_r"], R),
        ("rnn2_ih", "gru", pl["tg"], pl["ks_rd"], R),
        ("rnn2_hh", "gru", pl["tg"], pl["ks_r"], R),
        ("fc1", "fc", pl["tf"], pl["ks_rd"], F_),
        ("fc2", "fc", pl["tf"], pl["ks_fd"], F_),
        ("fc3", "fc3", pl["t3"], pl["ks_f"], NC),
    )


def _default_blocks(t: torch.Tensor) -> int:
    if t.device.type == "cuda":
        return torch.cuda.get_device_properties(
            t.device).multi_processor_count
    return H100_SMS


@torch.no_grad()
def kernel_weights(params: dict, cfg: WaveRNNConfig,
                   n_blocks: int | None = None) -> dict:
    """The sample-loop weights as the kernel takes them, from the
    module's (out, in) matrices (the concat-input layers whole: their
    aux columns follow the z columns, as the kernel stages its inputs).

    ``packed``: (n_blocks, elements) in the matrices' type, block j's
    slice of all seven matrices.  bf16: in tensor-core fragment order
    (:func:`_tile_rows`, :func:`_frag_index`), zero where a tile has no
    row or K is padded to 16.  f32: its rows one after another
    (:func:`_slice_rows`), each followed by 4 zeros (the kernel's bank
    padding), zero rows where a block has fewer units than the most.
    Biases and ``w_x`` flat f32 either way.
    ``n_blocks``: the launch's grid, by default the SM count of the
    weights' device (132 off the card).  Raises for widths whose slices
    do not fit a block's shared memory (:func:`kernel_plan`).  A second
    copy of the weights on their device (15 MB at the default width):
    callers that vocode repeatedly keep it (``WaveRNN`` does)."""
    ref = params["rnn1"]["weight_ih"]
    G = int(n_blocks or _default_blocks(ref))
    w = {"dtype": ref.dtype, "n_blocks": G}
    for key, layer, name in _VECS:
        w[key] = params[layer][name].to(torch.float32).contiguous()
    w["w_x"] = params["I"]["weight"][:, 0].to(torch.float32).contiguous()
    mats = {key: params[layer][name] for key, layer, name, _ in _MATS}
    out = []
    if ref.dtype != torch.bfloat16:
        pl = kernel_plan(cfg, G, False)
        for key, _, _, kind in _MATS:
            m = mats[key]
            slots = pl["slg"] if kind == "gru" else pl["slf"]
            n_out = m.shape[0] // 3 if kind == "gru" else m.shape[0]
            src = _slice_rows(kind, n_out, G, slots)
            idx = torch.as_tensor(np.where(src < 0, m.shape[0], src),
                                  device=m.device)
            out.append(torch.nn.functional.pad(m, (0, 4, 0, 1))[idx]
                       .reshape(G, -1))
        w["packed"] = torch.cat(out, dim=1).contiguous()
        return w
    for key, kind, tiles, ks, n_out in _sections(cfg, G):
        m = mats[key]
        half = kind == "fc"
        src = _tile_rows(kind, n_out, G, tiles)
        idx = torch.as_tensor(np.where(src < 0, m.shape[0], src),
                              device=m.device)
        # one zero row for "no row", K padded to whole k-steps
        mp = torch.nn.functional.pad(m, (0, 16 * ks - m.shape[1], 0, 1))
        t = mp[idx].reshape(G, tiles, src.shape[2], ks, 16).transpose(2, 3)
        fr, fc = (torch.as_tensor(a, device=m.device)
                  for a in _frag_index(half))
        out.append(t[..., fr, fc].reshape(G, -1))
    w["packed"] = torch.cat(out, dim=1).contiguous()
    return w


@torch.no_grad()
def unpack_kernel_weights(w: dict, cfg: WaveRNNConfig) -> dict:
    """The inverse of :func:`kernel_weights`: the seven matrices under
    its keys, (out, in), from either layout (the packed slices read back
    row by row)."""
    G, packed = w["n_blocks"], w["packed"]
    R, F_, D, NC, _ = _cfg_dims(cfg)
    k_in = {"rnn1_ih": R, "rnn1_hh": R, "rnn2_ih": R + D, "rnn2_hh": R,
            "fc1": R + D, "fc2": F_ + D, "fc3": F_}
    mats, off = {}, 0
    if w["dtype"] != torch.bfloat16:
        pl = kernel_plan(cfg, G, False)
        for key, _, _, kind in _MATS:
            slots = pl["slg"] if kind == "gru" else pl["slf"]
            n_out = {"gru": R, "fc": F_, "fc3": NC}[kind]
            src = torch.as_tensor(_slice_rows(kind, n_out, G, slots),
                                  device=packed.device)
            n = src.shape[1] * (k_in[key] + 4)
            rows = packed[:, off: off + n].reshape(G, src.shape[1], -1)
            off += n
            m = packed.new_zeros((3 if kind == "gru" else 1) * n_out,
                                 k_in[key])
            m[src[src >= 0]] = rows[src >= 0][:, : k_in[key]]
            mats[key] = m
        return mats
    for key, kind, tiles, ks, n_out in _sections(cfg, G):
        half = kind == "fc"
        rt, e = (8, 4) if half else (16, 8)
        n = tiles * ks * 32 * e
        sec = packed[:, off: off + n].reshape(G, tiles, ks, 32, e)
        off += n
        fr, fc = (torch.as_tensor(a, device=packed.device)
                  for a in _frag_index(half))
        t = packed.new_zeros(G, tiles, ks, rt, 16)
        t[..., fr, fc] = sec
        rows = t.transpose(2, 3).reshape(G, tiles, rt, ks * 16)
        src = torch.as_tensor(_tile_rows(kind, n_out, G, tiles),
                              device=packed.device)
        m = packed.new_zeros((3 if kind == "gru" else 1) * n_out, k_in[key])
        m[src[src >= 0]] = rows[src >= 0][:, : k_in[key]]
        mats[key] = m
    return mats


@functools.cache
def _lib():
    lib = load("wavernn_loop")
    lib.wavernn_loop_launch.argtypes = [ctypes.c_void_p] * 3
    lib.wavernn_loop_launch.restype = ctypes.c_int
    lib.wavernn_loop_scratch_bytes.argtypes = [ctypes.c_void_p]
    lib.wavernn_loop_scratch_bytes.restype = ctypes.c_size_t
    lib.wavernn_loop_plan.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.wavernn_loop_plan.restype = ctypes.c_int
    lib.wavernn_loop_error_string.argtypes = [ctypes.c_int]
    lib.wavernn_loop_error_string.restype = ctypes.c_char_p
    for fn in (lib.wavernn_loop_n_ptrs, lib.wavernn_loop_n_dims,
               lib.wavernn_loop_n_plan, lib.wavernn_loop_n_stamps):
        fn.argtypes = []
        fn.restype = ctypes.c_int
    lib.wavernn_loop_barrier_bench.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.wavernn_loop_barrier_bench.restype = ctypes.c_int
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


def _rc(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"wavernn_loop {what} failed: "
                           + lib.wavernn_loop_error_string(rc).decode())


@torch.no_grad()
def cuda_generate(w: dict, cfg: WaveRNNConfig, i_static, a_rest, noise1,
                  noise2, *, phase_ns=None):
    """Drop-in for :func:`wavernn.sample_loop` running the whole loop in
    one CUDA kernel launch.  ``w``: :func:`kernel_weights`; the other
    arguments as there: ``i_static`` (T, B, rnn), ``a_rest`` (T, B,
    3·aux) (last axis empty without the aux net), MOL noise (T, B, K) and
    (T, B), Gaussian noise (T, B) and anything.  Returns samples (B, T).

    ``phase_ns``: an optional (T, N_STAMPS) int64 tensor on the device;
    the kernel then writes the device clock (ns) four times per phase of
    block 0 (GRU 1, GRU 2, fc1, fc2, fc3 + sample): inputs staged,
    products done, arrived at the phase's barrier, left it
    (:func:`phase_breakdown` reads them).  Without it, while a profiler
    session runs, the launch stamps a buffer of its own, which
    ``utils.profiling.RECORDER`` keeps.

    Takes contiguous CUDA float32 tensors (weight matrices f32 or bf16)
    and raises on anything else, also for widths whose weights of a phase
    and staging do not fit a block's shared memory: there is no fallback
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
    _, F_, D, NC, K = _cfg_dims(cfg)
    gauss = cfg.mode == "GAUSS"
    if T < 1 or B < 1:
        raise ValueError(f"empty generation: T={T}, B={B}")
    wdt = w["dtype"]
    if wdt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"weight matrices are {wdt}: expected float32 or "
                        "bfloat16")
    bf16 = wdt == torch.bfloat16
    unit = 8 if bf16 else 4
    if R != cfg.rnn_dims or R % unit or F_ % unit or D % 4:
        raise ValueError(
            f"rnn_dims {R} (config {cfg.rnn_dims}) and fc_dims {F_} must "
            "be multiples of 4 (of 8 with bf16 weights) and aux_dims "
            f"{D} a multiple of 4 (the kernel moves rows 16 bytes at a "
            "time)")
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
    G = int(w["n_blocks"])
    # bf16 few rows: the whole slice in shared memory, where it fits
    by_phase = not bf16 or B >= WEIGHTS_BY_PHASE_ROWS or not smem_plan(
        R, F_, D, NC, K, G, bf16, by_phase=False)["fits"]
    pl = kernel_plan(cfg, G, bf16, by_phase)
    shapes = {"rnn1_bih": (3 * R,), "rnn1_bhh": (3 * R,),
              "rnn2_bih": (3 * R,), "rnn2_bhh": (3 * R,), "fc1_b": (F_,),
              "fc2_b": (F_,), "fc3_b": (NC,), "w_x": (R,)}
    for key, *_ in _VECS + (("w_x",),):
        _check(key, w[key], shapes[key], f32, device)
    _check("packed", w["packed"], (G, pl["w_bytes"] // (2 if bf16 else 4)),
           wdt, device)
    if phase_ns is not None:
        _check("phase_ns", phase_ns, (T, N_STAMPS), torch.int64, device)
    kept = phase_ns is None and profiling.on()
    if kept:
        phase_ns = torch.zeros(T, N_STAMPS, dtype=torch.int64, device=device)

    lib = _lib()
    dims = (ctypes.c_int * 11)(T, B, R, F_, D, NC, K, int(gauss),
                               int(bf16), G, int(by_phase))
    theirs = (ctypes.c_int * len(_PLAN_FIELDS))()
    if (len(dims) != lib.wavernn_loop_n_dims()
            or len(theirs) != lib.wavernn_loop_n_plan()
            or N_STAMPS != lib.wavernn_loop_n_stamps()
            or not lib.wavernn_loop_plan(dims, theirs)
            or list(theirs) != [pl[k] for k in _PLAN_FIELDS]):
        raise RuntimeError("wavernn_loop: the library's shared-memory "
                           f"plan {list(theirs)} differs from smem_plan's "
                           f"{[pl[k] for k in _PLAN_FIELDS]}")
    out = torch.empty(B, T, dtype=f32, device=device)
    # zeroed: the initial hidden state and the buffers' padding
    scratch = torch.zeros(lib.wavernn_loop_scratch_bytes(dims),
                          dtype=torch.uint8, device=device)
    tensors = (i_static, a_rest if D else None, n1, n2, w["packed"],
               *(w[key] for key, *_ in _VECS), w["w_x"], out, scratch,
               phase_ns)
    if len(tensors) != lib.wavernn_loop_n_ptrs():
        raise RuntimeError("wavernn_loop: pointer list does not match the "
                           "library's")
    ptrs = (ctypes.c_void_p * len(tensors))(
        *(None if t is None else t.data_ptr() for t in tensors))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.wavernn_loop_launch(ptrs, dims, ctypes.c_void_p(stream))
    _rc(lib, rc, "launch")
    GEN_LAUNCHES += 1
    if kept:
        profiling.RECORDER.stamp("k3", phase_ns, T, phase_breakdown)
    return out


PHASES = ("gru1", "gru2", "fc1", "fc2", "fc3+sample")
PARTS = ("stage", "products", "rest", "barrier")


def phase_breakdown(phase_ns: torch.Tensor) -> dict:
    """Mean microseconds per step from a launch's clock stamps, by phase
    and part: ``stage`` (from leaving the previous barrier to the
    phase's inputs in shared memory), ``products``, ``rest`` (gate math,
    sampling, stores, up to arriving at the barrier), ``barrier`` (from
    arriving to leaving: the fence, the atomic and the wait for the
    slowest block).  Block 0's view; the first step is left out; the
    clock ticks every 0.25-1 µs, hence means."""
    s = phase_ns.detach().cpu().double().reshape(-1, 5, 4)
    # where block 0 owns no row of a phase its first two stamps stay 0
    prev = torch.cat([s[:-1, 4:, 3], s[1:, :4, 3]], dim=1)     # (T-1, 5)
    cur = s[1:]
    t0 = torch.where(cur[..., 0] > 0, cur[..., 0], prev)
    t1 = torch.where(cur[..., 1] > 0, cur[..., 1], t0)
    parts = torch.stack([t0 - prev, t1 - t0, cur[..., 2] - t1,
                         cur[..., 3] - cur[..., 2]], dim=-1).mean(0) / 1e3
    return {ph: {pt: float(parts[i, j]) for j, pt in enumerate(PARTS)}
            for i, ph in enumerate(PHASES)}


def barrier_us(n: int = 2000, device=None) -> float:
    """Microseconds per grid barrier (``grid.sync()``) on the sample-loop
    kernel's grid (one block of 512 threads per SM), from one launch of
    ``n`` barriers and nothing else, timed with CUDA events."""
    device = torch.device("cuda" if device is None else device)
    lib = _lib()
    G = torch.cuda.get_device_properties(device).multi_processor_count
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream

        def run(k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            rc = lib.wavernn_loop_barrier_bench(k, G, ctypes.c_void_p(stream))
            end.record()
            _rc(lib, rc, "barrier bench")
            torch.cuda.synchronize(device)
            return start.elapsed_time(end)

        run(10)                           # warm
        return 1e3 * (run(n + 10) - run(10)) / n
