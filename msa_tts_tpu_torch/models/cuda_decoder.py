"""Tacotron-2 inference decoder as CUDA kernels (counterpart of
``msa_tts_tpu/models/pallas_decoder.py``).

``cuda_decoder_infer`` runs the entire autoregressive loop, early exit
included, in one persistent cooperative launch of
``csrc/decoder_loop.cu`` and returns what ``decoder.decoder_infer`` (its
plain PyTorch version) returns.  ``cuda_decoder_segment`` runs a fixed
number of steps from a carried stream state in one launch of the same
source's segment kernel, which shares the step function, and returns
what ``decoder.decoder_infer_segment`` returns.  The prenet dropout
masks are an input, as there.  Lowered configs: LSA, or ForwardAttention
without inference windowing or forward_attn_mask.

The weights' type is the decoder's parameters': float32, or bfloat16
with the roundings of ``decoder.compute_view`` (product inputs rounded
to bfloat16, float32 sums and state, LSTM biases summed at bfloat16).
``split_decoder_params`` packs them as the kernel reads them and
``smem_plan`` says which of the LSTM weight segments a block keeps in
its shared memory for a launch.

What the TPU kernel needed and this one does not carry over: the VMEM
budget and its gate (``fits_vmem``), the measured-profitability gate
(``profitable``), the B = 1 pad (``_dup_row0``) and the (B, 8)
lane-width scratch.  B = 1 runs as B = 1.
"""

from __future__ import annotations

import ctypes
import functools
import weakref

import torch

from ..kernels.build import load
from ..kernels.mma import frag_index
from ..ops.masking import sequence_mask
from .decoder import (
    Decoder,
    DecoderCarry,
    DecoderConfig,
    attention_inputs,
    decoder_dtype,
    params_key,
    parse_decoder_outputs,
)

# Incremented once per launch of the decoder-loop kernel (LAUNCHES) and
# of the segment kernel (SEG_LAUNCHES), and nowhere else: a run reads
# them to show that its decodes went through the kernels.
LAUNCHES = 0
SEG_LAUNCHES = 0

# device-clock stamps per decoder step written when ``phase_ns`` is given
N_STAMPS = 18
# what the N_STAMPS - 1 intervals between a step's stamps cover: the
# stamping block's work in each phase and its time in the phase's grid
# barrier (phase 3's work in two parts; the prenet runs on the grid's
# last blocks, so block 0 passes its three stamps at once and its phase 1
# is the decoder LSTM's recurrent part)
PHASES = ("prenet inputs", "prenet layer 1", "prenet layer 2",
          "decoder LSTM recurrent part",
          "barrier 1", "attention LSTM",
          "barrier 2", "query", "energies", "barrier 3", "attention rows",
          "barrier 4", "decoder LSTM", "barrier 5",
          "proj+gate, next attention-LSTM part", "barrier 6", "bookkeeping")

# the weight matrices (packed at the decoder's parameter type) and the
# float32 vectors, in the order of the kernel's pointer list
_W_NAMES = (
    "w_pre1", "w_pre2", "wa_p", "wa_c", "wa_h", "b_att", "w_q", "w_loc",
    "w_locd", "v_w", "v_b", "w_ta", "b_ta", "wd_h", "wd_c", "wd_hd",
    "b_dec", "w_pg", "b_pg",
)
_MATRICES = ("w_pre1", "w_pre2", "wa_p", "wa_c", "wa_h", "w_q",
             "wd_h", "wd_c", "wd_hd", "w_pg")
# the LSTM weight segments in the kernel's order (enum Seg), and the
# order in which they get a block's shared memory: first the two whose
# products run after an exchange, then the ones started ahead
SEGMENTS = ("wa_p", "wa_c", "wa_h", "wd_h", "wd_c", "wd_hd")
RESIDENT_ORDER = ("wa_p", "wd_c", "wd_h", "wd_hd", "wa_c", "wa_h")

SMEM_MAX = 232448     # bytes of shared memory a Hopper block can use
_NT, _BCH = 512, 4    # the kernel's threads per block, rows per chunk
_NW = _NT // 32


def supports_config(cfg: DecoderConfig) -> bool:
    """True when the kernel lowers this decoder configuration."""
    ap = cfg.attention_params
    if ap.get("attention_type") == "LSA":
        return True
    return (
        ap.get("attention_type") == "ForwardAttention"
        and not ap.get("windowing", False)
        and not ap.get("forward_attn_mask", False)
        and ap.get("norm", "softmax") in ("softmax", "sigmoid")
    )


def check_supported(cfg: DecoderConfig) -> None:
    """Raise ValueError when the kernel does not lower ``cfg``."""
    if not supports_config(cfg):
        raise ValueError(
            "the CUDA decoder kernel does not lower this attention config "
            "(inference windowing, forward_attn_mask, or a norm other than "
            "softmax/sigmoid); decode it with decode_backend='torch'"
        )


def _attn_flags(ap: dict):
    """The step's static attention switches.  LSA is the same dataflow
    as ForwardAttention with the recursion and agent off, masked
    energies and softmax norm."""
    if ap.get("attention_type") == "LSA":
        return dict(loc_att=True, fwd=False, tagent=False,
                    norm="softmax", mask_energies=True)
    return dict(
        loc_att=ap.get("location_attention", True),
        fwd=ap.get("forward_attn", True),
        tagent=ap.get("trans_agent", True),
        norm=ap.get("norm", "softmax"),
        mask_energies=ap.get("mask_energies", False),
    )


def _ld8(n: int) -> int:
    return -(-n // 8) * 8


def _widths(cfg: DecoderConfig) -> dict:
    ap = cfg.attention_params
    return dict(
        E=cfg.encoder_embedding_dim, H=cfg.attention_rnn_dim,
        Hd=cfg.decoder_rnn_dim, P=cfg.prenet_dim, A=ap["attention_dim"],
        F=ap.get("attention_location_n_filters", 32),
        K=ap.get("attention_location_kernel_size", 31),
        MR=cfg.n_mel_channels * cfg.n_frames_per_step,
    )


@torch.no_grad()
def split_decoder_params(decoder: Decoder, cfg: DecoderConfig,
                         dtype: torch.dtype | None = None) -> dict:
    """The decoder weights in the kernel's layout.

    The matrices (``_MATRICES``) are packed at ``dtype`` (float32 or
    bfloat16; default the decoder's own), every row zero-padded to a
    multiple of 8 values (16-byte loads); biases, ``v``, the transition
    agent, the location conv and dense stay float32.  Every matrix keeps
    the torch (out, in) layout, so a warp reads one output's row
    contiguously.  Each LSTM is split by input block into three segments
    (attention LSTM ``wa_p | wa_c | wa_h``: prenet, context, recurrent;
    decoder LSTM ``wd_h | wd_c | wd_hd``: attention h, context,
    recurrent), each stored unit-major: in float32 as (units, 4 gates,
    columns), in bfloat16 as the tensor-core instruction's tiles of 4
    units x 16 columns (the prenet's two matrices likewise as tiles of 16
    rows).  Either way the gate rows of the units one block owns are one
    contiguous piece, which the kernel can keep in shared memory.  The
    two biases are summed at ``dtype`` (as the JAX kernel's packing sums
    them) and held in float32; the mel projection and the gate
    share one matrix ``w_pg`` over [decoder h | context] (each padded),
    gate row last.
    Switched-off parts of the attention get zeros."""
    dtype = dtype or decoder_dtype(decoder)
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"decoder weights as {dtype}: float32 or bfloat16")
    flags = _attn_flags(cfg.attention_params)
    d = _widths(cfg)
    E, H, Hd, P, A = d["E"], d["H"], d["Hd"], d["P"], d["A"]
    att = decoder.attention_layer
    arnn, drnn = decoder.attention_rnn, decoder.decoder_rnn
    dev = arnn.weight_ih.device

    def f32(x):
        return x.detach().to(torch.float32).contiguous()

    def mat(x):
        """(out, in) -> (out, ld8(in)) at the weight type."""
        x = torch.nn.functional.pad(x.detach(), (0, -x.shape[-1] % 8))
        return x.to(dtype).contiguous()

    def segment(x):
        """(4N, n) gate-major rows -> unit-major: float32 (N, 4, ld8(n));
        bfloat16 whole tiles of 4 units x 16 columns in the A-operand
        order of ``mma.sync.m16n8k16``, (unit tiles, column tiles, 32
        lanes, 8 values), zero where a tile has no row or column."""
        n_units, n = x.shape[0] // 4, x.shape[1]
        um = x.detach().reshape(4, n_units, n).transpose(0, 1)
        if dtype == torch.float32:
            return mat(um)
        return tiles(um.reshape(4 * n_units, n))

    def tiles(x):
        """(rows, n) -> (row tiles, column tiles, 32 lanes, 8 values):
        16 x 16 tiles in the A-operand order of ``mma.sync.m16n8k16``."""
        rt, kt = -(-x.shape[0] // 16), -(-x.shape[1] // 16)
        x = torch.nn.functional.pad(
            x.detach(), (0, 16 * kt - x.shape[1], 0, 16 * rt - x.shape[0]))
        t = x.reshape(rt, 16, kt, 16).transpose(1, 2)
        fr, fc = (torch.as_tensor(a, device=dev) for a in frag_index(False))
        return t[..., fr, fc].to(dtype).contiguous()

    def prenet(x):
        """A prenet layer's matrix: rows for float32, tiles for bfloat16."""
        return mat(x) if dtype == torch.float32 else tiles(x)

    def bias(cell):
        """An LSTM's two biases, summed at the weight type."""
        return f32(cell.bias_ih.to(dtype) + cell.bias_hh.to(dtype))

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    proj = torch.cat([decoder.linear_projection.linear_layer.weight,
                      decoder.gate_layer.linear_layer.weight], dim=0)
    w = {
        "w_pre1": prenet(decoder.prenet.layers[0].linear_layer.weight),
        "w_pre2": prenet(decoder.prenet.layers[1].linear_layer.weight),
        "wa_p": segment(arnn.weight_ih[:, :P]),
        "wa_c": segment(arnn.weight_ih[:, P:]),
        "wa_h": segment(arnn.weight_hh),
        "b_att": bias(arnn),
        "w_q": mat(att.query_layer.linear_layer.weight),
        "v_w": f32(att.v.linear_layer.weight.reshape(-1)),
        # LSA's v has no bias
        "v_b": (
            f32(att.v.linear_layer.bias) if att.v.linear_layer.bias
            is not None else zeros(1)
        ),
        "wd_h": segment(drnn.weight_ih[:, :H]),
        "wd_c": segment(drnn.weight_ih[:, H:]),
        "wd_hd": segment(drnn.weight_hh),
        "b_dec": bias(drnn),
        "w_pg": torch.cat([mat(proj[:, :Hd]), mat(proj[:, Hd:])], dim=1),
        "b_pg": f32(torch.cat([
            decoder.linear_projection.linear_layer.bias,
            decoder.gate_layer.linear_layer.bias,
        ])),
    }
    # keyed on the same flag resolution as the kernel body (LSA always
    # has a real location layer, whatever location_attention says)
    if flags["loc_att"]:
        w["w_loc"] = f32(att.location_layer.conv_weight)       # (F, 2, K)
        w["w_locd"] = f32(
            att.location_layer.location_dense.linear_layer.weight
        )                                                       # (A, F)
    else:
        w["w_loc"] = zeros(d["F"], 2, d["K"])
        w["w_locd"] = zeros(A, d["F"])
    if flags["fwd"] and flags["tagent"] and hasattr(att, "ta"):
        w["w_ta"] = f32(att.ta.weight.reshape(-1))             # [ctx | q]
        w["b_ta"] = f32(att.ta.bias)
    else:
        w["w_ta"], w["b_ta"] = zeros(E + H), zeros(1)
    return w


def _packed_shapes(cfg: DecoderConfig, dtype=torch.float32) -> dict:
    d = _widths(cfg)
    E, H, Hd, P, A, MR = d["E"], d["H"], d["Hd"], d["P"], d["A"], d["MR"]

    def seg(n_units, n):
        if dtype == torch.bfloat16:
            return (-(-n_units // 4), -(-n // 16), 32, 8)
        return (n_units, 4, _ld8(n))

    def pre(n):
        if dtype == torch.bfloat16:
            return (-(-P // 16), -(-n // 16), 32, 8)
        return (P, _ld8(n))

    return {
        "w_pre1": pre(MR), "w_pre2": pre(P),
        "wa_p": seg(H, P), "wa_c": seg(H, E), "wa_h": seg(H, H),
        "b_att": (4 * H,), "w_q": (A, _ld8(H)),
        "w_loc": (d["F"], 2, d["K"]), "w_locd": (A, d["F"]), "v_w": (A,),
        "v_b": (1,), "w_ta": (E + H,), "b_ta": (1,),
        "wd_h": seg(Hd, H), "wd_c": seg(Hd, E), "wd_hd": seg(Hd, Hd),
        "b_dec": (4 * Hd,),
        "w_pg": (MR + 1, _ld8(Hd) + _ld8(E)), "b_pg": (MR + 1,),
    }


def units_per_block(n_units: int, n_sm: int, dtype: torch.dtype) -> int:
    """Hidden units of an LSTM that one of ``n_sm`` blocks owns
    (consecutive units): with bfloat16 weights whole tiles of 4 units."""
    if dtype == torch.bfloat16:
        return 4 * -(-(-(-n_units // 4)) // n_sm)
    return -(-n_units // n_sm)


def smem_plan(cfg: DecoderConfig, B: int, T_in: int, dtype: torch.dtype,
              n_sm: int = 132) -> dict:
    """The kernel's shared-memory layout for a launch at (B, T_in) with
    weights of ``dtype`` on a card of ``n_sm`` SMs (one block each): the
    same arithmetic as ``make_layout`` in ``csrc/decoder_loop.cu``.

    A block owns :func:`units_per_block` consecutive hidden units of
    each LSTM.  Beside the fixed space (header, reduction scratch, the
    attention's resident weights, the partial sums, the block's rows of
    the projection matrix, the phases' working space) it keeps the gate
    rows of its units for as many LSTM segments as fit, in
    ``RESIDENT_ORDER``; the others it reads from global memory every
    step.  Returns ``grid``, ``smem_bytes``, ``fixed_bytes``,
    ``resident`` (segment names), ``res_mask`` (bit s of ``SEGMENTS``),
    ``resident_bytes`` and ``streamed_bytes`` of LSTM weights over the
    whole grid.  Raises when even the fixed space does not fit."""
    d = _widths(cfg)
    E, H, Hd, P, A, MR = d["E"], d["H"], d["Hd"], d["P"], d["A"], d["MR"]
    F_, K = d["F"], d["K"]
    esz = torch.empty((), dtype=dtype).element_size()
    G = n_sm
    bf16 = dtype == torch.bfloat16
    upa, upd = (units_per_block(n, G, dtype) for n in (H, Hd))
    rows = min(B, _BCH)
    nslice = max(1, min(G // B, -(-E // 32)))
    fixed = -(-(2 * B + 1) * 4 // 16) * 16            # int header
    # reduction scratch; bfloat16: the warps' 16 x 8 tensor-core sums
    fixed += (_NW * 128 if bf16 else 2 * _BCH * _NW) * 4
    fixed += -(-(A * F_ + 2 * F_ * K + A) // 4) * 4 * 4
    fixed += (_ld8(upa * 4 * B) + _ld8(upd * 4 * B)) * 4
    fixed += -(-(MR + 1) // G) * (_ld8(Hd) + _ld8(E)) * esz   # W_pg rows
    body = max(
        rows * (_ld8(MR) + 3 * _ld8(P)),
        rows * (_ld8(Hd) + _ld8(E) + _ld8(H)),
        _ld8(H) + _ld8(A) + _NW * (2 * K + F_),
        3 * T_in + _NW * -(-E // nslice),
    )
    fixed += -(-body // 4) * 4 * 4
    if fixed > SMEM_MAX:
        raise ValueError(
            f"B={B}, T_in={T_in} need {fixed} bytes of shared memory per "
            f"block for the working space alone (a Hopper block has "
            f"{SMEM_MAX})"
        )
    seg_n = dict(wa_p=P, wa_c=E, wa_h=H, wd_h=H, wd_c=E, wd_hd=Hd)
    used, resident, res_bytes, all_bytes = fixed, [], 0, 0
    for name in RESIDENT_ORDER:
        n_units = H if name.startswith("wa") else Hd
        up = upa if name.startswith("wa") else upd
        # bytes of one unit's four gate rows as they are packed
        unit = (-(-seg_n[name] // 16) * 128 if bf16
                else 4 * _ld8(seg_n[name]) * esz)
        whole = (4 * -(-n_units // 4) if bf16 else n_units) * unit
        all_bytes += whole
        if used + up * unit <= SMEM_MAX:
            used += up * unit
            resident.append(name)
            res_bytes += whole
    return dict(
        grid=G, smem_bytes=used, fixed_bytes=fixed,
        resident=tuple(resident),
        res_mask=sum(1 << SEGMENTS.index(n) for n in resident),
        resident_bytes=res_bytes, streamed_bytes=all_bytes - res_bytes,
    )


# decoder -> (key, packed weights): see _packed_params
_PACKED: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _packed_params(decoder: Decoder, cfg: DecoderConfig) -> dict:
    """:func:`split_decoder_params` at the decoder's own type, kept per
    decoder and packed again only when a parameter gets new storage or
    another type (as after ``.to()``) or is changed in place (its version
    counter moves, as in ``load_state_dict``).  A write through ``.data``
    skips the version counter and is not seen.  The cache is a second
    copy of the decoder weights on their device (~82 MB at the shipped
    width in float32, ~41 MB in bfloat16); a decoder holds one packing,
    the one of its current type."""
    key = (dict(cfg.attention_params), params_key(decoder))
    hit = _PACKED.get(decoder)
    if hit is None or hit[0] != key:
        hit = (key, split_decoder_params(decoder, cfg))
        _PACKED[decoder] = hit
    return hit[1]


def prenet_masks(cfg: DecoderConfig, S: int, B: int,
                 generator: torch.Generator, *, device) -> torch.Tensor:
    """(S, 2, B, P) raw 0/1 float prenet dropout masks for S decoder
    steps, drawn on the generator's device and moved to ``device``."""
    keep = 1.0 - cfg.p_prenet_dropout
    u = torch.rand((S, 2, B, cfg.prenet_dim), generator=generator,
                   device=generator.device)
    return (u < keep).to(torch.float32).to(device)


@functools.cache
def _lib():
    lib = load("decoder_loop")
    for fn in (lib.decoder_loop_launch, lib.decoder_segment_launch):
        fn.argtypes = [ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int
    lib.decoder_loop_scratch_floats.argtypes = [ctypes.c_void_p]
    lib.decoder_loop_scratch_floats.restype = ctypes.c_size_t
    lib.decoder_loop_plan.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.decoder_loop_plan.restype = ctypes.c_int
    lib.decoder_loop_error_string.argtypes = [ctypes.c_int]
    lib.decoder_loop_error_string.restype = ctypes.c_char_p
    for fn in (lib.decoder_loop_n_ptrs, lib.decoder_segment_n_ptrs,
               lib.decoder_loop_n_dims):
        fn.argtypes = []
        fn.restype = ctypes.c_int
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


def _check_device(name: str, device: torch.device) -> None:
    if device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {device}")


def _f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` as contiguous float32: a bfloat16 tensor's values, exactly."""
    return x.to(torch.float32).contiguous()


def _prepare(decoder: Decoder, cfg: DecoderConfig, B: int, T_in: int,
             S: int, device, stamp_block: int = 0):
    """The checked packed weights, the kernel's int dims and float
    params for a launch of S steps at (B, T_in), and the library; raises
    when the shapes need more shared memory than a block has, or when
    the library lays its shared memory out otherwise than
    :func:`smem_plan`."""
    flags = _attn_flags(cfg.attention_params)
    d = _widths(cfg)
    dtype = decoder_dtype(decoder)
    w = _packed_params(decoder, cfg)
    shapes = _packed_shapes(cfg, dtype)
    for k in _W_NAMES:
        _check(k, w[k], shapes[k],
               dtype if k in _MATRICES else torch.float32, device)
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    plan = smem_plan(cfg, B, T_in, dtype, n_sm)
    dims = (ctypes.c_int * 19)(
        B, T_in, d["E"], d["H"], d["Hd"], d["P"], d["A"], d["F"], d["K"],
        d["MR"], S,
        int(cfg.early_stopping), int(flags["loc_att"]), int(flags["fwd"]),
        int(flags["tagent"]), int(flags["norm"] == "sigmoid"),
        int(flags["mask_energies"]), int(dtype == torch.bfloat16),
        int(stamp_block),
    )
    lib = _lib()
    if len(dims) != lib.decoder_loop_n_dims():
        raise RuntimeError("decoder_loop: dims list does not match the "
                           "library's")
    got = (ctypes.c_longlong * 3)()
    with torch.cuda.device(device):
        rc = lib.decoder_loop_plan(dims, got)
    if rc != 0:
        raise RuntimeError("decoder_loop_plan failed: "
                           + lib.decoder_loop_error_string(rc).decode())
    want = (plan["grid"], plan["smem_bytes"], plan["res_mask"])
    if tuple(got) != want:
        raise RuntimeError(
            f"decoder_loop: the library plans (grid, shared bytes, resident "
            f"mask) {tuple(got)}, smem_plan {want}"
        )
    fparams = (ctypes.c_float * 2)(
        1.0 - cfg.p_prenet_dropout, cfg.gate_threshold
    )
    return w, dims, fparams, lib


def _launch(lib, fn, tensors, dims, fparams, device, what: str) -> None:
    """Pass ``tensors`` (device tensors, or None for a null pointer) to
    the C entry ``fn`` on the current stream; raises on a launch error."""
    ptrs = (ctypes.c_void_p * len(tensors))(
        *(None if t is None else t.data_ptr() for t in tensors)
    )
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(ptrs, dims, fparams, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(
            f"{what} launch failed: "
            + lib.decoder_loop_error_string(rc).decode()
        )


def segment_inputs(decoder: Decoder, cfg: DecoderConfig, encoder_outputs,
                   input_lengths):
    """The per-stream inputs of :func:`cuda_decoder_segment`, computed
    once per stream (or once per admitted stream row) rather than per
    segment: the attention's projection of the encoder outputs
    (B, T_in, A), computed at the decoder's type and held in float32,
    and the float validity mask (B, T_in)."""
    pinputs = attention_inputs(decoder, cfg, encoder_outputs)
    maskf = sequence_mask(input_lengths, encoder_outputs.shape[1])
    return pinputs.contiguous(), maskf.to(torch.float32).contiguous()


def _check_enc(decoder, encoder_outputs, shape, device) -> torch.Tensor:
    """The encoder outputs as the kernel reads them (contiguous
    float32).  They may come in float32 or at the decoder's type."""
    if encoder_outputs.dtype not in (torch.float32, decoder_dtype(decoder)):
        raise TypeError(
            f"encoder_outputs has dtype {encoder_outputs.dtype}, expected "
            f"float32 or the decoder's {decoder_dtype(decoder)}")
    _check("encoder_outputs", encoder_outputs, shape, encoder_outputs.dtype,
           device)
    return _f32(encoder_outputs)


def cuda_decoder_infer(decoder: Decoder, cfg: DecoderConfig,
                       encoder_outputs, input_lengths, pre_masks, *,
                       phase_ns: torch.Tensor | None = None):
    """Drop-in for :func:`decoder.decoder_infer` running the whole AR
    loop in one CUDA kernel launch.  Same arguments and returns:
    ``(mel_outputs (B, n_mel, S·r), gate_outputs (B, S·r), alignments
    (B, S, T_in), mel_lengths (B,) int32, n_steps)``.

    Takes CUDA tensors only and raises on anything else: there is no
    fallback to the plain version.  The weights' type is the decoder's
    (float32 or bfloat16, see :func:`split_decoder_params`); the encoder
    outputs come in float32 or at that type; masks, state and outputs
    are float32.

    ``phase_ns``: an optional (S, N_STAMPS) int64 tensor on the device.
    When given, the kernel writes the device clock (``%globaltimer``, ns)
    into row t at the start of step t (column 0), then for each of the
    step's phases when block 0 has done its work and when it has left
    the phase's barrier (``PHASES`` names the intervals), and after the
    stop bookkeeping; rows from ``n_steps`` on are left as they were."""
    return _decoder_infer(decoder, cfg, encoder_outputs, input_lengths,
                          pre_masks, phase_ns, 0)


def profile_decoder_infer(decoder: Decoder, cfg: DecoderConfig,
                          encoder_outputs, input_lengths, pre_masks, *,
                          stamp_block: int = 0) -> torch.Tensor:
    """For profiling only: one :func:`cuda_decoder_infer` whose clock
    stamps block ``stamp_block`` writes (negative: counted from the
    grid's end, where the blocks that compute the prenet are).  Returns
    the (S, N_STAMPS) int64 stamps, zeros from ``n_steps`` on."""
    ns = torch.zeros(cfg.max_decoder_steps, N_STAMPS, dtype=torch.int64,
                     device=encoder_outputs.device)
    _decoder_infer(decoder, cfg, encoder_outputs, input_lengths, pre_masks,
                   ns, stamp_block)
    return ns


@torch.no_grad()
def _decoder_infer(decoder, cfg, encoder_outputs, input_lengths, pre_masks,
                   phase_ns, stamp_block):
    global LAUNCHES
    check_supported(cfg)
    device = encoder_outputs.device
    _check_device("cuda_decoder_infer", device)
    B, T_in, E = encoder_outputs.shape
    MR = cfg.n_mel_channels * cfg.n_frames_per_step
    S = cfg.max_decoder_steps
    if B < 1 or T_in < 1:
        raise ValueError(f"empty batch: B={B}, T_in={T_in}")
    if E != cfg.encoder_embedding_dim:
        raise ValueError(f"encoder width {E} != config "
                         f"{cfg.encoder_embedding_dim}")
    enc32 = _check_enc(decoder, encoder_outputs, (B, T_in, E), device)
    if tuple(input_lengths.shape) != (B,) or input_lengths.device != device:
        raise ValueError("input_lengths must be (B,) on the encoder's device")
    _check("pre_masks", pre_masks, (S, 2, B, cfg.prenet_dim),
           torch.float32, device)
    if phase_ns is not None:
        _check("phase_ns", phase_ns, (S, N_STAMPS), torch.int64, device)

    w, dims, fparams, lib = _prepare(decoder, cfg, B, T_in, S, device,
                                     stamp_block)
    pinputs, maskf = segment_inputs(decoder, cfg, encoder_outputs,
                                    input_lengths)
    mels = torch.zeros(S, B, MR, dtype=torch.float32, device=device)
    gates = torch.full((S, B), 1e3, dtype=torch.float32, device=device)
    aligns = torch.zeros(S, B, T_in, dtype=torch.float32, device=device)
    mel_lengths = torch.empty(B, dtype=torch.int32, device=device)
    n_steps = torch.empty(1, dtype=torch.int32, device=device)
    scratch = torch.empty(lib.decoder_loop_scratch_floats(dims),
                          dtype=torch.float32, device=device)
    tensors = (
        enc32, pinputs, maskf, pre_masks,
        *(w[k] for k in _W_NAMES),
        mels, gates, aligns, mel_lengths, n_steps, scratch, phase_ns,
    )
    if len(tensors) != lib.decoder_loop_n_ptrs():
        raise RuntimeError("decoder_loop: pointer list does not match the "
                           "library's")
    _launch(lib, lib.decoder_loop_launch, tensors, dims, fparams, device,
            "decoder_loop")
    LAUNCHES += 1
    return (*parse_decoder_outputs(cfg, mels, gates, aligns),
            mel_lengths, n_steps[0])


def _state_fields(state: dict) -> tuple:
    """The carried float state in the kernel's order: din, ah, ac, dh,
    dc, ctx, aw, cum, alpha, u."""
    c = state["carry"]
    a = c.attn_state
    return (state["decoder_input"], c.attention_hidden, c.attention_cell,
            c.decoder_hidden, c.decoder_cell, c.attention_context,
            a.attention_weights, a.attention_weights_cum, a.alpha, a.u)


_FIELD_NAMES = ("decoder_input", "attention_hidden", "attention_cell",
                "decoder_hidden", "decoder_cell", "attention_context",
                "attention_weights", "attention_weights_cum", "alpha", "u")


@torch.no_grad()
def cuda_decoder_segment(decoder: Decoder, cfg: DecoderConfig,
                         encoder_outputs, pinputs, maskf, pre_masks,
                         state: dict, n_seg: int):
    """Drop-in for :func:`decoder.decoder_infer_segment` (its plain
    version) running ``n_seg`` steps from the carried ``state`` in one
    launch of the segment kernel; the counterpart of
    ``pallas_decoder_segment``.  Returns ``(new_state, mels (B, n_mel,
    n_seg·r), gates (B, n_seg), alignments (B, n_seg, T_in))``.

    ``pinputs`` and ``maskf`` come from :func:`segment_inputs`, once per
    stream.  ``pre_masks``: (n_seg, 2, B, P) raw 0/1.  ``state``: the
    ``decoder_stream_init`` dict, every tensor contiguous f32 (int32
    ``not_finished`` / ``mel_lengths``) on the encoder's CUDA device.
    The weights' type is the decoder's; the encoder outputs come in
    float32 or at that type.  Raises on anything else: there is no
    fallback to the plain version."""
    global SEG_LAUNCHES
    check_supported(cfg)
    device = encoder_outputs.device
    _check_device("cuda_decoder_segment", device)
    B, T_in, E = encoder_outputs.shape
    H, Hd, P = cfg.attention_rnn_dim, cfg.decoder_rnn_dim, cfg.prenet_dim
    A = cfg.attention_params["attention_dim"]
    MR = cfg.n_mel_channels * cfg.n_frames_per_step
    if B < 1 or T_in < 1 or n_seg < 1:
        raise ValueError(f"empty segment: B={B}, T_in={T_in}, "
                         f"n_seg={n_seg}")
    if E != cfg.encoder_embedding_dim:
        raise ValueError(f"encoder width {E} != config "
                         f"{cfg.encoder_embedding_dim}")
    f32 = torch.float32
    enc32 = _check_enc(decoder, encoder_outputs, (B, T_in, E), device)
    _check("pinputs", pinputs, (B, T_in, A), f32, device)
    _check("maskf", maskf, (B, T_in), f32, device)
    _check("pre_masks", pre_masks, (n_seg, 2, B, P), f32, device)
    fields = _state_fields(state)
    for name, x, shape in zip(_FIELD_NAMES, fields, (
        (B, MR), (B, H), (B, H), (B, Hd), (B, Hd), (B, E),
        (B, T_in), (B, T_in), (B, T_in), (B, 1),
    )):
        _check(name, x, shape, f32, device)
    for name in ("not_finished", "mel_lengths"):
        _check(name, state[name], (B,), torch.int32, device)

    w, dims, fparams, lib = _prepare(decoder, cfg, B, T_in, n_seg, device)
    dims[11] = 0                           # D_EARLY: a segment never exits
    mels = torch.empty(n_seg, B, MR, dtype=f32, device=device)
    gates = torch.empty(n_seg, B, dtype=f32, device=device)
    aligns = torch.empty(n_seg, B, T_in, dtype=f32, device=device)
    scratch = torch.empty(lib.decoder_loop_scratch_floats(dims), dtype=f32,
                          device=device)
    out = tuple(torch.empty_like(x) for x in fields)
    nf = torch.empty(B, dtype=torch.int32, device=device)
    mlen = torch.empty(B, dtype=torch.int32, device=device)
    tensors = (
        enc32, pinputs, maskf, pre_masks,
        *(w[k] for k in _W_NAMES),
        mels, gates, aligns, None, None, scratch, None,
        *fields, *out, state["not_finished"], state["mel_lengths"], nf, mlen,
    )
    if len(tensors) != lib.decoder_segment_n_ptrs():
        raise RuntimeError("decoder_segment: pointer list does not match "
                           "the library's")
    _launch(lib, lib.decoder_segment_launch, tensors, dims, fparams, device,
            "decoder_segment")
    SEG_LAUNCHES += 1
    din, ah, ac, dh, dc, ctx, aw, cum, alpha, u = out
    carry = state["carry"]
    new_state = dict(
        step=state["step"] + n_seg,
        decoder_input=din,
        carry=DecoderCarry(
            attention_hidden=ah, attention_cell=ac,
            decoder_hidden=dh, decoder_cell=dc, attention_context=ctx,
            attn_state=carry.attn_state._replace(
                attention_weights=aw, attention_weights_cum=cum,
                alpha=alpha, u=u,
            ),
        ),
        not_finished=nf,
        mel_lengths=mlen,
    )
    mel_outputs, _, alignments = parse_decoder_outputs(cfg, mels, gates,
                                                       aligns)
    return new_state, mel_outputs, gates.transpose(0, 1), alignments
