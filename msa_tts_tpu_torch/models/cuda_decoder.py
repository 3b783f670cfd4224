"""Whole-loop Tacotron-2 inference decoder as one CUDA kernel
(counterpart of ``msa_tts_tpu/models/pallas_decoder.py``).

``cuda_decoder_infer`` runs the entire autoregressive loop, early exit
included, in one persistent cooperative launch of
``csrc/decoder_loop.cu`` and returns what ``decoder.decoder_infer`` (its
plain PyTorch version) returns.  The prenet dropout masks are an input,
as there.  Lowered configs: LSA, or ForwardAttention without
inference windowing or forward_attn_mask.

What the TPU kernel needed and this one does not carry over: the VMEM
budget and its gate (``fits_vmem``), the measured-profitability gate
(``profitable``), the B = 1 pad (``_dup_row0``) and the (B, 8)
lane-width scratch.  B = 1 runs as B = 1.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..kernels.build import load
from ..ops.masking import sequence_mask
from .attention import preprocess_inputs, preprocess_inputs_lsa
from .decoder import Decoder, DecoderConfig, parse_decoder_outputs

# Incremented once per launch of the decoder-loop kernel, and nowhere
# else: a run reads it to show that its decodes went through the kernel.
LAUNCHES = 0

# device-clock stamps per decoder step written when ``phase_ns`` is given
N_STAMPS = 10

_W_NAMES = (
    "w_pre1", "w_pre2", "w_att", "b_att", "w_q", "w_loc", "w_locd",
    "v_w", "v_b", "w_ta", "b_ta", "w_dec", "b_dec", "w_pg", "b_pg",
)


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


@torch.no_grad()
def split_decoder_params(decoder: Decoder, cfg: DecoderConfig) -> dict:
    """The decoder weights in the kernel's layout, all contiguous f32.

    Every matrix keeps the torch (out, in) layout, so a warp reads one
    output's row contiguously.  Each LSTM's input and recurrent weights
    are joined along ``in`` (one dot product covers [x, h]), zero-padded
    to a multiple of 4 floats (16-byte loads), with the two biases
    summed; the mel projection and the gate share one matrix,
    gate row last.  Switched-off parts of the attention get zeros."""
    ap = cfg.attention_params
    flags = _attn_flags(ap)
    E, H = cfg.encoder_embedding_dim, cfg.attention_rnn_dim
    A = ap["attention_dim"]
    F_ = ap.get("attention_location_n_filters", 32)
    K = ap.get("attention_location_kernel_size", 31)
    att = decoder.attention_layer
    arnn, drnn = decoder.attention_rnn, decoder.decoder_rnn
    dev = arnn.weight_ih.device

    def f32(x):
        return x.detach().to(torch.float32).contiguous()

    def lstm(cell):
        w = torch.cat([cell.weight_ih, cell.weight_hh], dim=1)
        return f32(torch.nn.functional.pad(w, (0, -w.shape[1] % 4)))

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    w = {
        "w_pre1": f32(decoder.prenet.layers[0].linear_layer.weight),
        "w_pre2": f32(decoder.prenet.layers[1].linear_layer.weight),
        "w_att": lstm(arnn),
        "b_att": f32(arnn.bias_ih + arnn.bias_hh),
        "w_q": f32(att.query_layer.linear_layer.weight),
        "v_w": f32(att.v.linear_layer.weight.reshape(-1)),
        # LSA's v has no bias
        "v_b": (
            f32(att.v.linear_layer.bias) if att.v.linear_layer.bias
            is not None else zeros(1)
        ),
        "w_dec": lstm(drnn),
        "b_dec": f32(drnn.bias_ih + drnn.bias_hh),
        "w_pg": f32(torch.cat([
            decoder.linear_projection.linear_layer.weight,
            decoder.gate_layer.linear_layer.weight,
        ], dim=0)),
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
        w["w_loc"], w["w_locd"] = zeros(F_, 2, K), zeros(A, F_)
    if flags["fwd"] and flags["tagent"] and hasattr(att, "ta"):
        w["w_ta"] = f32(att.ta.weight.reshape(-1))             # [ctx | q]
        w["b_ta"] = f32(att.ta.bias)
    else:
        w["w_ta"], w["b_ta"] = zeros(E + H), zeros(1)
    return w


def _packed_params(decoder: Decoder, cfg: DecoderConfig) -> dict:
    """:func:`split_decoder_params`, kept on the decoder and packed again
    only when a parameter gets new storage (as after ``.to()``) or is
    changed in place (its version counter moves, as in
    ``load_state_dict``).  A write through ``.data`` skips the version
    counter and is not seen.  The cache is a second copy of the decoder
    weights on their device (~82 MB at the shipped width)."""
    key = (dict(cfg.attention_params),
           tuple((p.data_ptr(), p._version) for p in decoder.parameters()))
    hit = decoder.__dict__.get("_kernel_params")
    if hit is None or hit[0] != key:
        hit = (key, split_decoder_params(decoder, cfg))
        decoder._kernel_params = hit
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
    lib.decoder_loop_launch.argtypes = [ctypes.c_void_p] * 4
    lib.decoder_loop_launch.restype = ctypes.c_int
    for fn in (lib.decoder_loop_scratch_floats, lib.decoder_loop_smem_bytes):
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = ctypes.c_size_t
    lib.decoder_loop_error_string.argtypes = [ctypes.c_int]
    lib.decoder_loop_error_string.restype = ctypes.c_char_p
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
def cuda_decoder_infer(decoder: Decoder, cfg: DecoderConfig,
                       encoder_outputs, input_lengths, pre_masks, *,
                       phase_ns: torch.Tensor | None = None):
    """Drop-in for :func:`decoder.decoder_infer` running the whole AR
    loop in one CUDA kernel launch.  Same arguments and returns:
    ``(mel_outputs (B, n_mel, S·r), gate_outputs (B, S·r), alignments
    (B, S, T_in), mel_lengths (B,) int32, n_steps)``.

    Takes CUDA float32 tensors only (float32 in this version) and raises
    on anything else: there is no fallback to the plain version.

    ``phase_ns``: an optional (S, N_STAMPS) int64 tensor on the device.
    When given, the kernel writes the device clock (``%globaltimer``, ns)
    into row t at the start of step t (column 0), after each of the
    step's eight phase barriers (1-8) and after its stop bookkeeping
    (9); rows from ``n_steps`` on are left as they were."""
    global LAUNCHES
    check_supported(cfg)
    device = encoder_outputs.device
    if device.type != "cuda":
        raise ValueError(
            f"cuda_decoder_infer needs CUDA tensors, got {device}"
        )
    ap = cfg.attention_params
    flags = _attn_flags(ap)
    B, T_in, E = encoder_outputs.shape
    H, Hd, P = cfg.attention_rnn_dim, cfg.decoder_rnn_dim, cfg.prenet_dim
    A = ap["attention_dim"]
    F_ = ap.get("attention_location_n_filters", 32)
    K = ap.get("attention_location_kernel_size", 31)
    MR = cfg.n_mel_channels * cfg.n_frames_per_step
    S = cfg.max_decoder_steps
    if B < 1 or T_in < 1:
        raise ValueError(f"empty batch: B={B}, T_in={T_in}")
    if E != cfg.encoder_embedding_dim:
        raise ValueError(f"encoder width {E} != config "
                         f"{cfg.encoder_embedding_dim}")
    _check("encoder_outputs", encoder_outputs, (B, T_in, E),
           torch.float32, device)
    if tuple(input_lengths.shape) != (B,) or input_lengths.device != device:
        raise ValueError("input_lengths must be (B,) on the encoder's device")
    _check("pre_masks", pre_masks, (S, 2, B, P), torch.float32, device)
    if phase_ns is not None:
        _check("phase_ns", phase_ns, (S, N_STAMPS), torch.int64, device)

    w = _packed_params(decoder, cfg)
    def ld4(n):
        return -(-n // 4) * 4

    shapes = {
        "w_pre1": (P, MR), "w_pre2": (P, P), "w_att": (4 * H, ld4(P + E + H)),
        "b_att": (4 * H,), "w_q": (A, H), "w_loc": (F_, 2, K),
        "w_locd": (A, F_), "v_w": (A,), "v_b": (1,), "w_ta": (E + H,),
        "b_ta": (1,), "w_dec": (4 * Hd, ld4(H + E + Hd)), "b_dec": (4 * Hd,),
        "w_pg": (MR + 1, Hd + E), "b_pg": (MR + 1,),
    }
    for k in _W_NAMES:
        _check(k, w[k], shapes[k], torch.float32, device)

    if ap.get("attention_type") == "LSA":
        pinputs = preprocess_inputs_lsa(decoder.attention_layer,
                                        encoder_outputs)
    else:
        pinputs = preprocess_inputs(decoder.attention_layer,
                                    encoder_outputs)
    pinputs = pinputs.contiguous()
    maskf = sequence_mask(input_lengths, T_in).to(torch.float32)

    dims = (ctypes.c_int * 17)(
        B, T_in, E, H, Hd, P, A, F_, K, MR, S,
        int(cfg.early_stopping), int(flags["loc_att"]), int(flags["fwd"]),
        int(flags["tagent"]), int(flags["norm"] == "sigmoid"),
        int(flags["mask_energies"]),
    )
    lib = _lib()
    smem = lib.decoder_loop_smem_bytes(dims)
    if smem > 227 * 1024:
        raise ValueError(
            f"shapes need {smem} bytes of shared memory per block "
            "(more than the 227 KB a Hopper block can use)"
        )
    n_scratch = lib.decoder_loop_scratch_floats(dims)

    mels = torch.zeros(S, B, MR, dtype=torch.float32, device=device)
    gates = torch.full((S, B), 1e3, dtype=torch.float32, device=device)
    aligns = torch.zeros(S, B, T_in, dtype=torch.float32, device=device)
    mel_lengths = torch.empty(B, dtype=torch.int32, device=device)
    n_steps = torch.empty(1, dtype=torch.int32, device=device)
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=device)

    tensors = (
        encoder_outputs, pinputs, maskf, pre_masks,
        *(w[k] for k in _W_NAMES),
        mels, gates, aligns, mel_lengths, n_steps, scratch,
    )
    ptrs = (ctypes.c_void_p * (len(tensors) + 1))(
        *(t.data_ptr() for t in tensors),
        None if phase_ns is None else phase_ns.data_ptr(),
    )
    fparams = (ctypes.c_float * 2)(
        1.0 - cfg.p_prenet_dropout, cfg.gate_threshold
    )
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.decoder_loop_launch(
            ptrs, dims, fparams, ctypes.c_void_p(stream)
        )
    if rc != 0:
        raise RuntimeError(
            "decoder_loop launch failed: "
            + lib.decoder_loop_error_string(rc).decode()
        )
    LAUNCHES += 1
    return (*parse_decoder_outputs(cfg, mels, gates, aligns),
            mel_lengths, n_steps[0])
