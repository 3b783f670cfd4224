"""The CUDA kernels of the port against their plain PyTorch versions on
the GPU: the decoder kernels (msa_tts_tpu_torch/csrc/decoder_loop.cu),
and further down the WaveRNN sample-loop kernel (csrc/wavernn_loop.cu)
and the LSTM-cell kernel (csrc/lstm_cell.cu).  The decoder kernel is
held for every attention config it lowers and for ragged shapes (B = 1
and B past one staged chunk, T_in shorter than the location kernel, F
wider than a warp).

Also the model's decode routing on CUDA tensors: ``auto`` and ``cuda``
launch the kernel for a config it lowers and raise for one it does not;
only ``torch`` runs the plain loop on the card.  And the opt-in phase
clock stamps.  At the end, ``AdaptiveTTS.adapt`` on the card against the
CPU, and the adapted voice through the decoder kernels.

These tests need a CUDA device and nvcc; elsewhere they skip.  On the GPU
host (no jax there, so without the JAX-side conftest):

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts="" -m cuda -q

Tolerance: f32 on both sides with different summation orders, over 17
autoregressive steps: 1e-5; mel_lengths and n_steps exact.  With
bfloat16 weights kernel and plain loop round every product's input to
bfloat16, where a last-bit difference of a float32 sum moves a value by
2^-8 of its size (2e-3 for the ~0.5 these weights give): 2e-2 over the
17 steps for mels, gates and the LSTM state, 5e-3 for alignments and the
attention's state (values of ~1/T_in), and stop steps are compared
where no gate lies within 2e-2 of the threshold.
"""

import os

import pytest
import torch

from msa_tts_tpu_torch.models import cuda_decoder as CD
from msa_tts_tpu_torch.models.decoder import Decoder, DecoderConfig, decoder_infer

pytestmark = pytest.mark.cuda

ATOL = 1e-5
ATOL_BF16 = 2e-2
ATOL_BF16_ATTENTION = 5e-3
ATTENTION_FIELDS = ("aligns", "attention_weights", "attention_weights_cum",
                    "alpha", "u")
DTYPES = [torch.float32, torch.bfloat16]
AP = {
    "attention_type": "ForwardAttention", "attention_dim": 16,
    "attention_location_n_filters": 8,
    "attention_location_kernel_size": 15, "windowing": False,
    "norm": "softmax", "forward_attn": True, "trans_agent": True,
    "forward_attn_mask": False,
}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _cfg(ap=None, **over):
    kw = dict(
        n_mel_channels=10, n_frames_per_step=2, encoder_embedding_dim=24,
        attention_rnn_dim=20, decoder_rnn_dim=28, prenet_dim=12,
        max_decoder_steps=17, gate_threshold=0.5,
        p_attention_dropout=0.1, p_decoder_dropout=0.1,
        early_stopping=True, attention_params=dict(AP, **(ap or {})),
    )
    kw.update(over)
    return DecoderConfig(**kw)


def _tol(dtype, name="mels"):
    if dtype == torch.float32:
        return ATOL
    return ATOL_BF16_ATTENTION if name in ATTENTION_FIELDS else ATOL_BF16


def _gates_clear(gates, cfg, dtype) -> bool:
    """Whether the stop decisions can be compared: always in float32; in
    bfloat16 only when no gate of the plain run lies within 2e-2 of the
    threshold (a flipped rounding may move a gate that far)."""
    if dtype == torch.float32:
        return True
    live = gates[gates < 999.0]            # 1e3 fills the steps not run
    return bool(((torch.sigmoid(live) - cfg.gate_threshold).abs()
                 > 2e-2).all())


def _compare(cfg, device, B, T_in, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    dec = Decoder(cfg, generator=g).to(device, dtype)
    enc = torch.randn(B, T_in, cfg.encoder_embedding_dim, generator=g)
    lens = torch.randint(1, T_in + 1, (B,), generator=g)
    lens[0] = T_in
    enc, lens = enc.to(device, dtype), lens.to(device)
    masks = CD.prenet_masks(cfg, cfg.max_decoder_steps, B, g, device=device)
    ref = decoder_infer(dec, cfg, enc, lens, masks)
    before = CD.LAUNCHES
    out = CD.cuda_decoder_infer(dec, cfg, enc, lens, masks)
    torch.cuda.synchronize()
    assert CD.LAUNCHES == before + 1
    if not _gates_clear(ref[1], cfg, dtype):
        # the runs may stop at other steps: hold the steps both ran
        n = min(int(out[4]), int(ref[4])) * cfg.n_frames_per_step
        out = (out[0][..., :n], out[1][:, :n], out[2][:, :n // 2])
        ref = (ref[0][..., :n], ref[1][:, :n], ref[2][:, :n // 2])
    for name, a, b in zip(("mels", "gates", "aligns"), out[:3], ref[:3]):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        err = float((a - b).abs().max())
        assert err <= _tol(dtype, name), (name, err)
    if len(out) > 3:
        assert out[3].tolist() == ref[3].tolist()
        assert int(out[4]) == int(ref[4])


@pytest.mark.parametrize("ap", [
    {}, {"norm": "sigmoid"}, {"trans_agent": False},
    {"forward_attn": False}, {"location_attention": False},
    {"mask_energies": True}, {"attention_type": "LSA"},
], ids=str)
@pytest.mark.parametrize("B", [1, 3, 4, 5, 9, 16])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_kernel_matches_plain(device, ap, B, dtype):
    _compare(_cfg(ap), device, B, T_in=11, dtype=dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_rows_stop_at_steps_of_their_own(device, dtype):
    """Early exit: the gate bias is shifted so that the rows stop at
    different steps; the kernel's mel_lengths and n_steps are the plain
    loop's, and the buffers past the last step run hold the fill values."""
    cfg = _cfg(early_stopping=False, max_decoder_steps=24)
    g = torch.Generator().manual_seed(3)
    dec = Decoder(cfg, generator=g).to(device, dtype)
    enc = torch.randn(4, 11, 24, generator=g).to(device, dtype)
    lens = torch.tensor([11, 9, 7, 4], device=device)
    masks = CD.prenet_masks(cfg, 24, 4, g, device=device)
    free = decoder_infer(dec, cfg, enc, lens, masks)
    gates = free[1][:, ::cfg.n_frames_per_step]
    # thresholds between the rows' running maxima: each row fires where
    # its gate first exceeds the shifted threshold
    shift = -float(gates[:, :12].max(dim=1).values.median())
    bias = dec.gate_layer.linear_layer.bias
    with torch.no_grad():
        bias += shift
    stop = cfg._replace(early_stopping=True)
    ref = decoder_infer(dec, stop, enc, lens, masks)
    out = CD.cuda_decoder_infer(dec, stop, enc, lens, masks)
    torch.cuda.synchronize()
    assert len(set(ref[3].tolist())) > 1, ref[3].tolist()
    if _gates_clear(ref[1], stop, dtype):
        assert out[3].tolist() == ref[3].tolist()
        assert int(out[4]) == int(ref[4])
    n = int(out[4])
    assert bool((out[0][..., n * cfg.n_frames_per_step:] == 0).all())
    assert bool((out[1][:, n * cfg.n_frames_per_step:] == 1e3).all())


@pytest.mark.parametrize("shape", [
    dict(T_in=5),                                    # T_in < K
    dict(T_in=37, ap={"attention_location_n_filters": 40,
                      "attention_dim": 48}),         # F > 32 lanes
    dict(T_in=11, over={"p_prenet_dropout": 0.3,
                        "early_stopping": False}),   # non-dyadic keep
    dict(T_in=11, over={"n_frames_per_step": 1, "prenet_dim": 33}),
    dict(T_in=11, over={"attention_rnn_dim": 300,    # more units than
                        "decoder_rnn_dim": 280}),    # blocks: 3 a block
])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_kernel_ragged_shapes(device, shape, dtype):
    cfg = _cfg(shape.get("ap"), **shape.get("over", {}))
    _compare(cfg, device, 3, shape["T_in"], dtype=dtype)


@pytest.mark.parametrize("ap, choice, launches", [
    ({}, "auto", 1),
    ({"windowing": True}, "auto", None),   # not lowered: raises
    ({}, "torch", 0),
    ({"windowing": True}, "torch", 0),     # asked for by name: plain loop
    ({"windowing": True}, "CUDA", None),   # not lowered: raises
])
def test_tacotron2nv_infer_routing(device, ap, choice, launches):
    from msa_tts_tpu_torch.models.tacotron2nv import (
        Tacotron2NV,
        config_from_params,
        tacotron2nv_infer,
    )

    mp = dict(
        n_mel_channels=10, n_frames_per_step=2, n_symbols=50,
        symbols_embedding_dim=16, encoder_n_convolutions=2,
        encoder_embedding_dim=16, encoder_kernel_size=5,
        speaker_emb_type="static", speaker_embedding_dim=8,
        attention_rnn_dim=20, decoder_rnn_dim=28, prenet_dim=12,
        max_decoder_steps=17, gate_threshold=0.5, p_attention_dropout=0.1,
        p_decoder_dropout=0.1, postnet_embedding_dim=16,
        postnet_kernel_size=5, postnet_n_convolutions=2,
        attention_params=dict(AP, **ap),
    )
    cfg = config_from_params(mp)
    g = torch.Generator().manual_seed(0)
    model = Tacotron2NV(cfg, generator=g).to(device).eval()
    args = (
        torch.randint(1, 50, (2, 6), generator=g).to(device),
        torch.tensor([6, 4], device=device),
        torch.randn(2, 8, generator=g).to(device),
        CD.prenet_masks(cfg.decoder_config(), 17, 2, g, device=device),
    )
    before = CD.LAUNCHES
    if launches is None:
        with pytest.raises(ValueError):
            tacotron2nv_infer(model, cfg, *args, decode_backend=choice)
        return
    out = tacotron2nv_infer(model, cfg, *args, decode_backend=choice)
    plain = tacotron2nv_infer(model, cfg, *args, decode_backend="torch")
    torch.cuda.synchronize()
    assert CD.LAUNCHES == before + launches
    assert torch.equal(out[1], plain[1])
    assert float((out[0] - plain[0]).abs().max()) <= ATOL


def test_kernel_rejects_what_it_does_not_take(device):
    cfg = _cfg()
    g = torch.Generator().manual_seed(0)
    dec = Decoder(cfg, generator=g).to(device)
    enc = torch.randn(2, 7, 24, device=device)
    lens = torch.tensor([7, 5], device=device)
    masks = CD.prenet_masks(cfg, 17, 2, g, device=device)
    with pytest.raises(TypeError):
        CD.cuda_decoder_infer(dec, cfg, enc.double(), lens, masks)
    with pytest.raises(ValueError):
        CD.cuda_decoder_infer(dec, cfg, enc, lens, masks[:, :, :1])
    with pytest.raises(ValueError):
        CD.cuda_decoder_infer(dec, _cfg({"windowing": True}), enc, lens,
                              masks)


def test_phase_stamps(device):
    """With a phase_ns buffer the kernel stamps the device clock at every
    phase barrier of every step it ran, in order, and decodes exactly as
    without it."""
    cfg = _cfg(early_stopping=False)
    g = torch.Generator().manual_seed(0)
    dec = Decoder(cfg, generator=g).to(device)
    enc = torch.randn(3, 11, 24, generator=g).to(device)
    lens = torch.tensor([11, 9, 4], device=device)
    masks = CD.prenet_masks(cfg, 17, 3, g, device=device)
    plain = CD.cuda_decoder_infer(dec, cfg, enc, lens, masks)
    ns = torch.zeros(17, CD.N_STAMPS, dtype=torch.int64, device=device)
    timed = CD.cuda_decoder_infer(dec, cfg, enc, lens, masks, phase_ns=ns)
    torch.cuda.synchronize()
    for a, b in zip(timed, plain):
        assert torch.equal(a, b)
    flat = ns.flatten()
    assert bool((flat > 0).all())
    assert bool((flat[1:] >= flat[:-1]).all())


def test_serving_rejects_unlowered_config_on_the_card(device):
    from msa_tts_tpu_torch.models.tacotron2nv import (
        Tacotron2NV,
        config_from_params,
    )
    from msa_tts_tpu_torch.serving import AdaptiveTTS

    mp = dict(
        n_mel_channels=10, n_frames_per_step=2, n_symbols=50,
        symbols_embedding_dim=16, encoder_n_convolutions=2,
        encoder_embedding_dim=16, encoder_kernel_size=5,
        speaker_emb_type="static", speaker_embedding_dim=8,
        attention_rnn_dim=20, decoder_rnn_dim=28, prenet_dim=12,
        max_decoder_steps=17, gate_threshold=0.5, p_attention_dropout=0.1,
        p_decoder_dropout=0.1, postnet_embedding_dim=16,
        postnet_kernel_size=5, postnet_n_convolutions=2,
        attention_params=dict(AP, windowing=True),
    )
    model = Tacotron2NV(config_from_params(mp))
    params = {"model": mp, "audio_params": {"n_mels": 10}}
    with pytest.raises(ValueError):
        AdaptiveTTS(params, model, device=device)
    AdaptiveTTS(dict(params, decode_backend="torch"), model, device=device)


# ---------------------------------------------------------------------
# The segment kernel (K2): ``cuda_decoder_segment`` against its plain
# version ``decoder_infer_segment``, and chained against the whole loop
# ---------------------------------------------------------------------

def _contiguous(st: dict) -> dict:
    """A plain-path state with every tensor contiguous, as the kernel
    takes it."""
    from msa_tts_tpu_torch.models.decoder import DecoderCarry

    c = st["carry"]
    return dict(
        st, decoder_input=st["decoder_input"].contiguous(),
        carry=DecoderCarry(
            *(x.contiguous() for x in c[:5]),
            c.attn_state._replace(**{
                k: v.contiguous()
                for k, v in c.attn_state._asdict().items()
            }),
        ),
    )


def _flat(st: dict) -> dict:
    c = st["carry"]
    return dict(
        din=st["decoder_input"], ah=c.attention_hidden,
        ac=c.attention_cell, dh=c.decoder_hidden, dc=c.decoder_cell,
        ctx=c.attention_context, **{
            k: v for k, v in c.attn_state._asdict().items()
            if k != "win_idx"
        },
    )


def _segment_setup(cfg, device, B, T_in, n_steps, seed=0,
                   dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    dec = Decoder(cfg, generator=g).to(device, dtype)
    enc = torch.randn(B, T_in, cfg.encoder_embedding_dim, generator=g)
    lens = torch.randint(1, T_in + 1, (B,), generator=g)
    lens[0] = T_in
    enc, lens = enc.to(device, dtype), lens.to(device)
    masks = CD.prenet_masks(cfg, n_steps, B, g, device=device)
    return dec, enc, lens, masks


def _compare_segment(cfg, device, B, T_in, n_pre=4, n_seg=5,
                     dtype=torch.float32):
    """One n_seg-step segment from the plain state after n_pre steps:
    kernel and plain outputs and every state field within the type's
    tolerance (``u`` included), flags and lengths exact (bfloat16: where
    no gate lies near the threshold), one launch."""
    from msa_tts_tpu_torch.models.decoder import (
        decoder_infer_segment,
        decoder_stream_init,
    )

    dec, enc, lens, masks = _segment_setup(cfg, device, B, T_in,
                                           n_pre + n_seg, dtype=dtype)
    st = decoder_stream_init(cfg, B, T_in, device=device)
    st, *_ = decoder_infer_segment(dec, cfg, enc, lens, masks[:n_pre], st,
                                   n_pre)
    st = _contiguous(st)
    seg_masks = masks[n_pre:].contiguous()
    ref = decoder_infer_segment(dec, cfg, enc, lens, seg_masks, st, n_seg)
    pin, maskf = CD.segment_inputs(dec, cfg, enc, lens)
    before = CD.SEG_LAUNCHES
    out = CD.cuda_decoder_segment(dec, cfg, enc, pin, maskf, seg_masks, st,
                                  n_seg)
    torch.cuda.synchronize()
    assert CD.SEG_LAUNCHES == before + 1
    for name, a, b in zip(("mels", "gates", "aligns"), out[1:], ref[1:]):
        assert a.shape == b.shape, name
        err = float((a - b).abs().max())
        assert err <= _tol(dtype, name), (name, err)
    ours, theirs = _flat(out[0]), _flat(ref[0])
    for name in ours:
        assert ours[name].shape == theirs[name].shape, name
        assert ours[name].dtype == torch.float32, name
        err = float((ours[name] - theirs[name]).abs().max())
        assert err <= _tol(dtype, name), (name, err)
    assert torch.equal(out[0]["step"], ref[0]["step"])
    if _gates_clear(ref[2], cfg, dtype):
        for name in ("not_finished", "mel_lengths"):
            assert torch.equal(out[0][name], ref[0][name]), name


@pytest.mark.parametrize("ap", [
    {}, {"norm": "sigmoid"}, {"trans_agent": False},
    {"forward_attn": False}, {"location_attention": False},
    {"mask_energies": True}, {"attention_type": "LSA"},
], ids=str)
@pytest.mark.parametrize("B", [1, 3, 4, 5, 9, 16])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_segment_kernel_matches_plain(device, ap, B, dtype):
    _compare_segment(_cfg(ap), device, B, T_in=11, dtype=dtype)


@pytest.mark.parametrize("shape", [
    dict(T_in=5),                                    # T_in < K
    dict(T_in=37, ap={"attention_location_n_filters": 40,
                      "attention_dim": 48}),         # F > 32 lanes
    dict(T_in=11, over={"p_prenet_dropout": 0.3}),   # non-dyadic keep
    dict(T_in=11, over={"n_frames_per_step": 1, "prenet_dim": 33}),
])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_segment_kernel_ragged_shapes(device, shape, dtype):
    cfg = _cfg(shape.get("ap"), **shape.get("over", {}))
    _compare_segment(cfg, device, 3, shape["T_in"], dtype=dtype)


def test_segment_state_after_first_segment(device):
    """From a fresh stream state the first segment's state, the
    transition agent ``u`` included, matches the plain one: the kernel
    skips the deferred agent at its first step and computes the last
    step's in its tail."""
    _compare_segment(_cfg(early_stopping=False), device, 2, T_in=11,
                     n_pre=0, n_seg=6)


@pytest.mark.parametrize("n_seg", [4, 6])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_segment_chain_equals_whole_loop_kernel(device, n_seg, dtype):
    """Chained segments give the whole-loop kernel's bits: the same step
    function, and an agent that is never stale.  S = 20: 4 divides it,
    6 does not (the last segment overshoots)."""
    from msa_tts_tpu_torch.models.decoder import decoder_stream_init
    from msa_tts_tpu_torch.serving import _segment_masks

    cfg = _cfg(early_stopping=False, max_decoder_steps=20)
    S, r = cfg.max_decoder_steps, cfg.n_frames_per_step
    dec, enc, lens, masks = _segment_setup(cfg, device, 3, 11, S,
                                           dtype=dtype)
    whole = CD.cuda_decoder_infer(dec, cfg, enc, lens, masks)
    pin, maskf = CD.segment_inputs(dec, cfg, enc, lens)
    st = decoder_stream_init(cfg, 3, 11, device=device)
    parts = []
    for step in range(0, S, n_seg):
        st, *o = CD.cuda_decoder_segment(
            dec, cfg, enc, pin, maskf, _segment_masks(masks, step, n_seg),
            st, n_seg)
        parts.append(o)
    mels, gates, aligns = (torch.cat(x, dim=1 if i == 2 else -1)
                           for i, x in enumerate(zip(*parts)))
    torch.cuda.synchronize()
    assert torch.equal(mels[..., : S * r], whole[0])
    assert torch.equal(gates[:, :S].repeat_interleave(r, dim=1), whole[1])
    assert torch.equal(aligns[:, :S], whole[2])
    if S % n_seg == 0:
        assert torch.equal(st["mel_lengths"], whole[3])


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_segment_rows_independent_of_batch(device, dtype):
    """A row of a B = 3 segment equals the same row decoded alone: no
    phase sums in an order that depends on B or the grid."""
    from msa_tts_tpu_torch.models.decoder import decoder_stream_init

    cfg = _cfg(early_stopping=False)
    dec, enc, lens, masks = _segment_setup(cfg, device, 3, 11, 8,
                                           dtype=dtype)
    pin, maskf = CD.segment_inputs(dec, cfg, enc, lens)
    st = decoder_stream_init(cfg, 3, 11, device=device)
    all_rows = CD.cuda_decoder_segment(dec, cfg, enc, pin, maskf, masks, st,
                                       8)
    for b in range(3):
        st1 = decoder_stream_init(cfg, 1, 11, device=device)
        one = CD.cuda_decoder_segment(
            dec, cfg, enc[b:b + 1].contiguous(), pin[b:b + 1].contiguous(),
            maskf[b:b + 1].contiguous(), masks[:, :, b:b + 1].contiguous(),
            st1, 8)
        for a, o in zip(all_rows[1:], one[1:]):
            assert torch.equal(a[b:b + 1], o), b


def test_segment_kernel_rejects_what_it_does_not_take(device):
    from msa_tts_tpu_torch.models.decoder import decoder_stream_init

    cfg = _cfg()
    dec, enc, lens, masks = _segment_setup(cfg, device, 2, 7, 4)
    pin, maskf = CD.segment_inputs(dec, cfg, enc, lens)
    st = decoder_stream_init(cfg, 2, 7, device=device)
    seg = CD.cuda_decoder_segment
    with pytest.raises(TypeError):
        seg(dec, cfg, enc.double(), pin, maskf, masks, st, 4)
    with pytest.raises(ValueError):
        seg(dec, cfg, enc, pin, maskf, masks[:, :, :1], st, 4)
    with pytest.raises(ValueError):
        seg(dec, cfg, enc, pin, maskf, masks, st, 3)     # masks for 4
    bad = dict(st, decoder_input=st["decoder_input"].t().contiguous().t())
    with pytest.raises(ValueError, match="contiguous"):
        seg(dec, cfg, enc, pin, maskf, masks, bad, 4)
    with pytest.raises(ValueError):
        seg(dec, _cfg({"windowing": True}), enc, pin, maskf, masks, st, 4)
    with pytest.raises(ValueError, match="CUDA"):
        seg(dec.cpu(), cfg, enc.cpu(), pin.cpu(), maskf.cpu(), masks.cpu(),
            decoder_stream_init(cfg, 2, 7, device="cpu"), 4)


def _tiny_tts(device, **params):
    from msa_tts_tpu_torch.models.tacotron2nv import (
        Tacotron2NV,
        config_from_params,
    )
    from msa_tts_tpu_torch.serving import N_SYMBOLS, AdaptiveTTS

    mp = dict(
        n_mel_channels=10, n_frames_per_step=2, n_symbols=N_SYMBOLS,
        symbols_embedding_dim=16, encoder_n_convolutions=2,
        encoder_embedding_dim=16, encoder_kernel_size=5,
        speaker_emb_type="static", speaker_embedding_dim=8,
        attention_rnn_dim=20, decoder_rnn_dim=28, prenet_dim=12,
        max_decoder_steps=24, gate_threshold=0.9, p_attention_dropout=0.1,
        p_decoder_dropout=0.1, decoder_no_early_stopping=True,
        postnet_embedding_dim=16, postnet_kernel_size=5,
        postnet_n_convolutions=2, attention_params=dict(AP),
    )
    model = Tacotron2NV(config_from_params(mp),
                        generator=torch.Generator().manual_seed(0))
    audio = dict(sample_rate=22050, n_fft=512, win_length=512,
                 hop_length=128, f_min=0.0, f_max=8000.0, n_mels=10,
                 griffinlim_iters=4)
    return AdaptiveTTS(dict(params, model=mp, audio_params=audio), model,
                       device=device)


def test_stream_and_mux_route_through_the_segment_kernel(device):
    """On the card a stream and a muxed stream decode through the
    segment kernel (one launch per segment, one per tick), the stream
    equals the offline mel, and the muxed streams equal their solo
    streams; ``torch``, named, runs the plain segment."""
    import numpy as np

    from msa_tts_tpu_torch.stream_mux import StreamMultiplexer

    tts = _tiny_tts(device)
    emb = np.zeros(8, np.float32)
    off = tts.synthesize("hello world", vocoder="none", spk_emb=emb)
    before = CD.SEG_LAUNCHES
    streamed = np.concatenate(list(tts.synthesize_stream(
        "hello world", vocoder="none", spk_emb=emb, segment_steps=5)), -1)
    assert CD.SEG_LAUNCHES == before + 5           # ceil(24 / 5)
    assert streamed.shape == off.shape
    assert np.abs(streamed - off).max() <= 1e-4
    plain = _tiny_tts(device, decode_backend="torch")
    plain.model.load_state_dict(tts.model.state_dict())
    before = CD.SEG_LAUNCHES
    list(plain.synthesize_stream("hello world", spk_emb=emb))
    assert CD.SEG_LAUNCHES == before

    texts = ["hello world", "a second one", "third"]
    solo = [np.concatenate(list(tts.synthesize_stream(
        t, vocoder="none", spk_emb=emb, seed=i, segment_steps=4,
        text_pad_multiple=16)), -1) for i, t in enumerate(texts)]
    mux = StreamMultiplexer(tts, n_slots=3, t_cap=16, segment_steps=4)
    try:
        assert mux.backend == "cuda"
        before = CD.SEG_LAUNCHES
        gens = [mux.stream(t, spk_emb=emb, vocoder="none", seed=i)
                for i, t in enumerate(texts)]
        outs = [np.concatenate(list(g), -1) for g in gens]
        assert CD.SEG_LAUNCHES - before == mux.metrics()["ticks_total"]
        for a, b in zip(outs, solo):
            assert a.shape == b.shape
            assert np.abs(a - b).max() <= 1e-5
    finally:
        mux.close()
    with pytest.raises(ValueError, match="per_slot_params"):
        StreamMultiplexer(tts, n_slots=2, t_cap=16, per_slot_params=True)
    StreamMultiplexer(tts, n_slots=2, t_cap=16, backend="torch",
                      per_slot_params=True).close()


# ---------------------------------------------------------------------
# WaveRNN sample-loop kernel (csrc/wavernn_loop.cu) and the LSTM-cell
# kernel (csrc/lstm_cell.cu) against their plain PyTorch versions
# ---------------------------------------------------------------------
# Tolerances: f32 weights, f32 on both sides in other summation orders,
# fed back over 37 sample steps: 1e-5.  bf16 weights round every
# product's input to bf16, where a last-bit difference moves a value by
# 2^-8 relative: 2e-2 over 37 steps.

GEN_CFG = dict(rnn_dims=64, fc_dims=64, res_out_dims=32, n_mels=20,
               res_blocks=2, hop_length=16, pad=2,
               upsample_factors=(2, 2, 4))


def _gen_case(device, B, T, dtype=None, seed=0, **over):
    from msa_tts_tpu_torch.vocoders import wavernn as W

    cfg = W.WaveRNNConfig(**dict(GEN_CFG, **over))
    g = torch.Generator().manual_seed(seed)
    model = W.WaveRNNModel(cfg, g).to(device)
    gp = W.cast_generation_params(model, dtype)
    mels_up = torch.randn(B, T, cfg.n_mels, generator=g).to(device)
    aux = (torch.randn(B, T, cfg.res_out_dims, generator=g).to(device)
           if cfg.use_aux_net else None)
    n1, n2 = W.generation_noise(cfg, g, T, B, device=device)
    return cfg, gp, mels_up, aux, n1, n2


# rows: one, a partial chunk of 16, half a chunk, and the fold rows of a
# stream window (8), an utterance (44, 80) and a batch of four (320)
@pytest.mark.parametrize("B", [1, 5, 8, 44, 80, 320])
@pytest.mark.parametrize("over,dtype,atol", [
    (dict(mode="MOL"), None, 1e-5),
    (dict(mode="GAUSS"), None, 1e-5),
    (dict(mode="MOL", use_aux_net=False), None, 1e-5),
    (dict(mode="GAUSS", use_aux_net=False), None, 1e-5),
    (dict(mode="MOL"), torch.bfloat16, 2e-2),
    (dict(mode="GAUSS"), torch.bfloat16, 2e-2),
], ids=["mol", "gauss", "mol-noaux", "gauss-noaux", "mol-bf16",
        "gauss-bf16"])
def test_gen_kernel_matches_plain(device, over, dtype, atol, B):
    from msa_tts_tpu_torch.vocoders import cuda_gen as G
    from msa_tts_tpu_torch.vocoders import wavernn as W

    T = 37                                  # odd: nothing pads T
    cfg, gp, mels_up, aux, n1, n2 = _gen_case(device, B, T, dtype, **over)
    ref = W.generate_samples(gp, cfg, mels_up, aux, n1, n2, backend="torch")
    before = G.GEN_LAUNCHES
    out = W.generate_samples(gp, cfg, mels_up, aux, n1, n2)    # auto
    torch.cuda.synchronize()
    assert G.GEN_LAUNCHES == before + 1
    assert out.shape == ref.shape == (B, T)
    assert torch.isfinite(out).all()
    err = float((out - ref).abs().max())
    assert err <= atol, err


@pytest.mark.parametrize("dtype", [None, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_gen_kernel_rows_independent_of_batch(device, dtype):
    """A row's sums are taken in an order fixed by the widths (on the
    tensor cores too: a row is one column of a tile, whichever), so from
    the same hoisted inputs a row alone gives the bits it gives in a
    batch (the hoisted projection is a library product outside the
    kernel and is computed once here).  53 rows: three staged chunks,
    the last one partial."""
    from msa_tts_tpu_torch.vocoders import cuda_gen as G
    from msa_tts_tpu_torch.vocoders import wavernn as W

    cfg, gp, mels_up, aux, n1, n2 = _gen_case(device, 53, 25, dtype)
    w = G.kernel_weights(gp, cfg)
    ist, ar = W.hoisted_inputs(gp, cfg, mels_up, aux)
    full = G.cuda_generate(w, cfg, ist, ar, n1, n2)
    for b in (0, 7, 20, 31, 52):
        one = G.cuda_generate(w, cfg, *(x[:, b:b + 1].contiguous()
                                        for x in (ist, ar, n1, n2)))
        assert torch.equal(one[0], full[b]), b
    # nor on the clock stamps
    stamps = torch.zeros(25, G.N_STAMPS, dtype=torch.int64, device=device)
    assert torch.equal(
        G.cuda_generate(w, cfg, ist, ar, n1, n2, phase_ns=stamps), full)
    torch.cuda.synchronize()
    assert (stamps > 0).all()
    bd = G.phase_breakdown(stamps)
    assert set(bd) == set(G.PHASES)
    assert all(0.0 <= v < 1e3 for d in bd.values() for v in d.values())
    assert 0.0 < G.barrier_us(n=50) < 100.0


@pytest.mark.parametrize("B", [8, 37, 200, 1193])
@pytest.mark.parametrize("dtype", [None, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_gen_kernel_default_width_rows_stand_alone(device, dtype, B):
    """At the default width over 300 steps, through the staging as the
    card runs it there (bf16 below WEIGHTS_BY_PHASE_ROWS rows: the slice
    resident, chunks of 24 rows copied by every thread; from there on
    one phase's weights at a time, GRU chunks of 40 rows and fc chunks of
    72 copied by the last four warps, products over two 8-row tiles at
    once; f32: by phase, GRU 16 rows, fc 24): a row gives the bits it
    gives alone, whatever chunk, buffer and tile pair it passed through.
    8 rows: one chunk; 37: a partial one, an odd tile; 200: many, both
    buffers refilled; 1,193: sample groups of 10 rows, one a block, the
    last of 3."""
    from msa_tts_tpu_torch.vocoders import cuda_gen as G
    from msa_tts_tpu_torch.vocoders import wavernn as W

    T = 300
    cfg = W.WaveRNNConfig()
    g = torch.Generator().manual_seed(B)
    model = W.WaveRNNModel(cfg, g).to(device)
    gp = W.cast_generation_params(model, dtype)
    mels_up = torch.randn(B, T, cfg.n_mels, generator=g).to(device)
    aux = torch.randn(B, T, cfg.res_out_dims, generator=g).to(device)
    n1, n2 = W.generation_noise(cfg, g, T, B, device=device)
    w = G.kernel_weights(gp, cfg)
    pl = G.kernel_plan(cfg, w["n_blocks"], dtype is not None,
                       by_phase=B >= G.WEIGHTS_BY_PHASE_ROWS)
    ist, ar = W.hoisted_inputs(gp, cfg, mels_up, aux)
    full = G.cuda_generate(w, cfg, ist, ar, n1, n2)
    assert torch.isfinite(full).all() and full.abs().max() <= 1.0
    for b in sorted(b for b in {0, pl["ch"] - 1, pl["ch"], B // 2, B - 1}
                    if b < B):
        one = G.cuda_generate(w, cfg, *(x[:, b:b + 1].contiguous()
                                        for x in (ist, ar, n1, n2)))
        assert torch.equal(one[0], full[b]), b


def test_gen_kernel_serves_rnn_and_fc_1024_in_bf16(device):
    """With one phase's weights in shared memory at a time, rnn and fc
    1,024 fit in bf16 (8 rows a chunk, two partial-sum tiles a GRU), so
    the wrapper copies them in by phase even at 19 rows: the kernel
    against the plain loop over 12 steps at the bf16 tolerance, and a
    row alone gives its bits in the batch."""
    from msa_tts_tpu_torch.vocoders import cuda_gen as G
    from msa_tts_tpu_torch.vocoders import wavernn as W

    B, T = 19, 12
    cfg, gp, mels_up, aux, n1, n2 = _gen_case(
        device, B, T, torch.bfloat16, rnn_dims=1024, fc_dims=1024)
    assert G.kernel_plan(cfg, G._default_blocks(mels_up), True)["ch"] == 8
    ref = W.generate_samples(gp, cfg, mels_up, aux, n1, n2, backend="torch")
    w = G.kernel_weights(gp, cfg)
    ist, ar = W.hoisted_inputs(gp, cfg, mels_up, aux)
    out = G.cuda_generate(w, cfg, ist, ar, n1, n2)
    err = float((out - ref).abs().max())
    assert err <= 2e-2, err
    one = G.cuda_generate(w, cfg, *(x[:, 11:12].contiguous()
                                    for x in (ist, ar, n1, n2)))
    assert torch.equal(one[0], out[11])


def test_gen_kernel_rejects_what_it_does_not_take(device):
    from msa_tts_tpu_torch.vocoders import cuda_gen as G
    from msa_tts_tpu_torch.vocoders import wavernn as W

    cfg, gp, mels_up, aux, n1, n2 = _gen_case(device, 3, 9)
    w = G.kernel_weights(gp, cfg)
    ist, ar = W.hoisted_inputs(gp, cfg, mels_up, aux)
    before = G.GEN_LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        G.cuda_generate(w, cfg, ist.cpu(), ar.cpu(), n1.cpu(), n2.cpu())
    with pytest.raises(TypeError):
        G.cuda_generate(w, cfg, ist.double(), ar, n1, n2)
    with pytest.raises(ValueError, match="contiguous"):
        G.cuda_generate(w, cfg, ist.transpose(0, 1).contiguous()
                        .transpose(0, 1), ar, n1, n2)
    with pytest.raises(ValueError, match="shape"):
        G.cuda_generate(w, cfg, ist, ar, n1[:, :2], n2)
    with pytest.raises(TypeError):
        G.cuda_generate(dict(w, packed=w["packed"].half()), cfg, ist, ar,
                        n1, n2)
    with pytest.raises(ValueError, match="shape"):
        G.cuda_generate(w, cfg, ist, ar, n1, n2, phase_ns=torch.zeros(
            9, 3, dtype=torch.int64, device=device))
    # a width whose bf16 weights of one phase outgrow a block's shared
    # memory
    wide = W.WaveRNNConfig(**dict(GEN_CFG, rnn_dims=1536, fc_dims=1536))
    model = W.WaveRNNModel(wide, torch.Generator().manual_seed(0)).to(device)
    with pytest.raises(ValueError, match="of one phase's weights"):
        G.kernel_weights(W.cast_generation_params(model, torch.bfloat16),
                         wide)
    assert G.GEN_LAUNCHES == before


def test_wavernn_noise_is_drawn_on_the_card(device):
    """A CPU generator asked for noise on the card seeds a generator
    there: the draw is on the device, fixed by the caller's seed, and
    advances the caller's generator."""
    from msa_tts_tpu_torch.vocoders import wavernn as W

    for mode in ("MOL", "GAUSS"):
        cfg = W.WaveRNNConfig(**dict(GEN_CFG, mode=mode))
        a = W.generation_noise(cfg, torch.Generator().manual_seed(5), 7, 3,
                               device=device)
        g = torch.Generator().manual_seed(5)
        b = W.generation_noise(cfg, g, 7, 3, device=device)
        c = W.generation_noise(cfg, g, 7, 3, device=device)
        for x, y, z in zip(a, b, c):
            assert x.device.type == "cuda" and torch.isfinite(x).all()
            assert torch.equal(x, y)
        assert not torch.equal(b[0], c[0])


@pytest.mark.parametrize("choice,launches", [
    ("auto", None), ("cuda", None), ("torch", 0),
])
def test_gen_backend_routing_for_an_unserved_config(device, choice,
                                                    launches):
    """A width the kernel does not serve (rnn_dims not a multiple of 4)
    raises under ``auto`` and ``cuda`` on CUDA tensors; only ``torch``,
    named, runs the plain loop on the card."""
    from msa_tts_tpu_torch.vocoders import cuda_gen as G
    from msa_tts_tpu_torch.vocoders import wavernn as W

    cfg, gp, mels_up, aux, n1, n2 = _gen_case(device, 2, 5, rnn_dims=66)
    before = G.GEN_LAUNCHES
    if launches is None:
        with pytest.raises(ValueError, match="multiples of 4"):
            W.generate_samples(gp, cfg, mels_up, aux, n1, n2,
                               backend=choice)
    else:
        out = W.generate_samples(gp, cfg, mels_up, aux, n1, n2,
                                 backend=choice)
        assert out.shape == (2, 5)
    assert G.GEN_LAUNCHES == before


def test_wavernn_generate_batch_through_the_kernel(device):
    """``WaveRNN.generate_batch`` on the card: one launch for all folds
    of all utterances, lengths as on the CPU, and the kernel's waveform
    against the plain loop's from the same noise (f32, 1e-4)."""
    from msa_tts_tpu_torch.vocoders import cuda_gen as G
    from msa_tts_tpu_torch.vocoders import wavernn as W

    cfg = W.WaveRNNConfig(**GEN_CFG)
    g = torch.Generator().manual_seed(0)
    model = W.WaveRNNModel(cfg, g)
    mels = [torch.randn(cfg.n_mels, t, generator=g) - 4.0
            for t in (11, 5, 1)]
    kw = dict(target=64, overlap=16, bucket_frames=4, verbose=False)
    outs = {}
    for backend in ("auto", "torch"):
        voc = W.WaveRNN(model, cfg, gen_dtype=None, gen_backend=backend,
                        device=device)
        before = G.GEN_LAUNCHES
        outs[backend] = voc.generate_batch(
            mels, generators=[torch.Generator().manual_seed(i)
                              for i in range(3)], **kw)
        assert G.GEN_LAUNCHES - before == (1 if backend == "auto" else 0)
    for a, b, m in zip(outs["auto"], outs["torch"], mels):
        assert len(a) == len(b) == max(m.shape[1] - 1, 1) * cfg.hop_length
        assert float(abs(a - b).max()) <= 1e-4


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 1e-5)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("H", [64, 256, 1024])
@pytest.mark.parametrize("B", [1, 3, 16, 17, 20, 33])
def test_lstm_cell_kernel_matches_plain(device, dtype, atol, B, H):
    """One step, so the bf16 variant (same rounded h and weights on both
    sides, f32 sums in another order) holds the f32 tolerance.  B covers
    one row, a part of an m16 tile, one tile, and rows past it (bf16:
    2-3 tiles in one pass; f32: a second pass over the weights)."""
    from msa_tts_tpu_torch.experimental import cuda_lstm_cell as C

    g = torch.Generator().manual_seed(B)
    xp, h, c = (torch.randn(B, n, generator=g).to(device)
                for n in (4 * H, H, H))
    w = (torch.randn(H, 4 * H, generator=g) / H ** 0.5).to(device).to(dtype)
    before = C.CELL_LAUNCHES
    hk, ck = C.cuda_lstm_cell(xp, h, c, w)
    torch.cuda.synchronize()
    assert C.CELL_LAUNCHES == before + 1
    hr, cr = C.lstm_cell_reference(xp, h, c, w)
    assert float((hk - hr).abs().max()) <= atol
    assert float((ck - cr).abs().max()) <= atol


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_lstm_cell_launch_repeats_bit_for_bit(device, dtype):
    """The cluster's and the warps' partial sums are added in a fixed
    order: one launch repeated on the same inputs gives the same bits."""
    from msa_tts_tpu_torch.experimental import cuda_lstm_cell as C

    B, H = 16, 1024
    g = torch.Generator().manual_seed(7)
    xp, h, c = (torch.randn(B, n, generator=g).to(device)
                for n in (4 * H, H, H))
    w = (torch.randn(H, 4 * H, generator=g) / H ** 0.5).to(device).to(dtype)
    first = C.cuda_lstm_cell(xp, h, c, w)
    for _ in range(3):
        again = C.cuda_lstm_cell(xp, h, c, w)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


# bf16 weights, a 400-step scan against the plain bf16 scan at B = 16,
# H = 1024: a last-bit difference of an f32 sum can flip a bf16 rounding
# of h, which feeds back; 4 x the reading of 5.1e-4 (NVIDIA H100 80GB
# HBM3, 700 W).
LSTM_BF16_SCAN_ATOL = 2e-3


def test_lstm_scan_bf16_matches_plain(device, monkeypatch):
    """The kernel's bf16 scan (chained launches) against the plain bf16
    scan, and one packing of the weight for the whole scan."""
    from msa_tts_tpu_torch.experimental import cuda_lstm_cell as C

    T, B, H = 400, 16, 1024
    g = torch.Generator().manual_seed(0)
    xs = torch.randn(T, B, 4 * H, generator=g).to(device)
    w = ((torch.randn(H, 4 * H, generator=g) / H ** 0.5).to(device)
         .to(torch.bfloat16))
    h0, c0 = (torch.randn(B, H, generator=g).to(device) for _ in range(2))
    packs = []
    pack = C.pack_weights
    monkeypatch.setattr(C, "pack_weights",
                        lambda t: packs.append(t) or pack(t))
    before = C.CELL_LAUNCHES
    hs, (h, c) = C.lstm_scan(xs, h0, c0, w)
    assert C.CELL_LAUNCHES == before + T and len(packs) == 1
    C.lstm_scan(xs, h0, c0, w)
    assert len(packs) == 1                   # kept for the same weight
    ref, (hr, cr) = C.lstm_scan(xs, h0, c0, w, backend="torch")
    assert float((hs - ref).abs().max()) <= LSTM_BF16_SCAN_ATOL
    assert float((c - cr).abs().max()) <= LSTM_BF16_SCAN_ATOL


def test_lstm_scan_and_refusals(device):
    from msa_tts_tpu_torch.experimental import cuda_lstm_cell as C

    T, B, H = 12, 5, 64
    g = torch.Generator().manual_seed(0)
    xs = torch.randn(T, B, 4 * H, generator=g).to(device)
    w = (torch.randn(H, 4 * H, generator=g) / H ** 0.5).to(device)
    h0 = torch.zeros(B, H, device=device)
    c0 = torch.zeros(B, H, device=device)
    before = C.CELL_LAUNCHES
    hs, (h, c) = C.lstm_scan(xs, h0, c0, w)
    assert C.CELL_LAUNCHES == before + T
    ref, (hr, cr) = C.lstm_scan(xs, h0, c0, w, backend="torch")
    assert C.CELL_LAUNCHES == before + T
    assert float((hs - ref).abs().max()) <= 1e-5
    assert float((c - cr).abs().max()) <= 1e-5
    with pytest.raises(ValueError, match="CUDA"):
        C.cuda_lstm_cell(xs[0].cpu(), h0.cpu(), c0.cpu(), w.cpu())
    with pytest.raises(TypeError):
        C.cuda_lstm_cell(xs[0].double(), h0, c0, w)
    with pytest.raises(ValueError, match="multiple of 8"):
        C.cuda_lstm_cell(xs[0][:, :4 * 60], h0[:, :60].contiguous(),
                         c0[:, :60].contiguous(), w[:60, :240].contiguous())
    with pytest.raises(ValueError, match="alias"):
        C.cuda_lstm_cell(xs[0], h0, c0, w, out=(h0, c0))
    with pytest.raises(ValueError, match="contiguous"):
        C.cuda_lstm_cell(xs[0], h0, c0, w.t().contiguous().t())


def _vocoding_tts(device):
    """A tiny ``AdaptiveTTS`` on the card that decodes every row to its
    12 steps, with a WaveRNN and a HiFi-GAN attached."""
    from msa_tts_tpu_torch.models.tacotron2nv import (
        Tacotron2NV,
        config_from_params,
    )
    from msa_tts_tpu_torch.serving import AdaptiveTTS
    from msa_tts_tpu_torch.vocoders.hifigan import Generator, HiFiGAN
    from msa_tts_tpu_torch.vocoders.wavernn import WaveRNN, WaveRNNConfig

    mp = dict(
        n_mel_channels=10, n_frames_per_step=2, n_symbols=200,
        symbols_embedding_dim=16, encoder_n_convolutions=2,
        encoder_embedding_dim=16, encoder_kernel_size=5,
        speaker_emb_type="static", speaker_embedding_dim=8,
        attention_rnn_dim=20, decoder_rnn_dim=28, prenet_dim=12,
        max_decoder_steps=12, gate_threshold=0.5, p_attention_dropout=0.1,
        p_decoder_dropout=0.1, decoder_no_early_stopping=True,
        postnet_embedding_dim=16, postnet_kernel_size=5,
        postnet_n_convolutions=2, attention_params=dict(AP),
    )
    audio = dict(sample_rate=22050, n_fft=512, win_length=512,
                 hop_length=128, f_min=0.0, f_max=8000.0, n_mels=10,
                 griffinlim_iters=2)
    g = torch.Generator().manual_seed(0)
    tts = AdaptiveTTS({"model": mp, "audio_params": audio},
                      Tacotron2NV(config_from_params(mp), generator=g),
                      device=device)
    with torch.no_grad():
        tts.model.decoder.gate_layer.linear_layer.bias.fill_(-1e4)
    wcfg = WaveRNNConfig(rnn_dims=32, fc_dims=32, res_out_dims=16,
                         compute_dims=16, n_mels=10, res_blocks=2,
                         hop_length=128, upsample_factors=(4, 4, 8))
    tts.attach_vocoder("wavernn", WaveRNN(cfg=wcfg, generator=g,
                                          device=device))
    h = dict(resblock="1", upsample_rates=[8, 4, 4],
             upsample_kernel_sizes=[16, 8, 8], upsample_initial_channel=16,
             resblock_kernel_sizes=[3, 5],
             resblock_dilation_sizes=[[1, 3], [1, 2]])
    tts.attach_vocoder("hifigan", HiFiGAN.from_params(
        Generator(h, 10, g), h))
    return tts


def test_serving_vocodes_through_the_gen_kernel(device):
    """``AdaptiveTTS`` with an attached WaveRNN and HiFi-GAN on the card:
    one sample-loop launch per vocoded request or batch, wav lengths
    (T-1)·hop and T·hop."""
    from msa_tts_tpu_torch.vocoders import cuda_gen as G

    tts = _vocoding_tts(device)
    emb = torch.zeros(8).numpy()
    before = G.GEN_LAUNCHES
    one = tts.synthesize("hello world", spk_emb=emb, vocoder="wavernn")
    many = tts.synthesize_batch(["hello", "hello world"], spk_emb=emb,
                                vocoder="wavernn")
    assert G.GEN_LAUNCHES == before + 2
    for w in [one, *many]:
        assert w.shape == (23 * 128,) and abs(w).max() <= 1.0
    hw = tts.synthesize("hello world", spk_emb=emb, vocoder="hifigan")
    assert hw.shape == (24 * 128,)
    n = sum(len(c) for c in tts.synthesize_stream(
        "hello world", spk_emb=emb, vocoder="wavernn", segment_steps=4,
        chunk_frames=8, vocode_ctx_frames=2))
    assert n == 23 * 128
    assert G.GEN_LAUNCHES > before + 2


def test_served_launches_stamped_under_a_profiler(device):
    """While a profiler session runs, the served decoder-loop and
    sample-loop launches stamp block 0's clock into buffers the recorder
    keeps; the waveforms are the unstamped launches' bit for bit, and
    the stamps reduce to per-step times whose parts sum to the step."""
    from msa_tts_tpu_torch.utils.profiling import RECORDER

    tts = _vocoding_tts(device)
    emb = torch.zeros(8).numpy()

    def run():
        return tts.synthesize_batch(["hello", "hello world"], spk_emb=emb,
                                    vocoder="wavernn", seed=5)

    plain = run()
    RECORDER.clear()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        stamped = run()
    for a, b in zip(stamped, plain):
        assert (a == b).all()
    (k1,) = RECORDER.stamps("k1")
    (k3,) = RECORDER.stamps("k3")
    RECORDER.clear()
    assert k1.steps == 12 and 0 < k1.us["barriers"] < k1.us["step"]
    assert k1.us["step"] == pytest.approx(
        sum(k1.us[ph] for ph in CD.PHASES))
    assert k3.steps == 2750 + 2 * 550
    parts = [v for p in k3.us.values() for v in p.values()]
    assert all(v >= 0 for v in parts) and 0 < sum(parts) < 1e4


# ---------------------------------------------------------------------
# Few-shot adaptation on the card (serving.AdaptiveTTS.adapt) and the
# adapted voice through the decoder kernels
# ---------------------------------------------------------------------
# Tolerance: the card's adapted weights against the CPU's after two
# steps on the same clips and masks, float32 on both sides (TF32 off):
# cuDNN's LSTM and the convolutions sum in other orders than the CPU's.
# Read on an NVIDIA H100 80GB HBM3 (700 W): weights and statistics
# 2.4e-7, the query loss equal; held at 9e-7 and at 1e-6 relative (a few
# ulp of the loss, for another run's summation order).
ADAPT_ATOL = 9e-7
ADAPT_LOSS_RTOL = 1e-6


def _adapt_pair(device, tmp_path):
    """The same seeded tiny model adapted on the card and on the CPU from
    two clips with the same dropout masks."""
    import numpy as np

    from msa_tts_tpu_torch.models.tacotron2nv import dropout_masks
    from msa_tts_tpu_torch.ops.audio import save_wav

    params = {"n_inner_test": 2,
              "criterion": {"reduction": "none", "pos_weight": 6.0}}
    card, cpu = _tiny_tts(device, **params), _tiny_tts("cpu", **params)
    wavs = []
    for i, n in enumerate((6000, 9000)):
        t = np.arange(n) / 22050
        wavs.append(str(tmp_path / f"clip{i}.wav"))
        save_wav(wavs[-1], 0.5 * np.sin(2 * np.pi * (150 + 70 * i) * t)
                 + 0.05 * np.random.default_rng(i).standard_normal(n),
                 22050)
    phones = [cpu.g2p.text_to_phone(t) for t in ("hello", "good morning")]
    emb = np.zeros(8, np.float32)
    b = cpu.adapt_batch(wavs, phones, emb)
    g = torch.Generator().manual_seed(0)
    masks = [dropout_masks(cpu.cfg, *b["inputs"].shape,
                           b["melspecs"].shape[-1], g, device="cpu")
             for _ in range(3)]
    return (card, card.adapt(wavs, phones, emb, masks=masks),
            cpu.adapt(wavs, phones, emb, masks=masks))


def test_adapt_on_the_card_matches_cpu(device, tmp_path):
    card, v, ref = _adapt_pair(device, tmp_path)
    worst = 0.0
    for k, t in v.state_dict.items():
        assert t.device.type == "cuda" and t.dtype == ref.state_dict[k].dtype
        assert torch.isfinite(t.float()).all(), k
        worst = max(worst, float((t.cpu().float()
                                  - ref.state_dict[k].float()).abs().max()))
    assert worst <= ADAPT_ATOL
    assert (abs(v.support_loss - ref.support_loss)
            <= ADAPT_LOSS_RTOL * ref.support_loss)


def test_adapted_voice_through_the_decoder_kernels(device, tmp_path):
    """The card's adapted voice: synthesize launches the whole-loop
    kernel once and gives the plain decode's mel; a stream launches the
    segment kernel once per segment and gives the offline mel."""
    import numpy as np

    card, v, _ = _adapt_pair(device, tmp_path)
    plain = _tiny_tts(device, decode_backend="torch")
    before = CD.LAUNCHES
    mel = card.synthesize("hello world", v, vocoder="none", seed=2)
    assert CD.LAUNCHES == before + 1
    ref = plain.synthesize("hello world", v, vocoder="none", seed=2)
    assert mel.shape == ref.shape
    assert np.abs(mel - ref).max() <= 1e-4
    before = CD.SEG_LAUNCHES
    streamed = np.concatenate(list(card.synthesize_stream(
        "hello world", v, vocoder="none", seed=2, segment_steps=5)), -1)
    assert CD.SEG_LAUNCHES == before + 5           # ceil(24 / 5)
    assert streamed.shape == mel.shape
    assert np.abs(streamed - mel).max() <= 1e-4


# ---------------------------------------------------------------------
# MAML meta-steps on the card (meta/maml.py make_maml_step)
# ---------------------------------------------------------------------
# Second order on the card runs the encoder's BiLSTM as a masked scan of
# plain tensor ops (ops/rnn.py twice_differentiable): cuDNN's RNN
# backward cannot be differentiated again.  The tiny model's meta-step,
# card against CPU, float32 (TF32 off), 2 tasks x 2 shots, 2 inner SGD
# steps, an outer SGD step of lr 1 (the new weights carry the meta-
# gradient itself).  Limits set from the readings on an NVIDIA H100 80GB
# HBM3 (700 W), no looser than 4x the larger of the two orders': new
# weights 6.3e-7 / 5.1e-7 absolute (the step moved them by up to 0.68),
# statistics 3.5e-7 / 3.0e-7 relative to each tensor's largest value,
# the loss 1.2e-7 / 0 and the gradient norm 1.9e-7 / 0 relative.
MAML_CUDA_TOL = {"weights": 2.5e-6, "statistics": 1.3e-6, "loss": 4.9e-7,
                 "grad_norm": 7.6e-7}


def _meta_model(width: str):
    from msa_tts_tpu_torch.models.tacotron2nv import (
        Tacotron2NV,
        config_from_params,
    )
    from msa_tts_tpu_torch.serving import N_SYMBOLS

    if width == "tiny":
        mp = _tiny_tts("cpu").params["model"]
        mp = dict(mp, decoder_no_early_stopping=False, mask_padding=True)
    else:
        from chip_smoke import SHIPPED_AUDIO, SHIPPED_MODEL

        mp = dict(SHIPPED_MODEL, n_symbols=N_SYMBOLS, num_speakers=1,
                  n_mel_channels=SHIPPED_AUDIO["n_mels"])
    cfg = config_from_params(mp)
    return cfg, Tacotron2NV(cfg, generator=torch.Generator().manual_seed(3))


def _meta_episode(cfg, K, B, T_in, T_mel, seed):
    """K tasks of B padded utterances with ragged lengths, on the CPU."""
    g = torch.Generator().manual_seed(seed)
    il = torch.tensor([[T_in - 2 * b - k for b in range(B)]
                       for k in range(K)])
    ml = torch.tensor([[T_mel - 3 * b - 2 * k for b in range(B)]
                       for k in range(K)])
    inputs = torch.randint(1, 50, (K, B, T_in), generator=g)
    mels = torch.randn(K, B, cfg.n_mel_channels, T_mel, generator=g)
    t = torch.arange(T_mel)
    inputs = inputs * (torch.arange(T_in) < il[..., None])
    mels = mels * (t < ml[..., None])[:, :, None, :]
    stop = (t >= ml[..., None] - 1).float()
    spk = torch.randn(K, 1, cfg.speaker_embedding_dim,
                      generator=g).expand(K, B, -1).contiguous()
    return dict(inputs=inputs, input_lengths=il, melspecs=mels,
                melspec_lengths=ml, speaker_vecs=spk, stop_labels=stop)


def _meta_step(model, cfg, device, second_order, episode, masks, n_inner):
    from msa_tts_tpu_torch import optim as TO
    from msa_tts_tpu_torch.meta.maml import make_maml_step
    from msa_tts_tpu_torch.models.loss import tacotron2_loss

    with torch.device("meta"):
        template = type(model)(cfg)

    def loss_fn(p, ms, b, m):
        outs, new_ms = torch.func.functional_call(
            template, {**p, **ms}, (b["inputs"], b["input_lengths"],
                                    b["melspecs"], b["melspec_lengths"],
                                    b["speaker_vecs"], m))
        return (tacotron2_loss(outs, (b["melspecs"], b["stop_labels"]),
                               b["melspec_lengths"], n_frames_per_step=2,
                               pos_weight=6.0), {**ms, **new_ms})

    def to(x):
        if isinstance(x, dict):
            return {k: to(v) for k, v in x.items()}
        if isinstance(x, list):
            return [to(v) for v in x]
        return x.to(device)

    names = [k for k, _ in model.named_parameters()]
    sd = model.state_dict()
    params = {k: sd[k].to(device) for k in names}
    state = {k: v.to(device) for k, v in sd.items() if k not in params}
    outer = TO.make_optimizer({"optimizer_type": "SGD", "lr": 1.0})
    step = make_maml_step(loss_fn, TO.make_optimizer(
        {"optimizer_type": "SGD", "lr": 1e-2}), outer, n_inner,
        second_order=second_order, clip_thresh=None)
    return params, step(TO.TrainState(params, state, outer.init(params), 0),
                        to(episode[0]), to(episode[1]), to(masks))


@pytest.mark.parametrize("second_order", [True, False],
                         ids=["second_order", "first_order"])
def test_meta_step_on_the_card_matches_cpu(device, second_order):
    from msa_tts_tpu_torch.models.tacotron2nv import dropout_masks

    cfg, model = _meta_model("tiny")
    K, B, T_in, T_mel, n_inner = 2, 2, 9, 12, 2
    ep = (_meta_episode(cfg, K, B, T_in, T_mel, 0),
          _meta_episode(cfg, K, B, T_in, T_mel, 1))
    g = torch.Generator().manual_seed(4)
    masks = [[dropout_masks(cfg, B, T_in, T_mel, g, device="cpu")
              for _ in range(n_inner + 1)] for _ in range(K)]
    _, (card, mc) = _meta_step(model, cfg, device, second_order, ep, masks,
                               n_inner)
    p0, (ref, mr) = _meta_step(model, cfg, "cpu", second_order, ep, masks,
                               n_inner)
    read = {
        "weights": max(float((card.params[k].cpu() - v).abs().max())
                       for k, v in ref.params.items()),
        "statistics": max(float((card.model_state[k].cpu() - v).abs().max()
                                / v.abs().max())
                          for k, v in ref.model_state.items()
                          if "running" in k),
        "loss": abs(float(mc.loss) - float(mr.loss)) / float(mr.loss),
        "grad_norm": (abs(float(mc.grad_norm) - float(mr.grad_norm))
                      / float(mr.grad_norm)),
    }
    moved = max(float((v - p0[k]).abs().max()) for k, v in ref.params.items())
    print(f"meta-step card vs CPU ({'second' if second_order else 'first'}"
          f" order): {read}; the step moved weights by up to {moved:.3e}")
    assert moved > 1e-2
    for key, lim in MAML_CUDA_TOL.items():
        assert lim is None or read[key] <= lim, (key, read[key], lim)


def test_second_order_meta_step_repeats_bit_for_bit(device):
    """With ``utils.determinism.make_reproducible`` (what the trainers set
    when they start on the card), a second-order meta-step at shapes this
    process has not differentiated before gives the bits of the same step
    repeated.  Before the repair it did not: the autograd engine ran the
    double backward on its worker thread and ordered it by that thread's
    node counter, so a process's first step at a shape summed in another
    order than its later ones."""
    from msa_tts_tpu_torch.models.tacotron2nv import dropout_masks
    from msa_tts_tpu_torch.utils.determinism import make_reproducible

    make_reproducible(device)
    cfg, model = _meta_model("tiny")
    K, B, T_in, T_mel = 2, 3, 11, 14
    ep = (_meta_episode(cfg, K, B, T_in, T_mel, 0),
          _meta_episode(cfg, K, B, T_in, T_mel, 1))
    g = torch.Generator().manual_seed(4)
    masks = [[dropout_masks(cfg, B, T_in, T_mel, g, device="cpu")
              for _ in range(3)] for _ in range(K)]
    (a, ma), *rest = [_meta_step(model, cfg, device, True, ep, masks, 2)[1]
                      for _ in range(3)]
    for b, mb in rest:
        assert torch.equal(mb.loss, ma.loss)
        assert torch.equal(mb.grad_norm, ma.grad_norm)
        for k, v in a.params.items():
            assert torch.equal(b.params[k], v), k
        for k, v in a.model_state.items():
            assert torch.equal(b.model_state[k], v), k


def test_meta_step_at_the_shipped_width(device):
    """One second-order meta-step at the width of examples/maml/params.yml
    (2 tasks x 2 shots, T_in 32, T_mel 64, one inner step): it runs on the
    card (cuDNN's RNN is not in its double backward), every new weight is
    finite, the step moved them and the batch-norm statistics."""
    from msa_tts_tpu_torch.models.tacotron2nv import dropout_masks

    cfg, model = _meta_model("shipped")
    K, B, T_in, T_mel = 2, 2, 32, 64
    ep = (_meta_episode(cfg, K, B, T_in, T_mel, 0),
          _meta_episode(cfg, K, B, T_in, T_mel, 1))
    g = torch.Generator(device=device).manual_seed(4)
    masks = [[dropout_masks(cfg, B, T_in, T_mel, g, device=device)
              for _ in range(2)] for _ in range(K)]
    torch.cuda.reset_peak_memory_stats(device)
    p0, (new, m) = _meta_step(model, cfg, device, True, ep, masks, 1)
    print(f"shipped-width meta-step: loss {float(m.loss):.4f}, grad norm "
          f"{float(m.grad_norm):.4f}, peak "
          f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB")
    assert torch.isfinite(m.loss) and torch.isfinite(m.grad_norm)
    assert all(torch.isfinite(v).all() for v in new.params.values())
    assert max(float((v - p0[k]).abs().max())
               for k, v in new.params.items()) > 1e-3
    assert not torch.equal(
        new.model_state["postnet.convolutions.0.1.running_mean"],
        model.state_dict()["postnet.convolutions.0.1.running_mean"].to(
            device))


# ---------------------------------------------------------------------
# Joint, Reptile and continual training steps on the card
# ---------------------------------------------------------------------
# The tiny model's trainers on a synthetic corpus, card against CPU on
# one float32 step (TF32 off) from the same init, batch and masks, the
# step SGD of lr 1 (the new weights carry the clipped gradient); and with
# compute_dtype bfloat16 the same step taken twice from one state on the
# card, equal bit for bit (TrainerBase makes the card's steps
# reproducible, utils/determinism.py).  Limits 4x the largest reading of
# the three trainers (joint / Reptile / EWC) on an NVIDIA H100 80GB HBM3
# (700 W): new weights 1.3e-7 / 6.5e-8 / 3.6e-7 absolute (the steps moved
# them by up to 0.21 / 3.9e-2 / 0.58), statistics 4.0e-7 / 1.6e-6 /
# 7.4e-7 relative to each tensor's largest value, gradient norm 6.2e-8 /
# 3.0e-7 / 0 relative; the loss read 0 in all three and is held to one
# float32 ulp.
TRAIN_CUDA_TOL = {"weights": 1.4e-6, "statistics": 6.3e-6, "loss": 1.2e-7,
                  "grad_norm": 1.2e-6}
TINY_TRAIN_AUDIO = dict(n_fft=1024, win_length=1024, hop_length=256,
                        n_mels=10, sample_rate=22050, f_min=0.0,
                        f_max=8000.0, griffinlim_iters=4)


def _train_params(tmp_path, method, **over):
    from msa_tts_tpu_torch.dataloaders.synthetic import (
        make_synthetic_corpus,
        synthetic_params,
    )

    root = str(tmp_path / "corpus")
    if not os.path.exists(root):
        make_synthetic_corpus(root, n_speakers=3, utterances_per_speaker=5,
                              min_dur=0.25, max_dur=0.4, spk_emb_dim=8,
                              seed=4)
    mp = dict(_tiny_tts("cpu").params["model"],
              decoder_no_early_stopping=False, mask_padding=True)
    p = synthetic_params(root, n_speakers=3, batch_size=2,
                         model_overrides=mp)
    p.update(method=method, experiment_name="tiny",
             output_path=str(tmp_path / "out"),
             audio_params=dict(TINY_TRAIN_AUDIO), use_tensorboard=False,
             plot_examples=False, speaker_seed=11, buffer_sample_size=2,
             buffer_batch_size=2, ewc_importance=1000.0, meta_batch_size=2,
             n_inner_train=2, optim={"optimizer_type": "SGD", "lr": 1.0},
             optim_outer={"optimizer_type": "SGD", "lr": 1.0})
    p.update(over)
    return p


def _on(x, device):
    if isinstance(x, dict):
        return {k: _on(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_on(v, device) for v in x)
    return x.to(device) if hasattr(x, "to") else x


def _step_inputs(kind, trainer):
    """One step's inputs on the CPU: ``(batch, masks)``; for Reptile the
    stacked support and query sets and the tasks' masks."""
    from msa_tts_tpu_torch.dataloaders.loader_meta import unpack_task_batch
    from msa_tts_tpu_torch.models.tacotron2nv import dropout_masks

    g = torch.Generator().manual_seed(5)
    if kind == "reptile":
        _, sup, qry = next(trainer.dataloader_metatrain.iter_stacked())
        sup = unpack_task_batch(sup, trainer.speaker_emb_type, "cpu")
        qry = unpack_task_batch(qry, trainer.speaker_emb_type, "cpu")
        K, B, T_in = sup["inputs"].shape
        masks = [[dropout_masks(trainer.cfg, B, T_in,
                                sup["melspecs"].shape[-1], g, device="cpu")
                  for _ in range(trainer.n_inner_train + 1)]
                 for _ in range(K)]
        return (sup, qry), masks
    if kind == "joint":
        b = next(iter(trainer.dataloader_train))
    else:
        spk = trainer.all_speakers[1]
        b = next(iter(trainer._make_loader(
            trainer._task_items([spk], "train"), seed=1)))
    batch = trainer._host_batch(b)
    B, T_in = batch["inputs"].shape
    return (batch,), dropout_masks(trainer.cfg, B, T_in,
                                   batch["melspecs"].shape[-1], g,
                                   device="cpu")


def _trainer(kind, tmp_path, device, **over):
    from msa_tts_tpu_torch.models.tacotron2nv import dropout_masks

    if kind == "joint":
        from msa_tts_tpu_torch.trainers.baseline import JointTrainer as base
    elif kind == "reptile":
        from msa_tts_tpu_torch.trainers.reptile import Reptile as base
    else:
        from msa_tts_tpu_torch.trainers.continual_ewc import EWCTrainer as base

    class cls(base):
        # the Fisher's masks drawn on the CPU, the same for both devices
        def _draw_step_masks(self, phase, key, batch):
            B, T_in = batch["inputs"].shape
            g = torch.Generator().manual_seed(
                self._mask_generator(phase, *key).initial_seed())
            return _on(dropout_masks(self.cfg, B, T_in,
                                     batch["melspecs"].shape[-1], g,
                                     device="cpu"), self.device)

    t = cls(**_train_params(tmp_path, kind, device=str(device),
                            output_path=str(tmp_path / f"out_{device}"),
                            **over))
    if kind == "continual":
        # the Fisher of a buffer of two tasks: the penalised step
        t.speakers_so_far = []
        for i, spk in enumerate(t.all_speakers[:2]):
            t.speakers_so_far.append(spk)
            t._reset_optimizer(spk)
            t._task_train_items(spk, i)
        g = torch.Generator().manual_seed(13)
        with torch.no_grad():
            t.train_state = t.train_state._replace(params={
                k: v + 1e-2 * torch.randn(v.shape, generator=g).to(v.device)
                for k, v in t.train_state.params.items()})
    return t


def _take(kind, trainer, inputs, masks):
    dev = trainer.device
    args, masks = _on(inputs, dev), _on(masks, dev)
    if kind == "reptile":
        state, m = trainer._reptile_step(trainer.train_state, *args, masks)
        return state, {"loss": m.loss, "grad_norm": m.grad_norm}
    step = trainer._task_step if kind == "continual" else trainer._train_step
    state, m, _ = step(trainer.train_state, args[0], masks)
    return state, m


@pytest.mark.parametrize("kind", ["joint", "reptile", "continual"])
def test_train_step_on_the_card_matches_cpu(device, tmp_path, kind):
    """``-k joint`` / ``-k reptile`` / ``-k continual``: one float32 step
    (the joint trainer's; a sequential Reptile meta-step; EWC's penalised
    step) on the card and on the CPU."""
    card = _trainer(kind, tmp_path, device)
    cpu = _trainer(kind, tmp_path, "cpu")
    inputs, masks = _step_inputs(kind, cpu)
    p0 = cpu.train_state.params
    (sc, mc), (sr, mr) = (_take(kind, card, inputs, masks),
                          _take(kind, cpu, inputs, masks))
    read = {
        "weights": max(float((sc.params[k].cpu() - v).abs().max())
                       for k, v in sr.params.items()),
        "statistics": max(float((sc.model_state[k].cpu() - v).abs().max()
                                / v.abs().max())
                          for k, v in sr.model_state.items()
                          if "running" in k),
        "loss": abs(float(mc["loss"]) - float(mr["loss"]))
        / float(mr["loss"]),
        "grad_norm": (abs(float(mc["grad_norm"]) - float(mr["grad_norm"]))
                      / float(mr["grad_norm"])),
    }
    moved = max(float((v - p0[k]).abs().max()) for k, v in sr.params.items())
    print(f"{kind} step card vs CPU: {read}; moved up to {moved:.3e}")
    assert moved > 1e-3
    for key, lim in TRAIN_CUDA_TOL.items():
        assert read[key] <= lim, (key, read[key], lim)


@pytest.mark.parametrize("kind", ["joint", "reptile", "continual"])
def test_bf16_train_step_repeats_bit_for_bit(device, tmp_path, kind):
    """``compute_dtype: bfloat16`` on the card: the same step from the
    same state twice, and once more in a second trainer, gives the same
    weights, statistics and loss, bit for bit."""
    outs = []
    for i in range(2):
        t = _trainer(kind, tmp_path / str(i), device,
                     compute_dtype="bfloat16")
        inputs, masks = _step_inputs(kind, t)
        outs += [_take(kind, t, inputs, masks) for _ in range(2 - i)]
    (a, ma) = outs[0]
    for b, mb in outs[1:]:
        assert float(mb["loss"]) == float(ma["loss"])
        for k, v in a.params.items():
            assert torch.equal(b.params[k], v), k
        for k, v in a.model_state.items():
            assert torch.equal(b.model_state[k], v), k


def test_joint_prefetch_on_the_card(device):
    """``prefetch_to_device`` onto the card: every batch, in order, on the
    device, equal to the host's; the copy waits on no one else's stream."""
    import numpy as np

    from msa_tts_tpu_torch.dataloaders.prefetch import prefetch_to_device

    rng = np.random.default_rng(0)
    host = [{"x": rng.standard_normal((64, 80, 400)).astype(np.float32),
             "i": rng.integers(0, 9, (64, 50)).astype(np.int32)}
            for _ in range(6)]
    got = list(prefetch_to_device(iter(host), size=2, device=device))
    assert len(got) == len(host)
    for g, h in zip(got, host):
        assert g["x"].device.type == "cuda" and g["i"].dtype == torch.int64
        # read on the compute stream right away: the copy has landed
        assert torch.equal(g["x"].cpu(), torch.from_numpy(h["x"]))
        assert torch.equal(g["i"].cpu(), torch.from_numpy(h["i"]).long())


# ---------------------------------------------------------------------
# The vocoder trainers on the card (trainers/{wavernn,hifigan}_train.py)
# ---------------------------------------------------------------------
# One float32 step (TF32 off) on the card and on the CPU from the same
# initial weights (drawn on the CPU; the HiFi-GAN generator's scaled by 20:
# the recipe's N(0, 0.01) leaves the tiny generator's output at 1e-5 and
# its gradients at 1e-11 to 1e-7, where Adam's first step turns rounding
# into steps of lr) and batch: the loss (each of HiFi-GAN's three) within
# 1e-5 relative; Adam's moments after it (mu: the gradient; the square
# root of nu: its magnitude) as the relative L2 norm of the difference
# over an optimizer's tensors, within 4x the readings of a first run
# (NVIDIA H100 80GB HBM3, 700 W): WaveRNN 8.6e-7, HiFi-GAN's generator
# 1.2e-5 and discriminators 1.8e-4; WaveRNN also per tensor, within 1e-4
# of each tensor's largest |value| (read 6.0e-6).  HiFi-GAN's per-tensor
# bound is not held: a leaky ReLU whose input lies within rounding of 0
# takes the other slope on the other device, and the period-11
# discriminator's last layer sums a channel's weight gradient over 66
# positions here, so one such flip moves that tensor by a visible share
# (chip_smoke.py phase 14 forces the CPU's slopes on the card's step at
# full width, counts the flips and holds that step per tensor).  The same
# step twice on the card: bit for bit.
VOC_CUDA_TOL = {"loss": 1e-5, "wavernn_max": 1e-4,
                "l2": {"wavernn": [3.5e-6], "hifigan": [4.8e-5, 7.1e-4]}}
VOC_GEN_CFG = dict(rnn_dims=64, fc_dims=64, res_out_dims=32,
                   compute_dims=32, res_blocks=2, pad=2,
                   upsample_factors=(4, 8, 8))


def _voc_trainer(kind, tmp_path, device, **over):
    import numpy as np

    from msa_tts_tpu_torch.dataloaders.synthetic import (
        make_synthetic_corpus,
        synthetic_params,
    )
    from msa_tts_tpu_torch.trainers.hifigan_train import HiFiGANTrainer
    from msa_tts_tpu_torch.trainers.wavernn_train import WaveRNNTrainer

    root = str(tmp_path / "corpus")
    if not os.path.exists(root):
        make_synthetic_corpus(root, n_speakers=2, utterances_per_speaker=4,
                              min_dur=0.4, max_dur=0.6, seed=1)
    p = synthetic_params(root, n_speakers=2, batch_size=2)
    p.update(experiment_name="tiny", use_tensorboard=False,
             output_path=str(tmp_path / f"out_{device}"), device=str(device),
             tb_log_interval=1, print_interval=100,
             ckpt_save_step_interval=1000, batch_size=2)
    if kind == "wavernn":
        p.update(method="wavernn", seq_len=512, lr=1e-3,
                 audio_params=dict(p["audio_params"], n_mels=20),
                 **VOC_GEN_CFG)
        cls = WaveRNNTrainer
    else:
        p.update(method="hifigan", audio_processor="ap2", segment_size=2048,
                 audio_params={"n_fft": 1024, "hop_size": 256,
                               "win_size": 1024, "n_mels": 20,
                               "sample_rate": 22050, "fmin": 0.0,
                               "fmax": 8000.0},
                 hifigan=dict(resblock="1", upsample_rates=[8, 8, 4],
                              upsample_kernel_sizes=[16, 16, 8],
                              upsample_initial_channel=32,
                              resblock_kernel_sizes=[3, 5],
                              resblock_dilation_sizes=[[1, 3], [1, 2]]))
        cls = HiFiGANTrainer
    p.update(over)
    t = cls(**p)
    if kind == "hifigan":
        t.gen_params = {k: 20.0 * v for k, v in t.gen_params.items()}
    batch = t._sample_batch(np.random.default_rng(3), 2)
    return t, [x.to(t.device) for x in batch]


def _voc_step(kind, t, batch):
    if kind == "wavernn":
        params, opt, loss = t._step(t.model_params, t.opt_state, *batch)
        return {"nll": loss}, [opt], params
    gp, dp, og, od, m = t._step(t.gen_params, t.disc_params, t.opt_g,
                                t.opt_d, *batch)
    return m, [og, od], {**gp, **dp}


@pytest.mark.parametrize("kind", ["wavernn", "hifigan"])
def test_vocoder_train_step_on_the_card_matches_cpu(device, tmp_path, kind):
    """``-k vocoder``: one float32 step of each vocoder trainer on the card
    against the CPU."""
    (card, cb), (cpu, hb) = (_voc_trainer(kind, tmp_path, device),
                             _voc_trainer(kind, tmp_path, "cpu"))
    for a, b in zip(cb, hb):
        assert torch.equal(a.cpu(), b)
    (mc, oc, _), (mr, orf, _) = (_voc_step(kind, card, cb),
                                 _voc_step(kind, cpu, hb))
    for k, v in mr.items():
        rel = abs(float(mc[k]) - float(v)) / abs(float(v))
        assert rel <= VOC_CUDA_TOL["loss"], (k, rel)
    for a, b, lim in zip(oc, orf, VOC_CUDA_TOL["l2"][kind]):
        for name, f in (("mu", lambda x: x), ("nu", torch.sqrt)):
            ref = {k: f(v) for k, v in b[0][name].items()}
            ours = {k: f(a[0][name][k].cpu()) for k in ref}
            l2 = (sum(float(((ours[k] - v) ** 2).sum()) for k, v in ref.items())
                  / sum(float((v ** 2).sum()) for v in ref.values())) ** 0.5
            top = max(float((ours[k] - v).abs().max())
                      / max(float(v.abs().max()), 1e-30)
                      for k, v in ref.items())
            print(f"{kind} step card vs CPU, {name}: L2 rel {l2:.3e}, of a "
                  f"tensor's largest {top:.3e}")
            assert l2 <= lim, (name, l2, lim)
            if kind == "wavernn":
                assert top <= VOC_CUDA_TOL["wavernn_max"], (name, top)


@pytest.mark.parametrize("kind", ["wavernn", "hifigan"])
def test_vocoder_train_step_repeats_bit_for_bit(device, tmp_path, kind):
    """The same step from the same state twice on the card: the losses,
    the new weights and the optimizer states, bit for bit."""
    t, batch = _voc_trainer(kind, tmp_path, device)
    (ma, oa, pa), (mb, ob, pb) = (_voc_step(kind, t, batch)
                                  for _ in range(2))
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    for k, v in pa.items():
        assert torch.equal(v, pb[k]), k
    for a, b in zip(oa, ob):
        for name in ("mu", "nu"):
            for k, v in a[0][name].items():
                assert torch.equal(v, b[0][name][k]), (name, k)


def test_gen_kernel_on_a_trained_wavernn(device, tmp_path):
    """K3 on weights the WaveRNN trainer trained on the card (4 steps):
    the fold rows of a corpus mel through twins with ``gen_backend`` cuda
    and torch, the same noise: f32 within 1e-5 over 37 steps, bf16 at
    most 5e-3 of the samples beyond 1e-3 (a bf16 rounding may flip the
    mixture's choice)."""
    from msa_tts_tpu_torch.vocoders import cuda_gen as G
    from msa_tts_tpu_torch.vocoders.wavernn import (
        WaveRNN,
        WaveRNNModel,
        _fold_counts,
        generation_noise,
    )

    t, _ = _voc_trainer("wavernn", tmp_path, device, n_steps=4)
    t.run()
    model = WaveRNNModel(t.cfg)
    model.load_state_dict({**t.model_params, **t.model_state}, strict=True)
    mel = torch.from_numpy(t.dataset.items[0].mel[:, :20].copy())
    target, overlap = 300, 50
    for gen_dtype in ("float32", "bfloat16"):
        kern_v, plain_v = (WaveRNN(model, t.cfg, gen_dtype=gen_dtype,
                                   gen_backend=b, device=device)
                           for b in ("cuda", "torch"))
        padded, T = kern_v._pad_batch([mel.to(device)])
        _, n_pad = _fold_counts(T * t.cfg.hop_length, target, overlap)
        noise = generation_noise(t.cfg, torch.Generator().manual_seed(2),
                                 target + 2 * overlap, n_pad, device=device)
        before = G.GEN_LAUNCHES
        kern, _ = kern_v._run_folded(padded, target, overlap, [noise])
        assert G.GEN_LAUNCHES == before + 1
        plain, _ = plain_v._run_folded(padded, target, overlap, [noise])
        assert G.GEN_LAUNCHES == before + 1
        d = (kern - plain).abs()
        assert torch.isfinite(kern).all() and kern.shape[1] == n_pad >= 4
        if gen_dtype == "float32":
            assert float(d[..., :37].max()) <= 1e-5
        else:
            assert float((d > 1e-3).float().mean()) <= 5e-3
