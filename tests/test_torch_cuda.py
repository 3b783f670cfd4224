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
clock stamps.

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
    # a width whose bf16 slices outgrow a block's shared memory
    wide = W.WaveRNNConfig(**dict(GEN_CFG, rnn_dims=1024, fc_dims=1024))
    model = W.WaveRNNModel(wide, torch.Generator().manual_seed(0)).to(device)
    with pytest.raises(ValueError, match="of resident weights"):
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
@pytest.mark.parametrize("B,H", [(16, 1024), (3, 64), (20, 256)])
def test_lstm_cell_kernel_matches_plain(device, dtype, atol, B, H):
    """One step, so the bf16 variant (same rounded h and weights on both
    sides, f32 sums in another order) holds the f32 tolerance."""
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


def test_serving_vocodes_through_the_gen_kernel(device):
    """``AdaptiveTTS`` with an attached WaveRNN and HiFi-GAN on the card:
    one sample-loop launch per vocoded request or batch, wav lengths
    (T-1)·hop and T·hop."""
    from msa_tts_tpu_torch.models.tacotron2nv import (
        Tacotron2NV,
        config_from_params,
    )
    from msa_tts_tpu_torch.serving import AdaptiveTTS
    from msa_tts_tpu_torch.vocoders import cuda_gen as G
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
