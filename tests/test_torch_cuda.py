"""The CUDA decoder kernel (msa_tts_tpu_torch/csrc/decoder_loop.cu)
against its plain PyTorch version on the GPU, for every attention
config it lowers and for ragged shapes (B = 1 and B past one staged
chunk, T_in shorter than the location kernel, F wider than a warp).

Also the model's decode routing on CUDA tensors: ``auto`` and ``cuda``
launch the kernel for a config it lowers and raise for one it does not;
only ``torch`` runs the plain loop on the card.  And the opt-in phase
clock stamps.

These tests need a CUDA device and nvcc; elsewhere they skip.  On the GPU
host (no jax there, so without the JAX-side conftest):

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts="" -m cuda -q

Tolerance: f32 on both sides with different summation orders, over 17
autoregressive steps: 1e-5; mel_lengths and n_steps exact.
"""

import pytest
import torch

from msa_tts_tpu_torch.models import cuda_decoder as CD
from msa_tts_tpu_torch.models.decoder import Decoder, DecoderConfig, decoder_infer

pytestmark = pytest.mark.cuda

ATOL = 1e-5
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


def _compare(cfg, device, B, T_in, seed=0):
    g = torch.Generator().manual_seed(seed)
    dec = Decoder(cfg, generator=g).to(device)
    enc = torch.randn(B, T_in, cfg.encoder_embedding_dim, generator=g)
    lens = torch.randint(1, T_in + 1, (B,), generator=g)
    lens[0] = T_in
    enc, lens = enc.to(device), lens.to(device)
    masks = CD.prenet_masks(cfg, cfg.max_decoder_steps, B, g, device=device)
    ref = decoder_infer(dec, cfg, enc, lens, masks)
    before = CD.LAUNCHES
    out = CD.cuda_decoder_infer(dec, cfg, enc, lens, masks)
    torch.cuda.synchronize()
    assert CD.LAUNCHES == before + 1
    for name, a, b in zip(("mels", "gates", "aligns"), out[:3], ref[:3]):
        assert a.shape == b.shape, name
        err = float((a - b).abs().max())
        assert err <= ATOL, (name, err)
    assert out[3].tolist() == ref[3].tolist()
    assert int(out[4]) == int(ref[4])


@pytest.mark.parametrize("ap", [
    {}, {"norm": "sigmoid"}, {"trans_agent": False},
    {"forward_attn": False}, {"location_attention": False},
    {"mask_energies": True}, {"attention_type": "LSA"},
], ids=str)
@pytest.mark.parametrize("B", [1, 3, 9])
def test_kernel_matches_plain(device, ap, B):
    _compare(_cfg(ap), device, B, T_in=11)


@pytest.mark.parametrize("shape", [
    dict(T_in=5),                                    # T_in < K
    dict(T_in=37, ap={"attention_location_n_filters": 40,
                      "attention_dim": 48}),         # F > 32 lanes
    dict(T_in=11, over={"p_prenet_dropout": 0.3,
                        "early_stopping": False}),   # non-dyadic keep
    dict(T_in=11, over={"n_frames_per_step": 1, "prenet_dim": 33}),
])
def test_kernel_ragged_shapes(device, shape):
    cfg = _cfg(shape.get("ap"), **shape.get("over", {}))
    _compare(cfg, device, 3, shape["T_in"])


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


def _segment_setup(cfg, device, B, T_in, n_steps, seed=0):
    g = torch.Generator().manual_seed(seed)
    dec = Decoder(cfg, generator=g).to(device)
    enc = torch.randn(B, T_in, cfg.encoder_embedding_dim, generator=g)
    lens = torch.randint(1, T_in + 1, (B,), generator=g)
    lens[0] = T_in
    enc, lens = enc.to(device), lens.to(device)
    masks = CD.prenet_masks(cfg, n_steps, B, g, device=device)
    return dec, enc, lens, masks


def _compare_segment(cfg, device, B, T_in, n_pre=4, n_seg=5):
    """One n_seg-step segment from the plain state after n_pre steps:
    kernel and plain outputs and every state field within ATOL
    (``u`` included), flags and lengths exact, one launch."""
    from msa_tts_tpu_torch.models.decoder import (
        decoder_infer_segment,
        decoder_stream_init,
    )

    dec, enc, lens, masks = _segment_setup(cfg, device, B, T_in,
                                           n_pre + n_seg)
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
        assert err <= ATOL, (name, err)
    ours, theirs = _flat(out[0]), _flat(ref[0])
    for name in ours:
        assert ours[name].shape == theirs[name].shape, name
        err = float((ours[name] - theirs[name]).abs().max())
        assert err <= ATOL, (name, err)
    for name in ("not_finished", "mel_lengths", "step"):
        assert torch.equal(out[0][name], ref[0][name]), name


@pytest.mark.parametrize("ap", [
    {}, {"norm": "sigmoid"}, {"trans_agent": False},
    {"forward_attn": False}, {"location_attention": False},
    {"mask_energies": True}, {"attention_type": "LSA"},
], ids=str)
@pytest.mark.parametrize("B", [1, 3, 9])
def test_segment_kernel_matches_plain(device, ap, B):
    _compare_segment(_cfg(ap), device, B, T_in=11)


@pytest.mark.parametrize("shape", [
    dict(T_in=5),                                    # T_in < K
    dict(T_in=37, ap={"attention_location_n_filters": 40,
                      "attention_dim": 48}),         # F > 32 lanes
    dict(T_in=11, over={"p_prenet_dropout": 0.3}),   # non-dyadic keep
    dict(T_in=11, over={"n_frames_per_step": 1, "prenet_dim": 33}),
])
def test_segment_kernel_ragged_shapes(device, shape):
    cfg = _cfg(shape.get("ap"), **shape.get("over", {}))
    _compare_segment(cfg, device, 3, shape["T_in"])


def test_segment_state_after_first_segment(device):
    """From a fresh stream state the first segment's state, the
    transition agent ``u`` included, matches the plain one: the kernel
    skips the deferred agent at its first step and computes the last
    step's in its tail."""
    _compare_segment(_cfg(early_stopping=False), device, 2, T_in=11,
                     n_pre=0, n_seg=6)


@pytest.mark.parametrize("n_seg", [4, 6])
def test_segment_chain_equals_whole_loop_kernel(device, n_seg):
    """Chained segments give the whole-loop kernel's bits: the same step
    function, and an agent that is never stale.  S = 20: 4 divides it,
    6 does not (the last segment overshoots)."""
    from msa_tts_tpu_torch.models.decoder import decoder_stream_init
    from msa_tts_tpu_torch.serving import _segment_masks

    cfg = _cfg(early_stopping=False, max_decoder_steps=20)
    S, r = cfg.max_decoder_steps, cfg.n_frames_per_step
    dec, enc, lens, masks = _segment_setup(cfg, device, 3, 11, S)
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


def test_segment_rows_independent_of_batch(device):
    """A row of a B = 3 segment equals the same row decoded alone: no
    phase sums in an order that depends on B or the grid."""
    from msa_tts_tpu_torch.models.decoder import decoder_stream_init

    cfg = _cfg(early_stopping=False)
    dec, enc, lens, masks = _segment_setup(cfg, device, 3, 11, 8)
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
