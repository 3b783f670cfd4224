"""The port's streaming path against its offline path and the JAX
package, on the same weights and noise:

- chained plain segments (``decoder_infer_segment``) equal the port's
  ``decoder_infer`` exactly (the same ops);
- one segment from a mid-stream state equals JAX's
  ``decoder_infer_segment`` and its Pallas segment kernel in interpret
  mode, every state field (``u`` included) within 2e-5, the
  not-finished flags and mel lengths exact;
- ``synthesize_stream(vocoder="none")`` gives JAX's offline mel within
  1e-4 and the port's own offline mel within 1e-5, with equal lengths;
- streamed Griffin-Lim chunks equal JAX's within 1e-4 × peak when both
  start every window from JAX's phase draw;
- with an attached HiFi-GAN or WaveRNN the streamed chunks equal JAX's
  (1e-3 and 5e-3: the windows' mels already differ by up to 1e-4, and
  WaveRNN feeds its samples back for 3,850 steps per fold) when WaveRNN
  takes JAX's per-window noise.

Tolerances: f32 on both sides, summed in other orders, carried through
up to 40 autoregressive steps."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msa_tts_tpu.models import config_from_params as jax_cfp
from msa_tts_tpu.models import init_tacotron2nv
from msa_tts_tpu.models.decoder import decoder_infer_segment as jax_segment
from msa_tts_tpu.models.decoder import decoder_stream_init as jax_stream_init
from msa_tts_tpu.models.pallas_decoder import (
    _prenet_masks,
    pallas_decoder_segment,
)
from msa_tts_tpu.serving import AdaptiveTTS as JaxTTS
from msa_tts_tpu_torch.models import cuda_decoder as CD
from msa_tts_tpu_torch.models.decoder import (
    Postnet,
    decoder_infer,
    decoder_infer_segment,
    decoder_stream_init,
    postnet_apply,
)
from msa_tts_tpu_torch.models.tacotron2nv import Tacotron2NV, config_from_params
from msa_tts_tpu_torch.serving import AdaptiveTTS
from msa_tts_tpu_torch.utils.convert import state_dict_from_jax
from torch_parity import (
    jax_and_port_models,
    jax_wavernn_noise,
    model_dict,
    randn,
    vocoder_pairs,
)

ATOL = 2e-5

# tests/test_streaming.py's tiny serving config
AP = dict(sample_rate=22050, n_fft=512, win_length=512, hop_length=128,
          f_min=0.0, f_max=8000.0, n_mels=20, griffinlim_iters=4)
MODEL = {
    "mask_padding": False, "n_mel_channels": 20, "n_frames_per_step": 2,
    "n_symbols": 200, "symbols_embedding_dim": 16,
    "encoder_n_convolutions": 2, "encoder_embedding_dim": 16,
    "encoder_kernel_size": 5, "speaker_emb_type": "static",
    "num_speakers": 1, "speaker_embedding_dim": 6,
    "speaker_embedding_dim_lin": 4, "attention_rnn_dim": 20,
    "decoder_rnn_dim": 20, "prenet_dim": 12, "max_decoder_steps": 40,
    "gate_threshold": 0.5, "p_attention_dropout": 0.1,
    "p_decoder_dropout": 0.1, "decoder_no_early_stopping": True,
    "postnet_embedding_dim": 16, "postnet_kernel_size": 5,
    "postnet_n_convolutions": 3,
    "attention_params": {
        "attention_type": "ForwardAttention", "attention_dim": 16,
        "attention_location_n_filters": 8,
        "attention_location_kernel_size": 15, "windowing": False,
        "norm": "softmax", "forward_attn": True, "trans_agent": True,
        "forward_attn_mask": False,
    },
}
EMB = np.linspace(-1, 1, 6).astype(np.float32)


# ------------------------------------------------------------ segments
def _chain(dec, dcfg, enc, lens, masks, n):
    """Chain n-step plain segments from a fresh state past the step cap;
    returns the concatenated outputs and the last state."""
    B, T, _ = enc.shape
    S = dcfg.max_decoder_steps
    st = decoder_stream_init(dcfg, B, T, device="cpu")
    outs = []
    for step in range(0, S, n):
        pm = masks[step: step + n]
        pm = torch.cat([pm, torch.ones((n - pm.shape[0],) + pm.shape[1:])])
        st, *o = decoder_infer_segment(dec, dcfg, enc, lens, pm, st, n)
        outs.append(o)
    return [torch.cat(x, dim=-2 if i == 2 else -1)
            for i, x in enumerate(zip(*outs))], st


@pytest.mark.parametrize("n_seg", [3, 7])
def test_segments_chain_to_decoder_infer(n_seg):
    """Chained segments run decoder_infer's ops: equal, bit for bit.
    S = 18: 3 divides it, 7 does not (the last segment overshoots)."""
    mp = model_dict(decoder_no_early_stopping=True, max_decoder_steps=18)
    _, (cfg, model) = jax_and_port_models(mp)
    dcfg = cfg.decoder_config()
    S, r = dcfg.max_decoder_steps, dcfg.n_frames_per_step
    enc = torch.from_numpy(randn(1, 3, 11, dcfg.encoder_embedding_dim))
    lens = torch.tensor([11, 7, 9])
    masks = CD.prenet_masks(dcfg, S, 3, torch.Generator().manual_seed(0),
                            device="cpu")
    ref = decoder_infer(model.decoder, dcfg, enc, lens, masks)
    (mels, gates, aligns), st = _chain(model.decoder, dcfg, enc, lens,
                                       masks, n_seg)
    assert torch.equal(mels[..., : S * r], ref[0])
    assert torch.equal(gates[:, :S].repeat_interleave(r, dim=1), ref[1])
    assert torch.equal(aligns[:, :S], ref[2])
    assert int(st["step"]) == -(-S // n_seg) * n_seg
    if S % n_seg == 0:
        assert torch.equal(st["mel_lengths"], ref[3])


def _to_torch_state(st) -> dict:
    from msa_tts_tpu_torch.models.attention import AttnState
    from msa_tts_tpu_torch.models.decoder import DecoderCarry

    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    c = st["carry"]
    return dict(
        step=t(st["step"]), decoder_input=t(st["decoder_input"]),
        carry=DecoderCarry(*(t(x) for x in c[:5]),
                           AttnState(*(t(x) for x in c.attn_state))),
        not_finished=t(st["not_finished"]).to(torch.int32),
        mel_lengths=t(st["mel_lengths"]).to(torch.int32),
    )


def _flat_state(st) -> dict:
    c = st["carry"]
    a = c.attn_state
    return dict(
        decoder_input=st["decoder_input"], ah=c.attention_hidden,
        ac=c.attention_cell, dh=c.decoder_hidden, dc=c.decoder_cell,
        ctx=c.attention_context, aw=a.attention_weights,
        cum=a.attention_weights_cum, alpha=a.alpha, u=a.u,
        not_finished=st["not_finished"], mel_lengths=st["mel_lengths"],
        step=st["step"],
    )


def _assert_segment(out, ref):
    (st, mels, gates, aligns), (jst, jmels, jgates, jaligns) = out, ref
    for name, a, b in (("mels", mels, jmels), ("gates", gates, jgates),
                       ("aligns", aligns, jaligns)):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, atol=ATOL, rtol=0,
                                   err_msg=name)
    ours, theirs = _flat_state(st), _flat_state(jst)
    for name in ours:
        a, b = ours[name].numpy(), np.asarray(theirs[name])
        if name in ("not_finished", "mel_lengths", "step"):
            np.testing.assert_array_equal(a, b.astype(a.dtype), name)
        else:
            np.testing.assert_allclose(a, b, atol=ATOL, rtol=0,
                                       err_msg=name)


VARIANTS = [
    {},
    {"ap": {"norm": "sigmoid"}},
    {"ap": {"trans_agent": False}},
    {"ap": {"forward_attn": False}},
    {"ap": {"location_attention": False}},
    {"ap": {"mask_energies": True}},
    {"ap": {"attention_type": "LSA"}},
    {"p_prenet_dropout": 0.3},
]
LENS = {1: [11], 3: [11, 7, 9]}


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("variant", VARIANTS, ids=lambda v: str(v))
def test_segment_from_mid_stream_matches_jax_and_pallas(variant, B):
    """One 5-step segment from the state JAX reaches after 4 steps: the
    port's plain segment equals JAX's scan and the Pallas segment kernel
    (interpret mode) in every output and state field."""
    (jcfg, params, _), (cfg, model) = jax_and_port_models(
        model_dict(**variant))
    jd, dcfg = jcfg.decoder_config(), cfg.decoder_config()
    p = params["decoder"]
    enc = randn(1, B, 11, dcfg.encoder_embedding_dim)
    lens = np.asarray(LENS[B], np.int32)
    rng = jax.random.PRNGKey(2)
    masks = np.array(_prenet_masks(jd, rng, 9, B))
    jenc, jlens = jnp.asarray(enc), jnp.asarray(lens)
    st4, *_ = jax_segment(p, jd, jenc, jlens, rng,
                          jax_stream_init(jd, B, 11, jnp.float32), 4)
    out = decoder_infer_segment(
        model.decoder, dcfg, torch.from_numpy(enc), torch.from_numpy(lens),
        torch.from_numpy(masks[4:9]), _to_torch_state(st4), 5,
    )
    _assert_segment(out, jax_segment(p, jd, jenc, jlens, rng, st4, 5))
    _assert_segment(out, pallas_decoder_segment(p, jd, jenc, jlens, rng,
                                                st4, 5, interpret=True))


def test_postnet_width_mask_exact():
    """postnet_apply(width=w) on a zero-padded buffer gives, in columns
    below w, exactly the postnet of the w-frame input."""
    pn = Postnet(20, 16, 5, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for conv_bn in pn.convolutions:         # non-trivial statistics
            conv_bn[1].running_mean.uniform_(-0.5, 0.5)
            conv_bn[1].running_var.uniform_(0.5, 2.0)
    x = torch.from_numpy(randn(1, 1, 20, 48))
    for w in (48, 37, 12, 5):
        ref = postnet_apply(pn, x[..., :w])
        buf = torch.nn.functional.pad(x[..., :w], (0, 48 - w))
        out = postnet_apply(pn, buf, width=w)
        assert torch.equal(out[..., :w], ref), w


# ------------------------------------------------------------ serving
def _tts_pair(audio=AP, **over):
    """JAX and port AdaptiveTTS on the same weights (JAX init, seed 3)."""
    mp = dict(MODEL, **over)
    params = {"model": mp, "audio_params": dict(audio)}
    p0, s0 = init_tacotron2nv(jax.random.PRNGKey(3), jax_cfp(dict(mp)))
    cfg = config_from_params(dict(mp))
    model = Tacotron2NV(cfg)
    model.load_state_dict(state_dict_from_jax(
        jax.device_get(p0), jax.device_get(s0), cfg), strict=True)
    return JaxTTS(params, p0, s0), AdaptiveTTS(params, model)


def _jax_masks(tts):
    dcfg = tts.cfg.decoder_config()
    key = jax.random.fold_in(jax.random.PRNGKey(0), 2)
    return np.array(_prenet_masks(dcfg, key, dcfg.max_decoder_steps, 1))


def _jax_phase(n_freqs, n_frames):
    """The start phase JAX's Griffin-Lim draws for every window."""
    return np.array(jax.random.uniform(
        jax.random.PRNGKey(0), (n_freqs, n_frames),
        minval=-math.pi, maxval=math.pi,
    ))


STREAM_CASES = {
    "no_early_stop": ({}, 7, 10),
    "early_stop": ({"decoder_no_early_stopping": False,
                    "gate_threshold": 0.45}, 5, 8),
    "gate_fires_at_step0": ({"decoder_no_early_stopping": False,
                             "gate_threshold": 0.1}, 5, 4),
    "zero_context_beyond_gate": ({"decoder_no_early_stopping": False,
                                  "gate_threshold": 0.45}, 3, 4),
    "gate_without_early_stop": ({"gate_threshold": 0.35}, 3, 4),
}


@pytest.mark.parametrize("case", list(STREAM_CASES))
def test_streamed_mel_matches_offline(case):
    """vocoder='none': the streamed mel has the offline length and equals
    JAX's offline mel within 1e-4 and the port's within 1e-5."""
    over, seg, chunk = STREAM_CASES[case]
    jtts, tts = _tts_pair(**over)
    masks = _jax_masks(tts)
    ref = np.asarray(jtts.synthesize("hello world", vocoder="none",
                                     spk_emb=EMB))
    own = tts.synthesize("hello world", vocoder="none", spk_emb=EMB,
                         pre_masks=masks)
    chunks = list(tts.synthesize_stream(
        "hello world", vocoder="none", spk_emb=EMB, segment_steps=seg,
        chunk_frames=chunk, pre_masks=masks,
    ))
    streamed = np.concatenate(chunks, axis=-1)
    if case == "gate_fires_at_step0":
        assert ref.shape[-1] == MODEL["n_frames_per_step"]
    elif case in ("no_early_stop", "early_stop"):
        assert len(chunks) > 1
    assert streamed.shape == ref.shape == own.shape
    np.testing.assert_allclose(streamed, ref, atol=1e-4, rtol=0)
    np.testing.assert_allclose(streamed, own, atol=1e-5, rtol=0)


def test_streamed_griffinlim_matches_jax():
    """Griffin-Lim streaming: the chunk lengths sum to the offline wav's,
    and every chunk equals JAX's within 1e-4 × peak when both start each
    window from JAX's PRNGKey(0) phase."""
    jtts, tts = _tts_pair()
    masks = _jax_masks(tts)
    kw = dict(vocoder="griffinlim", spk_emb=EMB, segment_steps=8,
              chunk_frames=12, vocode_ctx_frames=4)
    ref = [np.asarray(c) for c in jtts.synthesize_stream("hello world",
                                                         **kw)]
    out = list(tts.synthesize_stream("hello world", pre_masks=masks,
                                     gl_phase=_jax_phase, **kw))
    offline = tts.synthesize("hello world", spk_emb=EMB, pre_masks=masks)
    assert len(out) == len(ref) > 1
    assert sum(len(c) for c in out) == len(offline)
    peak = max(np.abs(c).max() for c in ref)
    for a, b in zip(out, ref):
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-4 * peak, rtol=0)


@pytest.mark.parametrize("vocoder", ["hifigan", "wavernn"])
def test_streamed_neural_vocoder_matches_jax(vocoder):
    jtts, tts = _tts_pair(max_decoder_steps=20)
    jv, tv = vocoder_pairs(AP["n_mels"], AP["hop_length"])[vocoder]
    jtts.attach_vocoder(vocoder, jv)
    tts.attach_vocoder(vocoder, tv)
    masks = _jax_masks(tts)
    kw = dict(vocoder=vocoder, spk_emb=EMB, segment_steps=8,
              chunk_frames=12, vocode_ctx_frames=4)
    ref = [np.asarray(c) for c in jtts.synthesize_stream("hello world",
                                                         **kw)]
    extra = {}
    if vocoder == "wavernn":
        # every 20-frame window pads to 32 frames and takes the noise of
        # the JAX stream's one key
        extra["voc_noise"] = jax_wavernn_noise(jv, jax.random.PRNGKey(0),
                                               1, 32)
    out = list(tts.synthesize_stream("hello world", pre_masks=masks,
                                     **extra, **kw))
    frames = MODEL["n_frames_per_step"] * 20
    total = (frames if vocoder == "hifigan" else frames - 1) * 128
    assert len(out) == len(ref) > 1
    assert sum(len(c) for c in out) == total
    atol = 1e-3 if vocoder == "hifigan" else 5e-3
    for a, b in zip(out, ref):
        assert a.dtype == np.float32 and a.shape == b.shape
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, atol=atol, rtol=0)


def test_ap2_params_stream_through_hifigan():
    """"ap2" (HiFi-GAN style) audio params name the hop ``hop_size``
    only: an attached HiFi-GAN streams with it, chunk for chunk as the
    JAX package streams (1e-3, as above)."""
    ap2 = dict(sample_rate=22050, n_fft=512, win_size=512, hop_size=128,
               fmin=0.0, fmax=8000.0, n_mels=AP["n_mels"])
    jtts, tts = _tts_pair(audio=ap2, max_decoder_steps=20)
    jv, tv = vocoder_pairs(AP["n_mels"], 128)["hifigan"]
    jtts.attach_vocoder("hifigan", jv)
    tts.attach_vocoder("hifigan", tv)
    kw = dict(vocoder="hifigan", spk_emb=EMB, segment_steps=8,
              chunk_frames=12, vocode_ctx_frames=4)
    ref = [np.asarray(c) for c in jtts.synthesize_stream("hello world",
                                                         **kw)]
    out = list(tts.synthesize_stream("hello world",
                                     pre_masks=_jax_masks(tts), **kw))
    assert len(out) == len(ref) > 1
    assert sum(len(c) for c in out) == MODEL["n_frames_per_step"] * 20 * 128
    for a, b in zip(out, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-3, rtol=0)


def test_stream_neural_vocoder_context_rules():
    """WaveRNN comes up one hop short per window, so it needs context;
    HiFi-GAN emits W·hop samples and streams with none.  An unattached
    vocoder raises before the first segment."""
    _, tts = _tts_pair(max_decoder_steps=8)
    with pytest.raises(ValueError, match="attach_vocoder"):
        next(tts.synthesize_stream("hello", vocoder="hifigan", spk_emb=EMB))
    for name, voc in vocoder_pairs(AP["n_mels"], AP["hop_length"]).items():
        tts.attach_vocoder(name, voc[1])
    with pytest.raises(ValueError, match="vocode_ctx_frames"):
        list(tts.synthesize_stream("hello", vocoder="wavernn",
                                   spk_emb=EMB, vocode_ctx_frames=0))
    chunks = list(tts.synthesize_stream(
        "hello", vocoder="hifigan", spk_emb=EMB, vocode_ctx_frames=0,
        chunk_frames=6, segment_steps=4))
    assert sum(len(c) for c in chunks) == 16 * 128
    off = tts.synthesize("hello", vocoder="hifigan", spk_emb=EMB)
    assert len(off) == 16 * 128


def test_stream_griffinlim_rejects_zero_context():
    _, tts = _tts_pair()
    with pytest.raises(ValueError, match="vocode_ctx_frames"):
        list(tts.synthesize_stream("hello", vocoder="griffinlim",
                                   spk_emb=EMB, vocode_ctx_frames=0))


def test_seeded_stream_is_deterministic():
    """Without injected noise a stream draws synthesize's masks for its
    seed: the streamed mel is the offline mel of that seed."""
    _, tts = _tts_pair()
    off = tts.synthesize("hello", vocoder="none", spk_emb=EMB, seed=5)
    streamed = np.concatenate(list(tts.synthesize_stream(
        "hello", vocoder="none", spk_emb=EMB, seed=5, segment_steps=6,
    )), axis=-1)
    np.testing.assert_allclose(streamed, off, atol=1e-5, rtol=0)


def test_cuda_decoder_segment_raises_on_cpu_tensors():
    """No fallback that hides the device: CPU tensors are refused before
    anything is built or launched."""
    _, (cfg, model) = jax_and_port_models(model_dict())
    dcfg = cfg.decoder_config()
    enc = torch.zeros(2, 5, dcfg.encoder_embedding_dim)
    pin, maskf = CD.segment_inputs(model.decoder, dcfg, enc,
                                   torch.tensor([5, 3]))
    st = decoder_stream_init(dcfg, 2, 5, device="cpu")
    masks = torch.ones(4, 2, 2, dcfg.prenet_dim)
    before = CD.SEG_LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        CD.cuda_decoder_segment(model.decoder, dcfg, enc, pin, maskf,
                                masks, st, 4)
    assert CD.SEG_LAUNCHES == before
