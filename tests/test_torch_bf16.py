"""``infer_dtype: bfloat16`` in the port: the plain decoder's bfloat16
roundings (msa_tts_tpu_torch/models/decoder.py) and the serving API
(msa_tts_tpu_torch/serving.py) on the CPU.

The decoder against the JAX package's Pallas whole-loop kernel in
interpret mode, on the same bfloat16-cast weights, encoder outputs and
prenet masks.  The port's plain loop claims that kernel's semantics
(every product's input rounded to bfloat16, float32 sums and state, the
LSTM biases summed at bfloat16), so the two differ by float32 summation
order only: mels, gates and alignments within 5e-6 over the first 8
steps (measured 3e-7; typical |value| 0.3 for mels and gates, 0.09 for
alignments; one missing rounding shows as 1e-3), and over the whole run
at most 2 % of the values beyond 1e-4 (a last-bit difference of a
float32 sum can flip a bfloat16 rounding of the next product's input,
which moves a value by ~1e-3); ``mel_lengths`` and ``n_steps`` exact.

The served mel against the JAX package with ``infer_dtype: bfloat16``
and ``decode_backend: xla`` is a loose side check: JAX's XLA decode
carries the whole step in bfloat16 (state, attention, outputs), so the
two round at other places.  Measured max |d| 9e-3, mean 2.2e-3 at a
typical |log-mel| of 0.44; held to 4e-2 and 1e-2, the first step to
2e-2, lengths equal with the gate switched off.  The same limits hold
the port's bfloat16 mel to its own float32 mel (measured 1e-2, 2.5e-3).

Inside the port the comparisons are exact or tight: streamed against
offline 1e-5 (the same ops in another chunking), multiplexed against solo
1e-6 (the same B = 1 ops), and ``auto`` and ``float32`` are the same
bits."""

import http.client
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msa_tts_tpu.models import config_from_params as jax_cfp
from msa_tts_tpu.models import init_tacotron2nv
from msa_tts_tpu.models.pallas_decoder import (
    _prenet_masks,
    pallas_decoder_infer,
)
from msa_tts_tpu.serving import AdaptiveTTS as JaxTTS
from msa_tts_tpu_torch.models.decoder import compute_view, decoder_infer
from msa_tts_tpu_torch.models.tacotron2nv import Tacotron2NV, config_from_params
from msa_tts_tpu_torch.server import TTSServer
from msa_tts_tpu_torch.serving import AdaptiveTTS
from msa_tts_tpu_torch.stream_mux import StreamMultiplexer
from msa_tts_tpu_torch.utils.convert import state_dict_from_jax
from torch_parity import jax_and_port_models, model_dict, randn

AP = dict(sample_rate=22050, n_fft=512, win_length=512, hop_length=128,
          f_min=0.0, f_max=8000.0, n_mels=20, griffinlim_iters=4)
MODEL = {
    "mask_padding": False, "n_mel_channels": 20, "n_frames_per_step": 2,
    "n_symbols": 200, "symbols_embedding_dim": 16,
    "encoder_n_convolutions": 2, "encoder_embedding_dim": 16,
    "encoder_kernel_size": 5, "speaker_emb_type": "static",
    "num_speakers": 1, "speaker_embedding_dim": 6,
    "speaker_embedding_dim_lin": 4, "attention_rnn_dim": 20,
    "decoder_rnn_dim": 20, "prenet_dim": 12, "max_decoder_steps": 24,
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
TEXT = "hello world"


def _pair(infer_dtype, **over):
    """JAX (XLA decode) and port AdaptiveTTS on the same weights (JAX
    init, seed 3), both with ``infer_dtype``."""
    mp = dict(MODEL, **over)
    params = {"model": mp, "audio_params": dict(AP),
              "infer_dtype": infer_dtype}
    p0, s0 = init_tacotron2nv(jax.random.PRNGKey(3), jax_cfp(dict(mp)))
    cfg = config_from_params(dict(mp))
    model = Tacotron2NV(cfg)
    model.load_state_dict(state_dict_from_jax(
        jax.device_get(p0), jax.device_get(s0), cfg), strict=True)
    return (JaxTTS(dict(params, decode_backend="xla"), p0, s0),
            AdaptiveTTS(params, model))


def _port(infer_dtype, seed=3, **over):
    mp = dict(MODEL, **over)
    model = Tacotron2NV(config_from_params(dict(mp)),
                        generator=torch.Generator().manual_seed(seed))
    return AdaptiveTTS({"model": mp, "audio_params": dict(AP),
                        "infer_dtype": infer_dtype}, model)


def _jax_masks(tts, B=1):
    dcfg = tts.cfg.decoder_config()
    key = jax.random.fold_in(jax.random.PRNGKey(0), 2)
    return np.array(_prenet_masks(dcfg, key, dcfg.max_decoder_steps, B))


KERNEL_ATOL = 5e-6    # first KERNEL_STEPS steps, against the JAX kernel
KERNEL_STEPS = 8
FLIP, FLIP_SHARE = 1e-4, 0.02
LENS = {1: [11], 3: [11, 7, 9]}


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("variant", [
    {},
    {"decoder_no_early_stopping": True},
    {"ap": {"attention_type": "LSA"}, "decoder_no_early_stopping": True},
    {"ap": {"norm": "sigmoid"}, "decoder_no_early_stopping": True},
    {"ap": {"trans_agent": False}, "decoder_no_early_stopping": True},
    {"ap": {"mask_energies": True}, "decoder_no_early_stopping": True},
    {"ap": {"location_attention": False},
     "decoder_no_early_stopping": True},
    {"p_prenet_dropout": 0.3, "decoder_no_early_stopping": True},
], ids=lambda v: str(v))
def test_bf16_decoder_matches_jax_kernel(variant, B):
    """The plain loop with bfloat16 parameters against the JAX package's
    whole-loop kernel (interpret mode) with the same parameters cast to
    bfloat16: summation order only."""
    (jcfg, params, _), (cfg, model) = jax_and_port_models(
        model_dict(**variant), 0)
    jd, dcfg = jcfg.decoder_config(), cfg.decoder_config()
    enc = randn(1, B, 11, dcfg.encoder_embedding_dim)
    lens = np.asarray(LENS[B], np.int32)
    rng = jax.random.PRNGKey(2)
    masks = np.array(_prenet_masks(jd, rng, jd.max_decoder_steps, B))
    p16 = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16),
                                 params["decoder"])
    ref = pallas_decoder_infer(
        p16, jd, jnp.asarray(enc).astype(jnp.bfloat16), jnp.asarray(lens),
        rng, interpret=True)
    out = decoder_infer(
        model.decoder.to(torch.bfloat16), dcfg,
        torch.from_numpy(enc).to(torch.bfloat16), torch.from_numpy(lens),
        torch.from_numpy(masks))
    r = dcfg.n_frames_per_step
    for name, a, b in zip(("mels", "gates", "aligns"), out, ref):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == np.float32 and b.dtype == np.float32, name
        assert a.shape == b.shape, name
        d = np.abs(a - b)
        first = (d[:, :KERNEL_STEPS] if name == "aligns"
                 else d[..., : KERNEL_STEPS * r])
        assert float(first.max()) <= KERNEL_ATOL, (name, float(first.max()))
        assert float((d > FLIP).mean()) <= FLIP_SHARE, name
    np.testing.assert_array_equal(out[3].numpy(), np.asarray(ref[3]))
    assert int(out[4]) == int(ref[4])
    if variant.get("decoder_no_early_stopping"):
        assert int(out[4]) == dcfg.max_decoder_steps


def test_bf16_view_is_kept_and_follows_the_weights():
    """The float32 view a bfloat16 decoder computes with is made once
    per decoder, holds its values and the bfloat16 sum of each LSTM's
    biases, and is made again when a weight changes in place."""
    tts = _port("bfloat16")
    dec = tts.model.decoder
    view, rnd = compute_view(dec)
    assert compute_view(dec)[0] is view
    assert view.decoder_rnn.weight_hh.dtype == torch.float32
    assert torch.equal(view.decoder_rnn.weight_hh,
                       dec.decoder_rnn.weight_hh.float())
    both = dec.attention_rnn.bias_ih + dec.attention_rnn.bias_hh
    assert torch.equal(view.attention_rnn.bias_ih, both.float())
    assert not view.attention_rnn.bias_hh.any()
    x = torch.tensor([1.0 + 2.0 ** -9, 3.0])
    assert torch.equal(rnd(x), x.to(torch.bfloat16).float())
    with torch.no_grad():
        dec.gate_layer.linear_layer.bias += 1.0
    again, _ = compute_view(dec)
    assert again is not view
    assert torch.equal(again.gate_layer.linear_layer.bias,
                       dec.gate_layer.linear_layer.bias.float())
    f32 = _port("float32").model.decoder
    assert compute_view(f32)[0] is f32


LOOSE_STEP0, LOOSE_MAX, LOOSE_MEAN = 2e-2, 4e-2, 1e-2


def _assert_loosely_close(out, ref):
    d = np.abs(out - ref)
    r = MODEL["n_frames_per_step"]
    assert float(d[:, :r].max()) <= LOOSE_STEP0
    assert float(d.max()) <= LOOSE_MAX
    assert float(d.mean()) <= LOOSE_MEAN
    assert float(np.abs(ref).mean()) > 0.2     # the scale the limits assume


def test_bf16_mel_close_to_jax_bf16():
    jtts, tts = _pair("bfloat16")
    assert tts.infer_dtype == torch.bfloat16
    assert tts.model.decoder.attention_rnn.weight_ih.dtype == torch.bfloat16
    ref = np.asarray(jtts.synthesize(TEXT, vocoder="none", spk_emb=EMB))
    out = tts.synthesize(TEXT, vocoder="none", spk_emb=EMB,
                         pre_masks=_jax_masks(tts))
    assert out.dtype == np.float32 and out.shape == ref.shape
    assert out.shape[1] == MODEL["max_decoder_steps"] * 2   # gate off
    assert np.isfinite(out).all()
    _assert_loosely_close(out, ref)


def test_bf16_mel_close_to_own_f32():
    """The same weights served in float32 and in bfloat16."""
    a = _port("float32").synthesize(TEXT, vocoder="none", spk_emb=EMB, seed=1)
    b = _port("bfloat16").synthesize(TEXT, vocoder="none", spk_emb=EMB,
                                     seed=1)
    assert a.shape == b.shape and not np.array_equal(a, b)
    _assert_loosely_close(b, a)


@pytest.mark.parametrize("idt", ["auto", "float32", "fp32", None])
def test_auto_and_float32_are_the_same_bits(idt):
    want = _port("float32").synthesize(TEXT, vocoder="none", spk_emb=EMB,
                                       seed=2)
    tts = _port(idt)
    assert tts.infer_dtype == torch.float32
    assert tts.model.embedding.weight.dtype == torch.float32
    got = tts.synthesize(TEXT, vocoder="none", spk_emb=EMB, seed=2)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("idt", ["float16", "int8", "bfloat"])
def test_unknown_infer_dtype_raises(idt):
    with pytest.raises(ValueError, match="infer_dtype"):
        _port(idt)


@pytest.mark.parametrize("over, seg, chunk", [
    ({}, 7, 10),
    ({"decoder_no_early_stopping": False, "gate_threshold": 0.45}, 5, 8),
], ids=["no_early_stop", "early_stop"])
def test_bf16_streamed_mel_matches_offline(over, seg, chunk):
    tts = _port("bfloat16", **over)
    own = tts.synthesize(TEXT, vocoder="none", spk_emb=EMB, seed=4)
    chunks = list(tts.synthesize_stream(
        TEXT, vocoder="none", spk_emb=EMB, seed=4, segment_steps=seg,
        chunk_frames=chunk))
    streamed = np.concatenate(chunks, axis=-1)
    assert streamed.dtype == np.float32 and streamed.shape == own.shape
    np.testing.assert_allclose(streamed, own, atol=1e-5, rtol=0)


def test_bf16_batch_rows_and_griffinlim():
    """A batch in bfloat16: float32 waveforms of the offline lengths, and
    each row's mel within 5e-2 of its solo decode: padding is masked, but
    the bfloat16 encoder's library kernels sum in another order at
    another shape and round the result to bfloat16."""
    tts = _port("bfloat16")
    texts = [TEXT, "hi"]
    masks = np.ones((MODEL["max_decoder_steps"], 2, 2, MODEL["prenet_dim"]),
                    np.float32)
    mels = tts.synthesize_batch(texts, vocoder="none", spk_emb=EMB,
                                pre_masks=masks)
    for i, text in enumerate(texts):
        solo = tts.synthesize(text, vocoder="none", spk_emb=EMB,
                              pre_masks=masks[:, :, :1])
        np.testing.assert_allclose(mels[i], solo, atol=5e-2, rtol=0)
    wavs = tts.synthesize_batch(texts, spk_emb=EMB, seed=0)
    for w, m in zip(wavs, mels):
        assert w.dtype == np.float32 and np.isfinite(w).all()
        assert len(w) == (m.shape[1] - 1) * AP["hop_length"]


def test_bf16_muxed_streams_match_solo():
    """Two bfloat16 streams live at once in a 2-slot mux (plain engine):
    each equals its solo stream at the mux's padded text length."""
    tts = _port("bfloat16")
    mux = StreamMultiplexer(tts, n_slots=2, t_cap=16, segment_steps=4)
    reqs = [(TEXT, 0), ("ok then", 1)]
    got = {}

    def run(i, text, seed):
        got[i] = np.concatenate(list(mux.stream(
            text, spk_emb=EMB, vocoder="none", seed=seed)), axis=-1)

    try:
        threads = [threading.Thread(target=run, args=(i, *r))
                   for i, r in enumerate(reqs)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    finally:
        mux.close()
    for i, (text, seed) in enumerate(reqs):
        want = np.concatenate(list(tts.synthesize_stream(
            text, spk_emb=EMB, vocoder="none", seed=seed, segment_steps=4,
            text_pad_multiple=16)), axis=-1)
        assert got[i].shape == want.shape
        np.testing.assert_allclose(got[i], want, atol=1e-6, rtol=0)


def test_bf16_served_over_http():
    """A bfloat16 model behind ``TTSServer``: /synthesize and
    /synthesize_stream (through a 2-slot mux) both answer a wav of the
    offline length."""
    tts = _port("bfloat16")
    want = len(tts.synthesize(TEXT, spk_emb=EMB))
    server = TTSServer(tts, default_spk_emb=EMB, window_ms=1.0,
                       stream_multiplex=2, stream_mux_t_cap=16)
    port = server.start()
    try:
        for path in ("/synthesize", "/synthesize_stream"):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
            conn.request("POST", path, json.dumps({"text": TEXT}),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            body = resp.read()
            conn.close()
            assert resp.status == 200 and body[:4] == b"RIFF", path
            assert len(body) - 44 == 2 * want, path
    finally:
        server.stop()
