"""The port's serving API (msa_tts_tpu_torch/serving.py) end to end
against the JAX package's ``AdaptiveTTS`` on one experiment directory
(params.yml + a reference ``.pt`` checkpoint written by the JAX
package), with the same injected noise: mel lengths exact, mels within
5e-5, Griffin-Lim waveforms within 1e-4 × peak; with attached neural
vocoders, HiFi-GAN waveforms within 1e-3 and WaveRNN waveforms within
5e-3 (both take mels that already differ by up to 5e-5; WaveRNN feeds
its samples back for 3,850 steps per fold)."""

import importlib.util
import math
import os

import jax
import numpy as np
import pytest
import torch
import yaml

from msa_tts_tpu.models import config_from_params as jax_cfp
from msa_tts_tpu.models import init_tacotron2nv
from msa_tts_tpu.models.pallas_decoder import _prenet_masks
from msa_tts_tpu.serving import AdaptiveTTS as JaxTTS
from msa_tts_tpu.utils.g2p import N_SYMBOLS
from msa_tts_tpu.utils.torch_import import save_torch_checkpoint
from msa_tts_tpu_torch.serving import AdaptiveTTS, Voice
from torch_parity import jax_wavernn_noise, model_dict, vocoder_pairs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AP = dict(sample_rate=22050, n_fft=512, win_length=512, hop_length=128,
          f_min=0.0, f_max=8000.0, n_mels=10, griffinlim_iters=4)
TEXTS = ["hello world", "a longer second sentence", "hi"]
MEL_ATOL = 5e-5


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """params.yml and checkpoints/checkpoint_0.pt, the gate bias raised
    so that the rows stop at different steps (14, 12 and 2 of 24; the
    closest gate logit stays 3e-4 from the threshold)."""
    path = tmp_path_factory.mktemp("exp")
    mp = model_dict(max_decoder_steps=24)
    params = {"model": mp, "audio_params": dict(AP)}
    with open(path / "params.yml", "w") as f:
        yaml.safe_dump(params, f)
    cfg = jax_cfp(dict(mp, n_symbols=N_SYMBOLS, num_speakers=1))
    p, s = init_tacotron2nv(jax.random.PRNGKey(3), cfg)
    p["decoder"]["gate_layer"]["bias"] = p["decoder"]["gate_layer"][
        "bias"] + 0.22
    os.makedirs(path / "checkpoints")
    save_torch_checkpoint(str(path / "checkpoints" / "checkpoint_0.pt"),
                          p, s, cfg)
    return str(path)


@pytest.fixture(scope="module")
def both(experiment):
    return (JaxTTS.from_experiment(experiment),
            AdaptiveTTS.from_experiment(experiment, device="cpu"))


def _jax_masks(tts, B):
    dcfg = tts.cfg.decoder_config()
    key = jax.random.fold_in(jax.random.PRNGKey(0), 2)
    return np.array(_prenet_masks(dcfg, key, dcfg.max_decoder_steps, B))


def _jax_phase(n_frames):
    return np.array(jax.random.uniform(
        jax.random.PRNGKey(0), (AP["n_fft"] // 2 + 1, n_frames),
        minval=-math.pi, maxval=math.pi,
    ))


EMB = np.random.default_rng(0).standard_normal(8).astype(np.float32)


def test_synthesize_batch_mels_match_jax(both):
    jtts, tts = both
    ref = jtts.synthesize_batch(TEXTS, vocoder="none", spk_emb=EMB,
                                text_pad_multiple=8, pad_batch_to=4)
    out = tts.synthesize_batch(TEXTS, vocoder="none", spk_emb=EMB,
                               text_pad_multiple=8, pad_batch_to=4,
                               pre_masks=_jax_masks(tts, 4))
    assert len({m.shape[1] for m in ref}) > 1   # ragged stop steps
    for a, b in zip(out, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=MEL_ATOL, rtol=0)


def test_synthesize_griffinlim_matches_jax(both):
    jtts, tts = both
    ref_mel = jtts.synthesize(TEXTS[0], vocoder="none", spk_emb=EMB)
    ref = np.asarray(jtts.synthesize(TEXTS[0], spk_emb=EMB))
    min_frames = AP["n_fft"] // AP["hop_length"] + 1
    out = tts.synthesize(
        TEXTS[0], spk_emb=EMB, pre_masks=_jax_masks(tts, 1),
        gl_phase=_jax_phase(max(ref_mel.shape[1], min_frames)),
    )
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-4 * np.abs(ref).max())


def test_synthesize_batch_griffinlim_matches_jax(both):
    jtts, tts = both
    mels = jtts.synthesize_batch(TEXTS, vocoder="none", spk_emb=EMB)
    ref = jtts.synthesize_batch(TEXTS, spk_emb=EMB)
    t_pad = -(-max(m.shape[1] for m in mels) // 32) * 32
    out = tts.synthesize_batch(TEXTS, spk_emb=EMB,
                               pre_masks=_jax_masks(tts, len(TEXTS)),
                               gl_phase=_jax_phase(t_pad))
    for a, b in zip(out, ref):
        b = np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-4 * np.abs(b).max())


def test_voice_and_seeded_requests(both):
    """A Voice carries its own weights; a request's noise comes from its
    seed, so the same seed gives the same waveform."""
    _, tts = both
    a = tts.synthesize("hello", spk_emb=EMB, seed=1)
    b = tts.synthesize("hello", spk_emb=EMB, seed=1)
    np.testing.assert_array_equal(a, b)
    assert np.isfinite(a).all()
    voice = Voice(state_dict=tts.model.state_dict(), spk_emb=EMB)
    v = tts.synthesize("hello", voice, seed=1)
    np.testing.assert_array_equal(v, a)


def test_not_ported_features_raise(both):
    _, tts = both
    base = {"model": dict(tts.params["model"]),
            "audio_params": dict(AP)}
    # dp and tp serving are ported (tests/test_torch_parallel.py,
    # tests/test_torch_tp.py): on the CPU, two shards of each, bfloat16
    # under tp too; the rejections the JAX package keeps still raise,
    # with its text, and so does an explicit kernel decode under tp
    dp2 = AdaptiveTTS(dict(base, parallel={"dp": 2}), tts.model)
    assert dp2._mesh.shape == {"dp": 2, "task": 1}
    tp2 = AdaptiveTTS(dict(base, parallel={"tp": 2, "tp_min_dim": 8}),
                      tts.model)
    assert tp2._tp_mesh.shape == {"dp": 1, "task": 1, "tp": 2}
    assert tp2.decode_backend == "torch"
    with pytest.raises(NotImplementedError, match="not both"):
        AdaptiveTTS(dict(base, parallel={"dp": 2, "tp": 2}), tts.model)
    with pytest.raises(NotImplementedError, match="single-device"):
        AdaptiveTTS(dict(base, parallel={"tp": 2}, decode_backend="cuda"),
                    tts.model)
    tp16 = AdaptiveTTS(dict(base, parallel={"tp": 2, "tp_min_dim": 8},
                            infer_dtype="bfloat16"), tts.model)
    assert tp16.model.embedding.weight.dtype == torch.bfloat16
    assert tts.model.embedding.weight.dtype == torch.float32
    # infer_dtype: bfloat16 is served (tests/test_torch_bf16.py); a type
    # the package does not know still raises
    with pytest.raises(ValueError, match="infer_dtype"):
        AdaptiveTTS(dict(base, infer_dtype="float16"), tts.model)
    # a neural vocoder must be attached first
    for voc in ("wavernn", "hifigan"):
        with pytest.raises(ValueError, match="attach_vocoder"):
            tts.synthesize("hi", spk_emb=EMB, vocoder=voc)
    # and an object without the vocoder seam is not attached
    with pytest.raises(ValueError, match="object is not a vocoder"):
        tts.attach_vocoder("melgan", object())
    with pytest.raises(ValueError):
        AdaptiveTTS(dict(base, decode_backend="cuda"), tts.model)


@pytest.fixture(scope="module")
def both_vocoded(experiment):
    """A JAX and a port AdaptiveTTS of their own with the same tiny
    WaveRNN (f32 sample loop) and HiFi-GAN attached."""
    jtts = JaxTTS.from_experiment(experiment)
    tts = AdaptiveTTS.from_experiment(experiment, device="cpu")
    pairs = vocoder_pairs(AP["n_mels"], AP["hop_length"])
    for name, (jv, tv) in pairs.items():
        jtts.attach_vocoder(name, jv)
        tts.attach_vocoder(name, tv)
    return jtts, tts, pairs


def _padded_frames(mels):
    return -(-max(m.shape[1] for m in mels) // 32) * 32


@pytest.mark.parametrize("batched", [False, True], ids=["one", "batch"])
def test_synthesize_wavernn_matches_jax(both_vocoded, batched):
    jtts, tts, pairs = both_vocoded
    hop = AP["hop_length"]
    texts = TEXTS if batched else TEXTS[:1]
    # the JAX request vocodes with its default key, split per utterance
    if batched:
        mels = jtts.synthesize_batch(texts, vocoder="none", spk_emb=EMB)
        ref = jtts.synthesize_batch(texts, vocoder="wavernn", spk_emb=EMB)
    else:
        mels = [jtts.synthesize(texts[0], vocoder="none", spk_emb=EMB)]
        ref = [jtts.synthesize(texts[0], vocoder="wavernn", spk_emb=EMB)]
    noise = jax_wavernn_noise(pairs["wavernn"][0], jax.random.PRNGKey(0),
                              len(texts), _padded_frames(mels))
    masks = _jax_masks(tts, len(texts))
    if batched:
        out = tts.synthesize_batch(texts, vocoder="wavernn", spk_emb=EMB,
                                   pre_masks=masks, voc_noise=noise)
    else:
        out = [tts.synthesize(texts[0], vocoder="wavernn", spk_emb=EMB,
                              pre_masks=masks, voc_noise=noise)]
    for a, b, m in zip(out, ref, mels):
        b = np.asarray(b)
        assert len(a) == len(b) == max(m.shape[1] - 1, 1) * hop
        assert np.isfinite(a).all() and np.abs(a).max() <= 1.0
        np.testing.assert_allclose(a, b, atol=5e-3, rtol=0)


@pytest.mark.parametrize("batched", [False, True], ids=["one", "batch"])
def test_synthesize_hifigan_matches_jax(both_vocoded, batched):
    jtts, tts, _ = both_vocoded
    hop = AP["hop_length"]
    texts = TEXTS if batched else TEXTS[:1]
    masks = _jax_masks(tts, len(texts))
    if batched:
        mels = jtts.synthesize_batch(texts, vocoder="none", spk_emb=EMB)
        ref = jtts.synthesize_batch(texts, vocoder="hifigan", spk_emb=EMB)
        out = tts.synthesize_batch(texts, vocoder="hifigan", spk_emb=EMB,
                                   pre_masks=masks)
    else:
        mels = [jtts.synthesize(texts[0], vocoder="none", spk_emb=EMB)]
        ref = [jtts.synthesize(texts[0], vocoder="hifigan", spk_emb=EMB)]
        out = [tts.synthesize(texts[0], vocoder="hifigan", spk_emb=EMB,
                              pre_masks=masks)]
    for a, b, m in zip(out, ref, mels):
        b = np.asarray(b)
        assert a.shape == b.shape == (m.shape[1] * hop,)
        assert np.abs(b).max() > 0.05            # not a silent generator
        np.testing.assert_allclose(a, b, atol=1e-3, rtol=0)


def test_seeded_wavernn_request_is_deterministic(both_vocoded):
    _, tts, _ = both_vocoded
    # long enough to outlast the crossfade's leading silence
    a, b, c = (tts.synthesize(TEXTS[1], spk_emb=EMB, seed=seed,
                              vocoder="wavernn") for seed in (4, 4, 5))
    np.testing.assert_array_equal(a, b)
    assert len(a) > 550 and np.abs(a).max() > 0
    assert a.shape != c.shape or np.abs(a - c).max() > 0


def test_port_g2p_and_config_are_equal_copies():
    """The port keeps its own G2P and config modules (it may import
    nothing of the JAX package): same symbols, same phoneme ids, same
    profiles, same params."""
    import msa_tts_tpu.config as jconfig
    import msa_tts_tpu.utils.g2p as jg2p
    import msa_tts_tpu_torch.config as tconfig
    import msa_tts_tpu_torch.utils.g2p as tg2p

    assert tg2p.N_SYMBOLS == jg2p.N_SYMBOLS
    assert tg2p.char_list == jg2p.char_list
    for text in TEXTS + ["The birch canoe slid on the smooth planks."]:
        assert (tg2p.Grapheme2Phoneme().convert(
            text, convert_mode="text_to_phone_to_idx")
            == jg2p.Grapheme2Phoneme().convert(
                text, convert_mode="text_to_phone_to_idx"))
    jdir = os.path.join(os.path.dirname(jg2p.__file__), "profiles")
    tdir = os.path.join(os.path.dirname(tg2p.__file__), "profiles")
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    for name in os.listdir(jdir):
        with open(os.path.join(jdir, name), "rb") as a, \
                open(os.path.join(tdir, name), "rb") as b:
            assert a.read() == b.read(), name
    yml = os.path.join(REPO, "examples", "maml", "params.yml")
    assert tconfig.load_params(yml) == jconfig.load_params(yml)
    assert tconfig.parse_optim_params(
        {"optimizer_type": "Adam", "lr": "1e-3"}) == (
            jconfig.parse_optim_params(
                {"optimizer_type": "Adam", "lr": "1e-3"}))


def test_chip_smoke_config_is_the_shipped_config():
    """chip_smoke.py carries examples/maml/params.yml's model,
    audio_params and what adaptation reads as dicts (the GPU host may
    have no yaml)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    with open(os.path.join(REPO, "examples", "maml", "params.yml")) as f:
        shipped = yaml.safe_load(f)
    assert smoke.SHIPPED_MODEL == shipped["model"]
    assert smoke.SHIPPED_AUDIO == shipped["audio_params"]
    for key, value in smoke.SHIPPED_ADAPT.items():
        if key == "dataset_train":
            assert value == {"trim_margin_silence": shipped[key][
                "trim_margin_silence"]}
        else:
            assert value == shipped[key], key


def test_chip_smoke_fails_without_cuda():
    """No result without a GPU: the script exits non-zero."""
    import subprocess
    import sys

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU host")
    res = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300,
                         cwd=REPO)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
