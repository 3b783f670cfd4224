"""The PyTorch port's neural vocoders (msa_tts_tpu_torch/vocoders/,
ops/rnn.py GRU, utils/batching.py, utils/convert.py) against the JAX
package on the CPU: the same numpy-seeded inputs, weights and sampling
noise through both sides.

Tolerances: f32 on both sides with different summation orders: 1e-5 for
single modules; 1e-4 for end-to-end WaveRNN waveforms in f32 (a
sample-level autoregression of 96+ steps per fold feeds the differences
back); HiFi-GAN 1e-5; the denoiser 1e-4 (float32 STFT in the port,
float64 in numpy)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msa_tts_tpu.ops import rnn as JR
from msa_tts_tpu.utils import batching as JB
from msa_tts_tpu.vocoders import denoiser as JD
from msa_tts_tpu.vocoders import hifigan as JH
from msa_tts_tpu.vocoders import wavernn as JW
from msa_tts_tpu_torch.ops import rnn as TR
from msa_tts_tpu_torch.utils import batching as TB
from msa_tts_tpu_torch.utils.convert import (
    hifigan_state_dict_from_jax,
    wavernn_state_dict_from_jax,
)
from msa_tts_tpu_torch.vocoders import denoiser as TD
from msa_tts_tpu_torch.vocoders import hifigan as TH
from msa_tts_tpu_torch.vocoders import wavernn as TW

ATOL = 1e-5
WAV_ATOL = 1e-4
CFG = dict(rnn_dims=64, fc_dims=64, res_out_dims=32, n_mels=20,
           res_blocks=2, hop_length=16, pad=2, upsample_factors=(2, 2, 4))


def randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _randomize_batchnorm(params, state, seed=7):
    """Random affine terms and running statistics, so that the batch
    norms are not the identity they are initialised to."""
    rng = np.random.default_rng(seed)

    def walk(p, s):
        for k in p:
            if k.startswith("batch_norm"):
                n = p[k]["weight"].shape[0]
                p[k] = {"weight": jnp.asarray(rng.uniform(0.5, 1.5, n),
                                              jnp.float32),
                        "bias": jnp.asarray(rng.normal(0, 0.2, n),
                                            jnp.float32)}
                s[k] = {"running_mean": jnp.asarray(rng.normal(0, 0.3, n),
                                                    jnp.float32),
                        "running_var": jnp.asarray(rng.uniform(0.5, 1.5, n),
                                                   jnp.float32)}
    rp, rs = params["upsample"]["resnet"], state["upsample"]["resnet"]
    walk(rp, rs)
    for lp, ls in zip(rp["layers"], rs["layers"]):
        walk(lp, ls)


def wavernn_pair(seed=0, **over):
    """JAX ``(cfg, params, state)`` and the port's ``(cfg, model)`` with
    the same weights."""
    kw = dict(CFG, **over)
    jcfg, tcfg = JW.WaveRNNConfig(**kw), TW.WaveRNNConfig(**kw)
    params, state = JW.init_wavernn(jax.random.PRNGKey(seed), jcfg)
    _randomize_batchnorm(params, state)
    model = TW.WaveRNNModel(tcfg)
    model.load_state_dict(wavernn_state_dict_from_jax(
        jax.device_get(params), jax.device_get(state), tcfg), strict=True)
    return (jcfg, params, state), (tcfg, model.eval())


# ------------------------------------------------------------------ ops

def test_gru_cell_and_gru_match_jax():
    p = JR.init_gru_cell(jax.random.PRNGKey(1), 12, 16)
    x, h = randn(0, 3, 12), randn(1, 3, 16)
    tp = {k: torch.from_numpy(np.asarray(v)) for k, v in p.items()}
    want = np.asarray(JR.gru_cell(p, jnp.asarray(x), jnp.asarray(h)))
    got = TR.gru_cell(tp["weight_ih"], tp["weight_hh"], tp["bias_ih"],
                      tp["bias_hh"], torch.from_numpy(x),
                      torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)

    seq = randn(2, 3, 9, 12)
    rnn = torch.nn.GRU(12, 16, batch_first=True)
    rnn.load_state_dict({f"{k}_l0": v for k, v in tp.items()})
    want = np.asarray(JR.gru(p, jnp.asarray(seq)))
    with torch.no_grad():
        got = TR.gru(rnn, torch.from_numpy(seq))
        lib, _ = rnn(torch.from_numpy(seq))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), lib.numpy(), atol=ATOL, rtol=0)
    # the init helper draws U(±1/√H) on every tensor
    TR.init_gru_(rnn, torch.Generator().manual_seed(0))
    a = 1.0 / np.sqrt(16)
    for v in rnn.parameters():
        assert float(v.detach().abs().max()) <= a and float(v.detach().std()) > 0.3 * a


def test_batching_matches_jax():
    for n in (0, 1, 2, 3, 4, 5, 8, 9):
        assert TB.pow2_bucket(n) == JB.pow2_bucket(n)
    mels = [randn(i, 10, t) for i, t in enumerate((7, 33, 20))]
    for fill in ("floor", "zero"):
        want = JB.pad_mel_batch(mels, fill=fill)
        got = TB.pad_mel_batch([torch.from_numpy(m) for m in mels],
                               fill=fill)
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        TB.pad_mel_batch([torch.zeros(2, 3)], fill="zeros")


# -------------------------------------------------------------- WaveRNN

@pytest.mark.parametrize("over", [
    dict(), dict(use_upsample_net=False),
    dict(use_upsample_net=False, use_aux_net=False),
    dict(use_aux_net=False),
], ids=["net", "interp", "interp-noaux", "net-noaux"])
def test_upsample_and_melresnet_match_jax(over):
    (jcfg, params, state), (tcfg, model) = wavernn_pair(**over)
    mels = randn(5, 2, jcfg.n_mels, 9 + 2 * jcfg.pad)
    jm, ja = JW.upsample_apply(params["upsample"], state["upsample"], jcfg,
                               jnp.asarray(mels))
    with torch.no_grad():
        tm, ta = TW.upsample_apply(model.upsample, tcfg,
                                   torch.from_numpy(mels))
        tres = TW.melresnet_apply(model.upsample.resnet,
                                  torch.from_numpy(mels))
    assert tm.shape == jm.shape == (2, 9 * jcfg.hop_length, jcfg.n_mels)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=ATOL, rtol=0)
    if jcfg.use_aux_net:
        assert ta.shape == ja.shape
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=ATOL,
                                   rtol=0)
    else:
        assert ta is None and ja is None
    jres = JW.melresnet_apply(params["upsample"]["resnet"],
                              state["upsample"]["resnet"], jnp.asarray(mels))
    np.testing.assert_allclose(tres.numpy(), np.asarray(jres), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("over", [dict(), dict(mode="GAUSS"),
                                  dict(use_aux_net=False)],
                         ids=["mol", "gauss", "noaux"])
def test_wavernn_forward_matches_jax(over):
    (jcfg, params, state), (tcfg, model) = wavernn_pair(**over)
    mels = randn(6, 2, jcfg.n_mels, 3 + 2 * jcfg.pad)
    x = np.tanh(randn(7, 2, 3 * jcfg.hop_length))
    want = np.asarray(JW.wavernn_forward(params, state, jcfg,
                                         jnp.asarray(x), jnp.asarray(mels)))
    with torch.no_grad():
        got = TW.wavernn_forward(model, tcfg, torch.from_numpy(x),
                                 torch.from_numpy(mels))
    assert got.shape == want.shape == (2, 48, jcfg.n_classes)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("T,target,overlap", [
    (400, 64, 16), (176, 64, 16), (96, 64, 16), (10, 64, 16), (5, 8, 550),
])
def test_fold_and_xfade_match_jax(T, target, overlap):
    x = randn(T, 1, T, 3)
    want = JW.fold_with_overlap(x, target, overlap)
    got = TW.fold_with_overlap(x, target, overlap)
    np.testing.assert_array_equal(got, want)
    assert got.shape[0] >= 1          # the sub-overlap clamp: never no fold
    y = randn(T + 1, got.shape[0], target + 2 * overlap)
    np.testing.assert_array_equal(TW.xfade_and_unfold(y, target, overlap),
                                  JW.xfade_and_unfold(y, target, overlap))
    if T >= overlap:
        assert TW._fold_counts(T, target, overlap) == JW._fold_counts(
            T, target, overlap)
        jf, jn = JW._fold_device(jnp.asarray(x[0]), target, overlap)
        tf, tn = TW._fold_device(torch.from_numpy(x[0]), target, overlap)
        assert tn == jn
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(tf.numpy()[:tn], want)


def test_cast_generation_params_matches_jax():
    (jcfg, params, _), (tcfg, model) = wavernn_pair()
    jp = JW.cast_generation_params(params, jnp.bfloat16)
    tp = TW.cast_generation_params(model, torch.bfloat16)
    for name in TW.GEN_LAYERS:
        assert set(tp[name]) == set(jp[name])
        for k, v in tp[name].items():
            want = jp[name][k]
            assert str(v.dtype).endswith(str(want.dtype)), (name, k)
            np.testing.assert_array_equal(
                v.to(torch.float32).numpy(),
                np.asarray(want.astype(jnp.float32)))
    assert model.fc1.weight.dtype == torch.float32     # untouched


def _jax_noise(jcfg, key, L, n_pad):
    n1, n2 = JW._generation_noise(jcfg, key, L, n_pad)
    return np.array(n1), np.array(n2)


@pytest.mark.parametrize("over,gen_dtype,atol", [
    (dict(), None, WAV_ATOL),
    (dict(mode="GAUSS", use_upsample_net=False), None, WAV_ATOL),
], ids=["mol", "gauss-interp"])
def test_generate_batch_matches_jax(over, gen_dtype, atol):
    (jcfg, params, state), (tcfg, model) = wavernn_pair(**over)
    target, overlap = 64, 16
    jv = JW.WaveRNN(params=params, state=state, cfg=jcfg,
                    gen_dtype=gen_dtype, gen_backend="xla")
    tv = TW.WaveRNN(model, tcfg, gen_dtype=gen_dtype)
    mels = [randn(10 + i, jcfg.n_mels, t) - 4.0
            for i, t in enumerate((11, 5, 1))]
    keys = list(jax.random.split(jax.random.PRNGKey(5), len(mels)))
    want = jv.generate_batch(mels, target=target, overlap=overlap,
                             rngs=keys, bucket_frames=4, verbose=False)
    # the per-utterance draw of the JAX batch pipeline, handed over
    L = target + 2 * overlap
    _, n_pad = JW._fold_counts(12 * jcfg.hop_length, target, overlap)
    noises = [_jax_noise(jcfg, k, L, n_pad) for k in keys]
    got = tv.generate_batch(mels, target=target, overlap=overlap,
                            noises=noises, bucket_frames=4, verbose=False)
    for g, w, m in zip(got, want, mels):
        assert g.dtype == np.float64
        assert len(g) == len(w) == max(m.shape[1] - 1, 1) * jcfg.hop_length
        np.testing.assert_allclose(g, w, atol=atol, rtol=0)
    # a batch row equals the single-utterance run with that row's noise
    # when the two share a padded length
    solo = tv.generate_batch([mels[0]], target=target, overlap=overlap,
                             noises=noises[:1], bucket_frames=4,
                             verbose=False)[0]
    np.testing.assert_allclose(solo, got[0], atol=1e-6, rtol=0)


def test_generate_matches_jax_batched_and_unbatched():
    (jcfg, params, state), (tcfg, model) = wavernn_pair()
    target, overlap = 64, 16
    jv = JW.WaveRNN(params=params, state=state, cfg=jcfg, gen_dtype=None,
                    gen_backend="xla")
    tv = TW.WaveRNN(model, tcfg, gen_dtype=None)
    mel = randn(3, 1, jcfg.n_mels, 13) - 4.0
    key = jax.random.PRNGKey(9)
    want = jv.generate(mel, target=target, overlap=overlap, rng=key,
                       verbose=False)
    _, n_pad = JW._fold_counts(13 * jcfg.hop_length, target, overlap)
    noise = _jax_noise(jcfg, key, target + 2 * overlap, n_pad)
    got = tv.generate(mel, target=target, overlap=overlap, noise=noise,
                      verbose=False)
    assert len(got) == len(want) == 12 * jcfg.hop_length
    np.testing.assert_allclose(got, want, atol=WAV_ATOL, rtol=0)

    want = jv.generate(mel, batched=False, rng=key, verbose=False)
    noise = _jax_noise(jcfg, key, 13 * jcfg.hop_length, 1)
    got = tv.generate(mel, batched=False, noise=noise, verbose=False)
    assert len(got) == len(want)
    np.testing.assert_allclose(got, want, atol=WAV_ATOL, rtol=0)


def test_generation_noise_shapes_and_seeding():
    for mode, shapes in (("MOL", ((7, 3, 10), (7, 3))),
                         ("GAUSS", ((7, 3), (7, 3)))):
        cfg = TW.WaveRNNConfig(mode=mode, **CFG)
        a = TW.generation_noise(cfg, torch.Generator().manual_seed(1), 7, 3)
        b = TW.generation_noise(cfg, torch.Generator().manual_seed(1), 7, 3)
        assert tuple(a[0].shape), tuple(a[1].shape) == shapes
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        assert torch.isfinite(a[0]).all() and torch.isfinite(a[1]).all()
    # a default WaveRNN vocodes from its own seeded draw, bf16 weights
    cfg = TW.WaveRNNConfig(**CFG)
    voc = TW.WaveRNN(cfg=cfg, generator=torch.Generator().manual_seed(0),
                     device="cpu")
    assert voc.gen_dtype == torch.bfloat16
    mel = randn(0, cfg.n_mels, 6) - 4.0
    kw = dict(target=64, overlap=16, verbose=False)
    a = voc.generate_batch([mel], generator=torch.Generator().manual_seed(3),
                           **kw)[0]
    b = voc.generate_batch([mel], generator=torch.Generator().manual_seed(3),
                           **kw)[0]
    np.testing.assert_array_equal(a, b)
    assert len(a) == 5 * cfg.hop_length and np.abs(a).max() <= 1.0
    with pytest.raises(ValueError):
        TW.WaveRNN(cfg=cfg, gen_backend="cuda", device="cpu")
    with pytest.raises(ValueError):
        TW.WaveRNN(cfg=cfg, gen_dtype="float16", device="cpu")


def test_wavernn_state_dict_round_trip():
    (jcfg, params, state), (tcfg, model) = wavernn_pair(seed=3)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    p2, s2 = JW.wavernn_params_from_state_dict(sd, jcfg)
    flat_a, tree_a = jax.tree_util.tree_flatten((params, state))
    flat_b, tree_b = jax.tree_util.tree_flatten((p2, s2))
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # and the port's importer takes the same reference state_dict
    again = TW.wavernn_params_from_state_dict(sd, tcfg)
    for (k, a), (_, b) in zip(again.state_dict().items(),
                              model.state_dict().items()):
        assert torch.equal(a, b), k


# ------------------------------------------------------------- HiFi-GAN

H1 = dict(resblock="1", upsample_rates=[4, 2], upsample_kernel_sizes=[8, 4],
          upsample_initial_channel=16, resblock_kernel_sizes=[3, 5],
          resblock_dilation_sizes=[[1, 3], [1, 2]])
H2 = dict(H1, resblock="2", resblock_dilation_sizes=[[1, 3], [2, 4]])


def hifigan_pair(h, n_mels=10, seed=0):
    params = JH.init_generator(jax.random.PRNGKey(seed), h, n_mels=n_mels)
    # the shipped init is N(0, 0.01) with zero biases: scale up so that
    # the comparison sees values and biases of unit order
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda x: jnp.asarray(
            (np.asarray(x) * 20 + rng.normal(0, 0.1, x.shape))
            .astype(np.float32)), params)
    gen = TH.Generator(h, n_mels)
    gen.load_state_dict(hifigan_state_dict_from_jax(
        jax.device_get(params), h), strict=True)
    return params, gen.eval()


@pytest.mark.parametrize("h", [H1, H2], ids=["resblock1", "resblock2"])
def test_generator_apply_matches_jax(h):
    params, gen = hifigan_pair(h)
    mel = randn(1, 3, 10, 12)
    lens = np.array([12, 7, 3])
    for lengths in (None, lens):
        want = np.asarray(JH.generator_apply(
            params, h, jnp.asarray(mel),
            None if lengths is None else jnp.asarray(lengths)))
        with torch.no_grad():
            got = TH.generator_apply(
                gen, h, torch.from_numpy(mel),
                None if lengths is None else torch.from_numpy(lengths))
        assert got.shape == want.shape == (3, 12 * 8)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("h", [H1, H2], ids=["resblock1", "resblock2"])
def test_inference_batch_rows_equal_inference(h):
    params, gen = hifigan_pair(h)
    jv = JH.HiFiGAN.from_params(params, h)
    tv = TH.HiFiGAN.from_params(gen, h)
    mels = [randn(20 + i, 10, t) for i, t in enumerate((9, 33, 17))]
    want = jv.inference_batch(mels)
    got = tv.inference_batch(mels)
    for g, w, m in zip(got, want, mels):
        assert len(g) == len(w) == m.shape[1] * 8
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0)
        solo = tv.inference(m)
        np.testing.assert_allclose(g.numpy(), solo.numpy(), atol=ATOL,
                                   rtol=0)
        np.testing.assert_allclose(solo.numpy(),
                                   np.asarray(jv.inference(m)), atol=ATOL,
                                   rtol=0)


def test_weight_norm_fusion_and_round_trip():
    params, gen = hifigan_pair(H1, seed=2)
    plain = {k: v.numpy() for k, v in gen.state_dict().items()}
    # the JAX importer reads the port's state_dict back value for value
    p2 = JH.generator_params_from_state_dict(plain, H1)
    flat_a, tree_a = jax.tree_util.tree_flatten(params)
    flat_b, tree_b = jax.tree_util.tree_flatten(p2)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # a weight-normed checkpoint: g·v/‖v‖ over all dims but the first
    rng = np.random.default_rng(0)
    normed = {}
    for k, w in plain.items():
        if k.endswith(".weight"):
            scale = rng.uniform(0.5, 2.0, (w.shape[0],) + (1,) * (w.ndim - 1))
            normed[k[:-7] + ".weight_v"] = (w * scale).astype(np.float32)
            normed[k[:-7] + ".weight_g"] = np.sqrt(
                (w ** 2).sum(axis=tuple(range(1, w.ndim)), keepdims=True))
        else:
            normed[k] = w
    fused = TH.generator_params_from_state_dict(normed, H1)
    jfused = JH.generator_params_from_state_dict(normed, H1)
    for k, v in fused.state_dict().items():
        np.testing.assert_allclose(v.numpy(), plain[k], atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        fused.conv_pre.weight.detach().numpy(),
        np.asarray(jfused["conv_pre"]["weight"]), atol=1e-7, rtol=0)
    np.testing.assert_array_equal(
        TH._fuse_weight_norm(normed, "ups.0"),
        JH._fuse_weight_norm(normed, "ups.0"))


# -------------------------------------------------------------- denoiser

def test_reduce_noise_matches_jax():
    sr = 8000
    rng = np.random.default_rng(0)
    t = np.arange(sr) / sr
    noise = 0.1 * rng.standard_normal(sr)
    noisy = (0.5 * np.sin(2 * np.pi * 440 * t) + noise).astype(np.float32)
    kw = dict(n_fft=512, win_length=512, hop_length=128, n_std_thresh=1.0)
    want = JD.reduce_noise(noisy, noise.astype(np.float32), **kw)
    got = TD.reduce_noise(noisy, noise.astype(np.float32), **kw)
    assert got.shape == want.shape == noisy.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert np.abs(got - noisy).max() > 0.05          # it did something
