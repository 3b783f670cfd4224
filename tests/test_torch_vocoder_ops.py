"""The vocoder trainers' building blocks in the port against the JAX
package on the CPU, from the same numpy-seeded inputs and weights:
MFCCs and the differentiable "ap2" log-mel (``ops/audio.py``) with the
gradient of a scalar of the mel with respect to the waveform against
``jax.grad``; WaveRNN's two losses and their gradients (the ±1 edge
branches, the density branch where the bin's mass is at most 1e-5, and
log-scales tied with the floor), the samplers with JAX's draws
injected, ``melresnet_apply(train=True)`` and the statistics it leaves;
the Multi-Period and Multi-Scale discriminators' scores and every
feature map, the three GAN losses, and the weight trees carried both
ways (``utils/convert.py``).

Tolerances (float32 on both sides, summed in other orders): losses and
log-mels 1e-5 relative; gradients and feature maps 1e-5 of the largest
|value| of each tensor; samplers 1e-6 (one product and a log apart)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msa_tts_tpu.ops import audio as JA
from msa_tts_tpu.ops import nn as JN
from msa_tts_tpu.vocoders import hifigan_discriminators as JDisc
from msa_tts_tpu.vocoders import wavernn as JW
from msa_tts_tpu_torch.ops import audio as TA
from msa_tts_tpu_torch.utils.convert import (
    hifigan_jax_from_state_dict,
    hifigan_state_dict_from_jax,
    state_dict_to_tree,
    tree_to_state_dict,
    wavernn_jax_from_state_dict,
    wavernn_state_dict_from_jax,
)
from msa_tts_tpu_torch.vocoders import hifigan_discriminators as TDisc
from msa_tts_tpu_torch.vocoders import wavernn as TW
from torch_parity import HIFIGAN_H, one_torch_thread  # noqa: F401

RTOL = 1e-5
SAMPLE_ATOL = 1e-6
AP = dict(sample_rate=22050, n_fft=512, win_length=400, hop_length=128,
          f_min=0.0, f_max=8000.0, n_mels=20, n_mfcc=13)
AP2 = dict(sample_rate=22050, n_fft=512, win_size=512, hop_size=128,
           fmin=0.0, fmax=8000.0, n_mels=20, center=False)


def randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def close(ours, ref, rtol=RTOL):
    """``ours`` within ``rtol`` of the largest |value| of ``ref``."""
    ours = ours.detach().numpy() if hasattr(ours, "detach") else ours
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(ours - ref).max())
    assert err <= rtol * scale, (err, scale)


# ------------------------------------------------------------- frontends

def test_mfcc_matches_jax():
    wav = randn(0, 2, 3000) * 0.3
    close(TA.mfcc(torch.from_numpy(wav), AP), JA.mfcc(jnp.asarray(wav), AP))


@pytest.mark.parametrize("center", [False, True])
def test_melspec_ap2_torch_and_its_gradient_match_jax(center):
    ap = dict(AP2, center=center)
    wav = randn(1, 2, 2048) * 0.3
    wav[0, 100:400] = 0.0             # silent bins: the 1e-9 floor's place
    w = randn(2, 2, 20, 16 + 4 * center)

    def j_scalar(x):
        return jnp.sum(JA.melspec_ap2(x, ap, xp=jnp)[2] * w)

    j_mel = JA.melspec_ap2(jnp.asarray(wav), ap, xp=jnp)[2]
    j_grad = jax.grad(j_scalar)(jnp.asarray(wav))
    x = torch.from_numpy(wav).requires_grad_()
    mel = TA.melspec_ap2_torch(x, ap)
    close(mel, j_mel)
    np.testing.assert_allclose(mel.detach().numpy(),
                               TA.melspec_ap2(wav, ap), atol=1e-4, rtol=0)
    (g,) = torch.autograd.grad((mel * torch.from_numpy(w)).sum(), x)
    assert torch.isfinite(g).all()
    close(g, j_grad)


def test_reflect_pad_matches_numpy():
    x = randn(3, 2, 1, 13)
    got = TA.reflect_pad(torch.from_numpy(x), 5, 4).numpy()
    assert np.array_equal(got, np.pad(x, ((0, 0), (0, 0), (5, 4)),
                                      mode="reflect"))
    assert np.array_equal(TA.reflect_pad(torch.from_numpy(x), 0, 3).numpy(),
                          np.pad(x, ((0, 0), (0, 0), (0, 3)),
                                 mode="reflect"))


# ------------------------------------------------------- WaveRNN outputs

def _mol_inputs(seed=3, B=2, T=64, K=10):
    rng = np.random.default_rng(seed)
    logit = rng.standard_normal((B, T, K))
    means = rng.uniform(-1, 1, (B, T, K))
    log_scales = rng.uniform(-8.0, 1.0, (B, T, K))
    log_scales[0, :4, :] = -40.0                       # below the floor
    log_scales[1, :4, :] = np.float32(JW.LOG_SCALE_MIN)   # tied with it
    y = rng.uniform(-1, 1, (B, T, 1))
    y[:, :6] = 1.0                                     # the +1 edge
    y[:, 6:12] = -1.0                                  # the -1 edge
    y_hat = np.concatenate([logit, means, log_scales], -1)
    return y_hat.astype(np.float32), y.astype(np.float32)


def _loss_pair(j_fn, t_fn, y_hat, y):
    j_loss, j_grad = jax.value_and_grad(j_fn)(jnp.asarray(y_hat),
                                              jnp.asarray(y))
    x = torch.from_numpy(y_hat).requires_grad_()
    t_loss = t_fn(x, torch.from_numpy(y))
    (t_grad,) = torch.autograd.grad(t_loss, x)
    t_loss = float(t_loss.detach())
    assert abs(t_loss - float(j_loss)) <= RTOL * abs(float(j_loss))
    close(t_grad, j_grad)
    return t_loss


def test_mol_loss_and_gradient_match_jax():
    y_hat, y = _mol_inputs()
    # every branch is taken: the edges, the bin's mass, the density
    K = 10
    ls = np.maximum(y_hat[..., 2 * K:], JW.LOG_SCALE_MIN)
    inv = np.exp(-ls.astype(np.float64))
    c = y - y_hat[..., K:2 * K]
    with np.errstate(over="ignore"):
        delta = (1 / (1 + np.exp(-inv * (c + 1 / 65535)))
                 - 1 / (1 + np.exp(-inv * (c - 1 / 65535))))
    mid = np.abs(y[..., 0]) < 0.999
    assert (delta[mid] > 1e-5).any() and (delta[mid] <= 1e-5).any()
    _loss_pair(JW.discretized_mix_logistic_loss,
               TW.discretized_mix_logistic_loss, y_hat, y)


def test_gaussian_loss_and_gradient_match_jax():
    rng = np.random.default_rng(4)
    y_hat = np.stack([rng.uniform(-1, 1, (2, 50)),
                      rng.uniform(-9, 1, (2, 50))], -1).astype(np.float32)
    y_hat[0, :5, 1] = -7.0                               # tied with the floor
    y = rng.uniform(-1, 1, (2, 50, 1)).astype(np.float32)
    _loss_pair(JW.gaussian_loss, TW.gaussian_loss, y_hat, y)


def test_samplers_match_jax_with_its_draws():
    y_hat, _ = _mol_inputs(seed=5)
    logits = y_hat[:, 0]                       # (B, 3K)
    key = jax.random.PRNGKey(9)
    want = JW.sample_from_discretized_mix_logistic(jnp.asarray(logits), key)
    k_sel, k_u = jax.random.split(key)
    u1 = np.array(jax.random.uniform(k_sel, (2, 10), minval=1e-5,
                                     maxval=1.0 - 1e-5))
    u2 = np.array(jax.random.uniform(k_u, (2,), minval=1e-5,
                                     maxval=1.0 - 1e-5))
    got = TW.sample_from_discretized_mix_logistic(
        torch.from_numpy(logits), u1=torch.from_numpy(u1),
        u2=torch.from_numpy(u2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=SAMPLE_ATOL, rtol=0)
    g = torch.Generator().manual_seed(0)
    drawn = TW.sample_from_discretized_mix_logistic(torch.from_numpy(logits),
                                                    g)
    assert drawn.shape == (2,) and drawn.abs().max() <= 1.0

    gauss = np.stack([randn(6, 3, 40), randn(7, 3, 40) - 2.0], -1)
    want = JW.sample_from_gaussian(jnp.asarray(gauss), key)
    eps = np.array(jax.random.normal(key, (3, 40)))
    got = TW.sample_from_gaussian(torch.from_numpy(gauss),
                                  eps=torch.from_numpy(eps))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=SAMPLE_ATOL, rtol=0)
    assert TW.sample_from_gaussian(torch.from_numpy(gauss), g).shape == (3, 40)


# ------------------------------------------------- WaveRNN weights, BN

CFG = dict(rnn_dims=32, fc_dims=32, res_out_dims=16, compute_dims=16,
           n_mels=20, res_blocks=2, hop_length=64, pad=2,
           upsample_factors=(4, 4, 4))


def _jax_wavernn(seed=0):
    jcfg, tcfg = JW.WaveRNNConfig(**CFG), TW.WaveRNNConfig(**CFG)
    params, state = JW.init_wavernn(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    state = jax.tree_util.tree_map(          # running stats off the identity
        lambda x: jnp.asarray(np.asarray(x) + rng.uniform(0.1, 0.5, x.shape),
                              jnp.float32), state)
    return jcfg, tcfg, jax.device_get(params), jax.device_get(state)


def test_melresnet_train_mode_and_new_statistics_match_jax():
    """The batch-statistics pass and the statistics it leaves, against
    the JAX package's ``batchnorm1d(train=True)`` layer by layer (its
    ``melresnet_apply`` returns the output alone)."""
    jcfg, tcfg, params, state = _jax_wavernn()
    model = TW.WaveRNNModel(tcfg)
    model.load_state_dict(wavernn_state_dict_from_jax(params, state, tcfg))
    rp, rs = params["upsample"]["resnet"], state["upsample"]["resnet"]
    x = randn(8, 2, 20, 30)

    new = {}

    def bn(name, p, s, y):
        y, ns = JN.batchnorm1d(p, s, y, train=True)
        new[f"{name}.running_mean"] = ns["running_mean"]
        new[f"{name}.running_var"] = ns["running_var"]
        return y

    h = jax.nn.relu(bn("batch_norm", rp["batch_norm"], rs["batch_norm"],
                       JN.conv1d(rp["conv_in"], jnp.asarray(x))))
    for i, (lp, ls) in enumerate(zip(rp["layers"], rs["layers"])):
        y = jax.nn.relu(bn(f"layers.{i}.batch_norm1", lp["batch_norm1"],
                           ls["batch_norm1"], JN.conv1d(lp["conv1"], h)))
        h = bn(f"layers.{i}.batch_norm2", lp["batch_norm2"],
               ls["batch_norm2"], JN.conv1d(lp["conv2"], y)) + h
    want = JN.conv1d(rp["conv_out"], h)
    close(want, JW.melresnet_apply(rp, rs, jnp.asarray(x), train=True))

    out, stats = TW.melresnet_apply(model.upsample.resnet,
                                    torch.from_numpy(x), train=True)
    close(out, want)
    assert stats.keys() == new.keys()
    for k, v in new.items():
        close(stats[k], v)
    # the eval pass (the trainer's) still reads the running statistics
    close(TW.melresnet_apply(model.upsample.resnet, torch.from_numpy(x)),
          JW.melresnet_apply(rp, rs, jnp.asarray(x), train=False))


def test_wavernn_library_gru_forward_matches_jax():
    jcfg, tcfg, params, state = _jax_wavernn(seed=1)
    model = TW.WaveRNNModel(tcfg)
    model.load_state_dict(wavernn_state_dict_from_jax(params, state, tcfg))
    x = randn(9, 2, 3 * 64) * 0.5
    mels = randn(10, 2, 20, 3 + 4)
    want = JW.wavernn_forward(params, state, jcfg, jnp.asarray(x),
                              jnp.asarray(mels))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(mels))
    close(got, want)


@pytest.mark.parametrize("mode", ["MOL", "GAUSS"])
def test_wavernn_trees_round_trip(mode):
    jcfg = JW.WaveRNNConfig(mode=mode, **CFG)
    params, state = JW.init_wavernn(jax.random.PRNGKey(2), jcfg)
    params, state = jax.device_get(params), jax.device_get(state)
    tcfg = TW.WaveRNNConfig(mode=mode, **CFG)
    sd = wavernn_state_dict_from_jax(params, state, tcfg)
    p2, s2 = wavernn_jax_from_state_dict(sd, tcfg)
    for a, b in ((params, p2), (state, s2)):
        la, ta = jax.tree_util.tree_flatten(a)
        lb, tb = jax.tree_util.tree_flatten(b)
        assert ta == tb
        assert all(np.array_equal(x, y) for x, y in zip(la, lb))
    # the parameters alone (Adam's moments): no state
    names = [k for k, _ in TW.WaveRNNModel(tcfg).named_parameters()]
    p3, s3 = wavernn_jax_from_state_dict({k: sd[k] for k in names}, tcfg)
    assert s3 is None
    assert jax.tree_util.tree_structure(p3) == jax.tree_util.tree_structure(
        params)


# --------------------------------------------------------- discriminators

@pytest.fixture(scope="module")
def discriminators():
    tree = jax.device_get({"mpd": JDisc.init_mpd(jax.random.PRNGKey(3)),
                           "msd": JDisc.init_msd(jax.random.PRNGKey(4))})
    disc = TDisc.Discriminators()
    disc.load_state_dict(tree_to_state_dict(tree),
                         strict=True)
    return tree, disc


def test_discriminator_trees_round_trip(discriminators):
    tree, disc = discriminators
    back = state_dict_to_tree(disc.state_dict())
    la, ta = jax.tree_util.tree_flatten(tree)
    lb, tb = jax.tree_util.tree_flatten(back)
    assert ta == tb and all(np.array_equal(x, y) for x, y in zip(la, lb))
    gen = hifigan_jax_from_state_dict(hifigan_state_dict_from_jax(
        {"conv_pre": {"weight": np.ones((2, 3, 7), np.float32),
                      "bias": np.zeros(2, np.float32)},
         "ups": [{"weight": np.ones((2, 1, 4), np.float32),
                  "bias": np.zeros(1, np.float32)}]}, HIFIGAN_H))
    assert gen["ups"][0]["weight"].shape == (2, 1, 4)


def test_discriminator_init_draws_uniform_fan_in():
    disc = TDisc.Discriminators(torch.Generator().manual_seed(0))
    conv = disc.msd.discriminators[0].convs[3]          # 256 → 512, g 16
    bound = 1.0 / np.sqrt((256 // 16) * 41)
    w = conv.weight.detach()
    assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.9 * bound
    assert abs(float(w.std()) - bound / np.sqrt(3)) < 0.05 * bound


@pytest.mark.parametrize("T", [1024, 1000])
def test_discriminator_scores_and_feature_maps_match_jax(discriminators, T):
    """T = 1000 pads every period but 2 and 5 by reflection."""
    tree, disc = discriminators
    y, y_hat = randn(11, 2, 1, T) * 0.5, randn(12, 2, 1, T) * 0.5
    with torch.no_grad():
        got = disc(torch.from_numpy(y), torch.from_numpy(y_hat))
    want = jax.jit(lambda t, a, b: (JDisc.mpd_apply(t["mpd"], a, b),
                                     JDisc.msd_apply(t["msd"], a, b)))(
        tree, jnp.asarray(y), jnp.asarray(y_hat))
    n = 0
    for ours, ref in zip(got, want):
        for o_list, r_list in zip(ours, ref):
            leaves_o = jax.tree_util.tree_leaves(
                o_list, is_leaf=lambda x: isinstance(x, torch.Tensor))
            leaves_r = jax.tree_util.tree_leaves(r_list)
            assert len(leaves_o) == len(leaves_r)
            for a, b in zip(leaves_o, leaves_r):
                close(a, b)
                n += 1
    assert n == 2 * (5 + 5 * 6) + 2 * (3 + 3 * 8)

    # the three losses on these outputs
    (r_p, g_p, f_rp, f_gp), _ = got
    (jr_p, jg_p, jf_rp, jf_gp), _ = want
    for ours, ref in (
            (TDisc.feature_loss(f_rp, f_gp), JDisc.feature_loss(jf_rp,
                                                                jf_gp)),
            (TDisc.discriminator_loss(r_p, g_p)[0],
             JDisc.discriminator_loss(jr_p, jg_p)[0]),
            (TDisc.generator_loss(g_p)[0], JDisc.generator_loss(jg_p)[0])):
        assert abs(float(ours) - float(ref)) <= RTOL * abs(float(ref))


def test_discriminator_input_gradient_matches_jax(discriminators):
    """The generator's path through the discriminators: the gradient of
    the adversarial and feature-matching losses with respect to the
    generated audio."""
    tree, disc = discriminators
    y, y_hat = randn(13, 1, 1, 999) * 0.5, randn(14, 1, 1, 999) * 0.5

    def j_loss(yh):
        _, g_p, f_rp, f_gp = JDisc.mpd_apply(tree["mpd"], jnp.asarray(y), yh)
        _, g_s, f_rs, f_gs = JDisc.msd_apply(tree["msd"], jnp.asarray(y), yh)
        return (JDisc.generator_loss(g_p)[0] + JDisc.generator_loss(g_s)[0]
                + JDisc.feature_loss(f_rp, f_gp)
                + JDisc.feature_loss(f_rs, f_gs))

    want = jax.jit(jax.grad(j_loss))(jnp.asarray(y_hat))
    x = torch.from_numpy(y_hat).requires_grad_()
    (_, g_p, f_rp, f_gp), (_, g_s, f_rs, f_gs) = disc(torch.from_numpy(y), x)
    loss = (TDisc.generator_loss(g_p)[0] + TDisc.generator_loss(g_s)[0]
            + TDisc.feature_loss(f_rp, f_gp) + TDisc.feature_loss(f_rs, f_gs))
    (g,) = torch.autograd.grad(loss, x)
    close(g, want)
