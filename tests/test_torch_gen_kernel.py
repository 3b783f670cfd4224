"""The WaveRNN sample loop of the PyTorch port (K3's plain version,
``vocoders/wavernn.py::sample_loop``) against the JAX package's scan and
against its Pallas kernel in interpret mode, from the same weights,
conditioning and noise; the weight repack key for key; and the LSTM
cell's plain version (K4) against the Pallas cell in interpret mode.

Tolerances: f32 on both sides with different summation orders over 64
autoregressive steps: 1e-5.  bf16 weights: every product's input is
rounded to bf16, where a last-bit difference of the f32 sums moves a
value by 2^-8 relative, and the loop feeds that back: 2e-2 over 64
steps (samples lie in [-1, 1])."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msa_tts_tpu.experimental.pallas_lstm_cell import (
    fused_lstm_cell,
    lstm_cell_reference as jax_cell_reference,
    prepare_weights as jax_prepare_weights,
)
from msa_tts_tpu.ops import rnn as JR
from msa_tts_tpu.vocoders import pallas_gen as JP
from msa_tts_tpu.vocoders import wavernn as JW
from msa_tts_tpu_torch.experimental import cuda_lstm_cell as TC
from msa_tts_tpu_torch.utils.convert import wavernn_state_dict_from_jax
from msa_tts_tpu_torch.vocoders import cuda_gen as TG
from msa_tts_tpu_torch.vocoders import wavernn as TW

CFG = dict(rnn_dims=64, fc_dims=64, res_out_dims=32, n_mels=20,
           res_blocks=2, hop_length=16, pad=2, upsample_factors=(2, 2, 4))
ATOL = 1e-5
ATOL_BF16 = 2e-2
B, T = 8, 64


def _setup(seed=0, **over):
    kw = dict(CFG, **over)
    jcfg = JW.WaveRNNConfig(**kw)
    tcfg = TW.WaveRNNConfig(**kw)
    params, state = JW.init_wavernn(jax.random.PRNGKey(seed), jcfg)
    model = TW.WaveRNNModel(tcfg)
    model.load_state_dict(wavernn_state_dict_from_jax(
        jax.device_get(params), jax.device_get(state), tcfg), strict=True)
    return jcfg, params, state, tcfg, model.eval()


def _inputs(cfg, seed=1):
    rng = np.random.default_rng(seed)
    mels_up = rng.standard_normal((B, T, cfg.n_mels)).astype(np.float32)
    aux = rng.standard_normal((B, T, cfg.res_out_dims)).astype(np.float32)
    n1, n2 = JW._generation_noise(cfg, jax.random.PRNGKey(seed + 2), T, B)
    return mels_up, aux, np.asarray(n1), np.asarray(n2)


def _jax_pallas(jcfg, jparams, mels_up, aux, n1, n2):
    """The hoisted projection, then the Pallas kernel in interpret mode."""
    d = jcfg.aux_dims
    W_I = jparams["I"]["weight"]
    if jcfg.use_aux_net:
        static_in = jnp.concatenate([mels_up, aux[:, :, :d]], axis=2)
        a_rest = jnp.asarray(aux[:, :, d:])
    else:
        static_in = jnp.asarray(mels_up)
        a_rest = jnp.zeros(mels_up.shape[:2] + (0,))
    i_static = JW._mm(static_in, W_I[:, 1:]) + jparams["I"]["bias"]
    run = JP.make_pallas_generate(jcfg, B, T, chunk=16, interpret=True)
    return np.asarray(run(
        JP.split_generation_params(jparams, jcfg),
        jnp.swapaxes(i_static, 0, 1), jnp.swapaxes(a_rest, 0, 1),
        jnp.asarray(n1), jnp.asarray(n2)))


@pytest.mark.parametrize("over,dtype,atol", [
    (dict(mode="MOL"), None, ATOL),
    (dict(mode="GAUSS"), None, ATOL),
    (dict(mode="MOL", use_aux_net=False), None, ATOL),
    (dict(mode="MOL"), "bfloat16", ATOL_BF16),
    (dict(mode="GAUSS"), "bfloat16", ATOL_BF16),
], ids=["mol", "gauss", "noaux", "mol-bf16", "gauss-bf16"])
def test_sample_loop_matches_jax_scan_and_pallas(over, dtype, atol):
    jcfg, params, _, tcfg, model = _setup(**over)
    mels_up, aux, n1, n2 = _inputs(jcfg)
    jparams = JW.cast_generation_params(
        params, jnp.dtype(dtype) if dtype else None)
    scan = np.asarray(JW._make_generate_scan(jcfg, with_noise=True)(
        jparams, jnp.asarray(mels_up), jnp.asarray(aux), jnp.asarray(n1),
        jnp.asarray(n2)))
    pallas = _jax_pallas(jcfg, jparams, mels_up, aux, n1, n2)

    gp = TW.cast_generation_params(
        model, torch.bfloat16 if dtype else None)
    out = TW.generate_samples(
        gp, tcfg, torch.from_numpy(mels_up),
        torch.from_numpy(aux) if tcfg.use_aux_net else None,
        torch.from_numpy(n1), torch.from_numpy(n2)).numpy()
    assert out.shape == scan.shape == pallas.shape == (B, T)
    assert np.isfinite(out).all() and np.abs(out).max() <= 1.0
    np.testing.assert_allclose(out, scan, atol=atol, rtol=0)
    np.testing.assert_allclose(out, pallas, atol=atol, rtol=0)


@pytest.mark.parametrize("over,dtype", [
    (dict(mode="MOL"), None),
    (dict(mode="MOL"), "bfloat16"),
    (dict(mode="GAUSS", use_aux_net=False), None),
], ids=["mol", "mol-bf16", "gauss-noaux"])
def test_split_generation_params_key_for_key(over, dtype):
    jcfg, params, _, tcfg, model = _setup(**over)
    jsplit = JP.split_generation_params(JW.cast_generation_params(
        params, jnp.dtype(dtype) if dtype else None), jcfg)
    tsplit = TG.split_generation_params(TW.cast_generation_params(
        model, torch.bfloat16 if dtype else None), tcfg)
    assert set(tsplit) == set(jsplit) == set(JP._W_NAMES) == set(TG._W_NAMES)
    assert tuple(TG._W_NAMES) == tuple(JP._W_NAMES)
    for k in JP._W_NAMES:
        a, b = tsplit[k], np.asarray(jsplit[k].astype(jnp.float32))
        assert tuple(a.shape) == b.shape, k
        assert str(a.dtype).endswith(str(jsplit[k].dtype)), k
        np.testing.assert_array_equal(a.to(torch.float32).numpy(), b,
                                      err_msg=k)
    # the kernel's layout (f32: the whole (out, in) matrices; bf16: every
    # block's slice in fragment order), read back: the same values, the
    # concat-input layers' aux columns after their z columns, vectors
    # flat, no aux columns without the aux net
    kw = TG.kernel_weights(TW.cast_generation_params(
        model, torch.bfloat16 if dtype else None), tcfg)
    back = TG.unpack_kernel_weights(kw, tcfg)
    assert set(back) == {"rnn1_ih", "rnn1_hh", "rnn2_ih", "rnn2_hh", "fc1",
                         "fc2", "fc3"}
    for k in JP._W_NAMES:
        if k not in TG._MATRICES:
            assert torch.equal(kw[k], tsplit[k].reshape(-1)), k
            continue
        if k.endswith("_a"):
            continue                   # held with its _z part below
        if k.endswith("_z"):
            want = tsplit[k].T
            if tcfg.use_aux_net:
                want = torch.cat([want, tsplit[k[:-1] + "a"].T], dim=1)
            else:
                assert not tsplit[k[:-1] + "a"].any(), k
            got = back[k[:-2]]
        else:
            want, got = tsplit[k].T, back[k.removesuffix("_w")]
        assert got.is_contiguous() and torch.equal(got, want), k


def test_cuda_generate_refuses_cpu_tensors():
    _, _, _, tcfg, model = _setup()
    gp = TW.cast_generation_params(model, None)
    i_static, a_rest = TW.hoisted_inputs(
        gp, tcfg, torch.zeros(2, 4, tcfg.n_mels),
        torch.zeros(2, 4, tcfg.res_out_dims))
    with pytest.raises(ValueError, match="CUDA"):
        TG.cuda_generate(TG.kernel_weights(gp, tcfg), tcfg, i_static,
                         a_rest, torch.zeros(4, 2, 10), torch.zeros(4, 2))
    with pytest.raises(ValueError, match="cuda"):
        TW.generate_samples(gp, tcfg, torch.zeros(2, 4, tcfg.n_mels),
                            torch.zeros(2, 4, tcfg.res_out_dims),
                            torch.zeros(4, 2, 10), torch.zeros(4, 2),
                            backend="cuda")


def test_mol_argmax_takes_the_first_of_a_tie():
    # equal logits and noise in every mixture: index 0's mean must win
    cfg = TW.WaveRNNConfig(**CFG)
    _, _, _, _, model = _setup()
    gp = TW.cast_generation_params(model, None)
    for name in ("rnn1", "rnn2", "fc1", "fc2", "fc3"):
        for v in gp[name].values():
            v.zero_()
    K = cfg.n_classes // 3
    gp["fc3"]["bias"][K: 2 * K] = torch.linspace(-0.5, 0.4, K)
    gp["fc3"]["bias"][2 * K:] = -30.0
    out = TW.sample_loop(gp, cfg, torch.zeros(3, 2, cfg.rnn_dims),
                         torch.zeros(3, 2, 3 * cfg.aux_dims),
                         torch.zeros(3, 2, K), torch.zeros(3, 2))
    np.testing.assert_allclose(out.numpy(), -0.5, atol=1e-6)


# ------------------------------------------------------------------ K4

@pytest.mark.parametrize("Bc,H,block_h", [(4, 256, 128), (8, 512, 256)])
def test_lstm_cell_reference_matches_pallas_cell(Bc, H, block_h):
    params = JR.init_lstm_cell(jax.random.PRNGKey(0), H, H)
    prep = jax_prepare_weights(params)
    rng = np.random.default_rng(0)
    x, h, c = (rng.standard_normal((Bc, H)).astype(np.float32)
               for _ in range(3))
    x_proj = jnp.asarray(x) @ prep["w_ih"].T + prep["bias"]
    h_k, c_k = fused_lstm_cell(x_proj, jnp.asarray(h), jnp.asarray(c),
                               prep["w_hh_t"], block_h=block_h,
                               interpret=True)
    h_r, c_r = jax_cell_reference(x_proj, jnp.asarray(h), jnp.asarray(c),
                                  prep["w_hh_t"])

    tprep = TC.prepare_weights(
        {k: torch.from_numpy(np.asarray(v)) for k, v in params.items()})
    np.testing.assert_array_equal(tprep["w_hh_t"].numpy(),
                                  np.asarray(prep["w_hh_t"]))
    np.testing.assert_allclose(tprep["bias"].numpy(),
                               np.asarray(prep["bias"]), atol=1e-7)
    tx = torch.from_numpy(x) @ tprep["w_ih"].T + tprep["bias"]
    h_t, c_t = TC.lstm_cell_reference(tx, torch.from_numpy(h),
                                      torch.from_numpy(c), tprep["w_hh_t"])
    for got, want in ((h_t, h_k), (c_t, c_k), (h_t, h_r), (c_t, c_r)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)
    # bf16 weights: h rounded to bf16, f32 sums (one step: 1e-2 covers a
    # 2^-8 rounding of a unit-scale h over 256-512 terms)
    wb = prep["w_hh_t"].astype(jnp.bfloat16)
    h_b, c_b = jax_cell_reference(x_proj, jnp.asarray(h), jnp.asarray(c), wb)
    h_tb, c_tb = TC.lstm_cell_reference(
        tx, torch.from_numpy(h), torch.from_numpy(c),
        tprep["w_hh_t"].to(torch.bfloat16))
    np.testing.assert_allclose(h_tb.numpy(), np.asarray(h_b), atol=1e-2)
    np.testing.assert_allclose(c_tb.numpy(), np.asarray(c_b), atol=1e-2)


def test_lstm_scan_on_cpu_and_refusals():
    rng = np.random.default_rng(1)
    Ts, Bc, H = 5, 3, 16
    xp = torch.from_numpy(rng.standard_normal((Ts, Bc, 4 * H))
                          .astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((H, 4 * H))
                         .astype(np.float32) * 0.1)
    h0, c0 = torch.zeros(Bc, H), torch.zeros(Bc, H)
    hs, (h, c) = TC.lstm_scan(xp, h0, c0, w)
    hh, cc = h0, c0
    for t in range(Ts):
        hh, cc = TC.lstm_cell_reference(xp[t], hh, cc, w)
        assert torch.equal(hs[t], hh)
    assert torch.equal(h, hh) and torch.equal(c, cc)
    before = TC.CELL_LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        TC.cuda_lstm_cell(xp[0], h0, c0, w)
    with pytest.raises(ValueError, match="cuda"):
        TC.lstm_scan(xp, h0, c0, w, backend="cuda")
    assert TC.CELL_LAUNCHES == before
