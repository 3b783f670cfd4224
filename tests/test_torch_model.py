"""The port's whole synthesis slice (msa_tts_tpu_torch/models/tacotron2nv.py)
and its jax-free weight converter (msa_tts_tpu_torch/utils/convert.py)
against the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msa_tts_tpu.models import tacotron2nv_infer as jax_infer
from msa_tts_tpu.models.pallas_decoder import _prenet_masks
from msa_tts_tpu.utils.torch_import import pytrees_to_state_dict
from msa_tts_tpu_torch.models import cuda_decoder as CD
from msa_tts_tpu_torch.models.tacotron2nv import (
    Tacotron2NV,
    config_from_params,
    tacotron2nv_infer,
)
from msa_tts_tpu_torch.utils.convert import state_dict_from_jax
from torch_parity import jax_and_port_models, model_dict, randn

ATOL = 5e-5


def test_infer_matches_jax_on_padded_batch():
    """Embedding → encoder (mask_pad) → speaker concat → decoder →
    postnet on a padded batch with masked energies, atol 5e-5; the
    mel lengths exact."""
    mp = model_dict(ap={"mask_energies": True},
                    decoder_no_early_stopping=True)
    (jcfg, params, state), (cfg, model) = jax_and_port_models(mp, seed=3)
    B, T = 3, 13
    rs = np.random.default_rng(0)
    inputs = rs.integers(1, mp["n_symbols"], (B, T)).astype(np.int64)
    lens = np.array([13, 8, 11], np.int64)
    inputs[np.arange(T)[None, :] >= lens[:, None]] = 0
    spk = randn(1, B, mp["speaker_embedding_dim"])
    rng = jax.random.PRNGKey(7)
    ref = jax_infer(params, state, jcfg, jnp.asarray(inputs, jnp.int32),
                    jnp.asarray(lens, jnp.int32), jnp.asarray(spk), rng,
                    mask_pad=True)
    dcfg = jcfg.decoder_config()
    masks = np.array(_prenet_masks(dcfg, jax.random.fold_in(rng, 2),
                                   dcfg.max_decoder_steps, B))
    out = tacotron2nv_infer(
        model, cfg, torch.from_numpy(inputs), torch.from_numpy(lens),
        torch.from_numpy(spk), torch.from_numpy(masks), mask_pad=True,
    )
    mel, mel_len, align = (o.numpy() for o in out)
    np.testing.assert_array_equal(mel_len, np.asarray(ref[1]))
    np.testing.assert_allclose(mel, np.asarray(ref[0]), atol=ATOL, rtol=0)
    np.testing.assert_allclose(align, np.asarray(ref[2]), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("mp", [
    model_dict(),
    model_dict(speaker_emb_type="learnable_lookup"),
    model_dict(speaker_emb_type="static+linear"),
    model_dict(ap={"attention_type": "LSA"}),
    model_dict(ap={"trans_agent": False, "location_attention": False}),
], ids=["static", "learnable_lookup", "static+linear", "lsa", "no_ta_loc"])
def test_state_dict_from_jax_equals_pytrees_to_state_dict(mp):
    """The jax-free converter gives the JAX package's own export key for
    key and value for value, and the port's module takes it strictly."""
    (jcfg, params, state), (cfg, _) = jax_and_port_models(mp)
    ref = pytrees_to_state_dict(params, state, jcfg)
    sd = state_dict_from_jax(jax.device_get(params),
                             jax.device_get(state), cfg)
    assert sorted(sd) == sorted(ref)
    for k, v in ref.items():
        assert sd[k].dtype == torch.from_numpy(np.array(v)).dtype, k
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(v),
                                      err_msg=k)
    # a generator-initialised module has exactly these keys and shapes
    fresh = Tacotron2NV(cfg, generator=torch.Generator().manual_seed(0))
    fsd = fresh.state_dict()
    assert sorted(fsd) == sorted(ref)
    assert all(tuple(fsd[k].shape) == np.shape(ref[k]) for k in ref)


def test_generator_init_is_seeded():
    cfg = config_from_params(model_dict())
    a = Tacotron2NV(cfg, generator=torch.Generator().manual_seed(5))
    b = Tacotron2NV(cfg, generator=torch.Generator().manual_seed(5))
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), k
    w = a.decoder.attention_rnn.weight_hh.detach()
    assert float(w.abs().max()) <= 1.0 / np.sqrt(cfg.attention_rnn_dim)


def _tiny_inputs(cfg, B=2, T=6):
    g = torch.Generator().manual_seed(0)
    dcfg = cfg.decoder_config()
    return (
        torch.randint(1, cfg.n_symbols, (B, T), generator=g),
        torch.tensor([T, T - 2]),
        torch.randn(B, cfg.speaker_embedding_dim, generator=g),
        CD.prenet_masks(dcfg, dcfg.max_decoder_steps, B, g, device="cpu"),
    )


@pytest.mark.parametrize("ap", [{}, {"windowing": True}])
def test_backend_routing_on_cpu(ap):
    """On CPU tensors `auto` and `torch` run the plain loop (no kernel
    launch), and `cuda` raises, whether or not the kernel lowers the
    config."""
    cfg = config_from_params(model_dict(ap=ap))
    model = Tacotron2NV(cfg, generator=torch.Generator().manual_seed(0))
    args = _tiny_inputs(cfg)
    before = CD.LAUNCHES
    a = tacotron2nv_infer(model, cfg, *args, decode_backend="auto")
    b = tacotron2nv_infer(model, cfg, *args, decode_backend="torch")
    assert CD.LAUNCHES == before
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError):
        tacotron2nv_infer(model, cfg, *args, decode_backend="cuda")
