"""The port's plain decoder loop (msa_tts_tpu_torch/models/decoder.py) —
the CPU version of the CUDA decoder kernel — against the JAX package's
``decoder_infer`` and its Pallas whole-loop kernel in interpret mode, on
the same weights, encoder outputs and prenet masks.

Tolerance: mels, gates and alignments within 2e-5 (f32 summation order
differs between the frameworks over 17 autoregressive steps);
``mel_lengths`` and ``n_steps`` exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msa_tts_tpu.models.decoder import decoder_infer as jax_decoder_infer
from msa_tts_tpu.models.pallas_decoder import (
    _prenet_masks,
    pallas_decoder_infer,
)
from msa_tts_tpu_torch.models import cuda_decoder as CD
from msa_tts_tpu_torch.models.decoder import decoder_infer
from torch_parity import jax_and_port_models, model_dict, randn

ATOL = 2e-5
LENS = {1: [11], 3: [11, 7, 9]}


def _decode_both(mp, B, T_in=11, seed=0):
    (jcfg, params, _), (cfg, model) = jax_and_port_models(mp, seed)
    jd, dcfg = jcfg.decoder_config(), cfg.decoder_config()
    enc = randn(1, B, T_in, dcfg.encoder_embedding_dim)
    lens = np.asarray(LENS[B], np.int32)
    rng = jax.random.PRNGKey(2)
    masks = np.array(_prenet_masks(jd, rng, jd.max_decoder_steps, B))
    out = decoder_infer(model.decoder, dcfg, torch.from_numpy(enc),
                        torch.from_numpy(lens), torch.from_numpy(masks))
    return out, (params["decoder"], jd, jnp.asarray(enc),
                 jnp.asarray(lens), rng)


def _assert_same(out, ref):
    for name, a, b in zip(
        ("mels", "gates", "aligns", "mel_lengths", "n_steps"), out, ref
    ):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape, name
        if name in ("mel_lengths", "n_steps"):
            np.testing.assert_array_equal(a, b, err_msg=name)
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


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("variant", VARIANTS, ids=lambda v: str(v))
def test_decoder_infer_matches_jax_and_pallas(variant, B):
    """Every config the kernel lowers: the plain loop equals JAX's
    while-loop and the Pallas kernel (interpret mode)."""
    out, (p, jd, enc, lens, rng) = _decode_both(model_dict(**variant), B)
    _assert_same(out, jax_decoder_infer(p, jd, enc, lens, rng))
    _assert_same(out, pallas_decoder_infer(p, jd, enc, lens, rng,
                                           interpret=True))


@pytest.mark.parametrize("ap", [
    {"windowing": True}, {"forward_attn_mask": True},
])
def test_unlowered_variants_match_jax(ap):
    """Inference windowing and forward_attn_mask run on the plain path
    only (the kernel does not lower them)."""
    out, (p, jd, enc, lens, rng) = _decode_both(model_dict(ap=ap), 3)
    _assert_same(out, jax_decoder_infer(p, jd, enc, lens, rng))


def test_no_early_stopping_runs_to_cap():
    mp = model_dict(decoder_no_early_stopping=True, max_decoder_steps=9)
    out, (p, jd, enc, lens, rng) = _decode_both(mp, 3)
    assert int(out[4]) == 9
    _assert_same(out, jax_decoder_infer(p, jd, enc, lens, rng))


def test_supports_config():
    def dcfg(**ap):
        from msa_tts_tpu_torch.models.tacotron2nv import config_from_params

        return config_from_params(model_dict(ap=ap)).decoder_config()

    assert CD.supports_config(dcfg())
    assert CD.supports_config(dcfg(attention_type="LSA"))
    assert not CD.supports_config(dcfg(windowing=True))
    assert not CD.supports_config(dcfg(forward_attn_mask=True))


def test_cuda_decoder_infer_raises_on_cpu_tensors():
    """No fallback that hides the device: CPU tensors are refused before
    anything is built."""
    from msa_tts_tpu_torch.models.tacotron2nv import (
        Tacotron2NV,
        config_from_params,
    )

    cfg = config_from_params(model_dict())
    model = Tacotron2NV(cfg, generator=torch.Generator().manual_seed(0))
    dcfg = cfg.decoder_config()
    enc = torch.zeros(2, 5, dcfg.encoder_embedding_dim)
    masks = torch.ones(dcfg.max_decoder_steps, 2, 2, dcfg.prenet_dim)
    with pytest.raises(ValueError, match="CUDA"):
        CD.cuda_decoder_infer(model.decoder, dcfg, enc,
                              torch.tensor([5, 3]), masks)
    assert CD.LAUNCHES == 0


@pytest.mark.parametrize("ap", [{}, {"attention_type": "LSA"},
                                {"trans_agent": False}])
def test_split_decoder_params_layout(ap):
    """The kernel's packed weights compute the same maps as the modules:
    each LSTM's three unit-major segments against the pieces of [x, h],
    rows zero-padded to 8 values, the projection and gate as one matrix
    over [decoder h | context], the transition agent as [ctx | query]."""
    from msa_tts_tpu_torch.models.decoder import Decoder
    from msa_tts_tpu_torch.models.tacotron2nv import config_from_params

    dcfg = config_from_params(model_dict(ap=ap)).decoder_config()
    dec = Decoder(dcfg, generator=torch.Generator().manual_seed(0))
    w = CD.split_decoder_params(dec, dcfg)
    g = torch.Generator().manual_seed(1)
    P, E = dcfg.prenet_dim, dcfg.encoder_embedding_dim
    H, Hd = dcfg.attention_rnn_dim, dcfg.decoder_rnn_dim
    for cell, names, cuts, bias in (
        (dec.attention_rnn, ("wa_p", "wa_c", "wa_h"), (P, E, H), "b_att"),
        (dec.decoder_rnn, ("wd_h", "wd_c", "wd_hd"), (H, E, Hd), "b_dec"),
    ):
        x = torch.randn(3, cell.input_size, generator=g)
        h = torch.randn(3, cell.hidden_size, generator=g)
        pieces = torch.cat([x, h], 1).split(cuts, dim=1)
        got = w[bias].clone()
        for name, piece in zip(names, pieces):
            seg, n = w[name], piece.shape[1]
            assert seg.shape == (cell.hidden_size, 4, -(-n // 8) * 8), name
            assert not seg[..., n:].any()
            # (units, gates, columns) -> gate-major rows, as the cell's
            got = got + torch.einsum("bi,ugi->bgu", piece,
                                     seg[..., :n]).reshape(3, -1)
        want = (x @ cell.weight_ih.T + h @ cell.weight_hh.T
                + cell.bias_ih + cell.bias_hh)
        torch.testing.assert_close(got, want)
    MR = dcfg.n_mel_channels * dcfg.n_frames_per_step
    ldh = -(-Hd // 8) * 8
    both = torch.cat([w["w_pg"][:, :Hd], w["w_pg"][:, ldh: ldh + E]], dim=1)
    assert torch.equal(both[:MR], dec.linear_projection.linear_layer.weight)
    assert torch.equal(both[MR:], dec.gate_layer.linear_layer.weight)
    assert not w["w_pg"][:, Hd:ldh].any()
    assert not w["w_pg"][:, ldh + E:].any()
    att = dec.attention_layer
    if hasattr(att, "ta"):
        assert torch.equal(w["w_ta"], att.ta.weight[0])
    else:
        assert not w["w_ta"].any()
    if ap.get("attention_type") == "LSA":
        assert float(w["v_b"][0]) == 0.0
        assert torch.equal(w["w_loc"], att.location_layer.conv_weight)


def test_prenet_masks_are_raw_zero_one():
    from msa_tts_tpu_torch.models.tacotron2nv import config_from_params

    dcfg = config_from_params(
        model_dict(p_prenet_dropout=0.3)).decoder_config()
    g = torch.Generator().manual_seed(0)
    m = CD.prenet_masks(dcfg, 400, 3, g, device="cpu")
    assert m.shape == (400, 2, 3, dcfg.prenet_dim)
    assert set(torch.unique(m).tolist()) <= {0.0, 1.0}
    assert abs(float(m.mean()) - 0.7) < 0.02
    again = CD.prenet_masks(dcfg, 400, 3, torch.Generator().manual_seed(0),
                            device="cpu")
    assert torch.equal(m, again)


def test_packed_params_cache_follows_the_weights():
    """The kernel's packed weights are kept per decoder between decodes
    and packed again when a weight changes in place or is reloaded."""
    from msa_tts_tpu_torch.models.decoder import Decoder
    from msa_tts_tpu_torch.models.tacotron2nv import config_from_params

    dcfg = config_from_params(model_dict()).decoder_config()
    dec = Decoder(dcfg, generator=torch.Generator().manual_seed(0))
    w = CD._packed_params(dec, dcfg)
    assert CD._packed_params(dec, dcfg) is w
    bias = dec.gate_layer.linear_layer.bias
    with torch.no_grad():
        bias += 1.0
    w2 = CD._packed_params(dec, dcfg)
    assert w2 is not w
    assert torch.equal(w2["b_pg"][-1:], bias)
    other = Decoder(dcfg, generator=torch.Generator().manual_seed(1))
    dec.load_state_dict(other.state_dict())
    w3 = CD._packed_params(dec, dcfg)
    assert w3 is not w2
    for k, v in CD.split_decoder_params(other, dcfg).items():
        assert torch.equal(w3[k], v), k
