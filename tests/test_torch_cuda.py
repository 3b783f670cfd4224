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
