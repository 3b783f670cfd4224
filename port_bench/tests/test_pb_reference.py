"""The reference against the port's plain path at tiny widths, in
float32 (the same function up to summation order) and in bfloat16."""

import numpy as np
import pytest
import torch

import inputs
import tiny
import weights as W
from reference import hifigan as RH
from reference import tacotron2 as RT
from reference import wavernn as RW
from reference.g2p import phoneme_ids
from reference.precision import Precision
from traffic import text

SEED = 2 ** 35 + 3


def port_model(cfg, sd, dtype=torch.float32):
    from msa_tts_tpu_torch.models.tacotron2nv import (Tacotron2NV,
                                                      config_from_params)
    with torch.device("meta"):
        m = Tacotron2NV(config_from_params(W.model_params(cfg)))
    m.load_state_dict(sd, strict=True, assign=True)
    return m.to(dtype).eval()


def test_g2p_matches_the_port_rules():
    from msa_tts_tpu_torch.utils.g2p import Grapheme2Phoneme

    g = Grapheme2Phoneme(backend="fallback")
    p = {"median": 80, "sigma": 0.45, "min": 20, "max": 190, "block": 16}
    for s in text.sentences(p, SEED, 16):
        assert phoneme_ids(s) == g.convert(
            s, convert_mode="text_to_phone_to_idx")[0]


@pytest.mark.parametrize("name", ["msa_t2nv_fa_r2", "t2nv_lsa_r1"])
@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5),
                                        ("bfloat16", 5e-2)])
def test_mels_against_the_port(name, dtype, atol):
    from msa_tts_tpu_torch.models.tacotron2nv import tacotron2nv_infer

    cfg = tiny.config(name)
    sd = W.all_weights(cfg, SEED, "cpu")["tacotron"]
    ids = [phoneme_ids(s) for s in text.sentences(
        {"median": 12, "sigma": 0.4, "min": 6, "max": 20, "block": 3},
        SEED, 3)]
    spk = torch.as_tensor(np.stack([inputs.speaker_vector(cfg, SEED)] * 3))
    masks = inputs.prenet_masks(cfg, 5, 3, "cpu")
    ref, frames = RT.synthesize_mels(Precision(dtype), sd, W.model_params(cfg),
                                     ids, spk, masks)
    T = max(map(len, ids))
    inp = torch.zeros(3, T, dtype=torch.int64)
    for i, s in enumerate(ids):
        inp[i, : len(s)] = torch.as_tensor(s)
    model = port_model(cfg, sd, getattr(torch, dtype))
    cfg_p = model.cfg._replace(attention_params=dict(
        model.cfg.attention_params, mask_energies=True))
    mel, mel_len, _ = tacotron2nv_infer(
        model, cfg_p, inp, torch.as_tensor([len(s) for s in ids]), spk,
        masks, mask_pad=True, decode_backend="torch")
    S = cfg["model"]["max_decoder_steps"]
    assert mel_len.tolist() == [S] * 3
    assert frames == [S * cfg["model"]["n_frames_per_step"]] * 3
    err = float((mel - ref).abs().max())
    print("max|d|", err, "mean|ref|", float(ref.abs().mean()))
    assert err <= atol, err
    assert float(ref.abs().mean()) > 5 * atol


def test_hifigan_against_the_port():
    from msa_tts_tpu_torch.vocoders.hifigan import Generator, generator_apply

    cfg = tiny.config("t2nv_lsa_r1")
    h = cfg["vocoders"]["hifigan"]
    sd = W.all_weights(cfg, SEED, "cpu")["hifigan"]
    with torch.device("meta"):
        gen = Generator(h, 80)
    gen.load_state_dict(sd, strict=True, assign=True)
    mel = 0.3 * torch.randn(2, 80, 12, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a = generator_apply(gen, h, mel)
        b = RH.generate(Precision("float32"), sd, h, mel)
    assert float((a - b).abs().max()) < 1e-5
    assert 0.05 < float(b.std()) < 0.9


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4), ("bfloat16", 3e-2)])
def test_wavernn_against_the_port(dtype, atol):
    from msa_tts_tpu_torch.vocoders.wavernn import (WaveRNN, WaveRNNConfig,
                                                    WaveRNNModel)

    cfg = tiny.config("msa_t2nv_fa_r2")
    v = cfg["vocoders"]["wavernn"]
    sd = W.all_weights(cfg, SEED, "cpu")["wavernn"]
    wcfg = WaveRNNConfig(rnn_dims=v["rnn_dims"], fc_dims=v["fc_dims"],
                         compute_dims=v["compute_dims"],
                         res_out_dims=v["res_out_dims"],
                         res_blocks=v["res_blocks"])
    with torch.device("meta"):
        wm = WaveRNNModel(wcfg)
    wm.load_state_dict(sd, strict=True, assign=True)
    voc = WaveRNN(wm, wcfg, gen_dtype=dtype, device="cpu")
    g = torch.Generator().manual_seed(2)
    mels = [0.3 * torch.randn(80, 9, generator=g) - 1.0 for _ in range(2)]
    _, n_pad = inputs.fold_rows(32, 256, v["target"], v["overlap"])
    L = v["target"] + 2 * v["overlap"]
    noises = [inputs.wavernn_noise(s, L, n_pad, "cpu", pinned=True)
              for s in (3, 4)]
    got = voc.generate_batch(mels, noises=noises, verbose=False)
    ref = RW.generate(Precision(dtype), sd, v, mels, noises)
    for a, b in zip(got, ref):
        assert len(a) == len(b) == 8 * 256
        assert float(np.abs(a - b).max()) < atol
