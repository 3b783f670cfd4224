"""The port's WaveGlow (``msa_tts_tpu_torch/vocoders/waveglow.py``) at
tiny widths on the CPU, in float32: against NVIDIA's ``glow.py``
equations (``tests/waveglow_ref.py``), row by row and batched; the noise
layout; one flow inverted by hand; served through ``AdaptiveTTS``; its
spans and stamps."""

import numpy as np
import pytest
import torch

import waveglow_ref as REF
from msa_tts_tpu_torch.models.tacotron2nv import (Tacotron2NV,
                                                  config_from_params)
from msa_tts_tpu_torch.serving import AdaptiveTTS
from msa_tts_tpu_torch.utils.profiling import RECORDER
from msa_tts_tpu_torch.vocoders import waveglow as WG
from torch_parity import model_dict, one_torch_thread  # noqa: F401

# 6 flows, 2 channels out after flows 4 and 2 (the published model's 8
# and 4): 8, 6, then 4 channels go through the flows
CFG = {"n_flows": 6, "n_group": 8, "n_early_every": 2, "n_early_size": 2,
       "WN_config": {"n_layers": 2, "n_channels": 16, "kernel_size": 3}}
N_MEL = 8
RTOL = 1e-5


def tiny_waveglow(seed: int = 0, n_mel: int = N_MEL, end_gain: float = 3.0):
    """Seeded weights U(±1/√fan_in) (``end`` times ``end_gain``, so that
    every coupling moves the samples), invertible convolutions I +
    U(±0.3)."""
    model = WaveGlow_(n_mel)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            u = 2 * torch.rand(p.shape, generator=g) - 1
            if "convinv" in name:
                p.copy_(torch.eye(p.shape[0])[..., None] + 0.3 * u)
                continue
            fan_in = (p.shape[1] * p.shape[2] if p.dim() == 3 else 16)
            gain = end_gain if ".end." in name else 1.0
            p.copy_(gain * u / np.sqrt(fan_in))
    return model


def WaveGlow_(n_mel: int):
    return WG.WaveGlow(n_mel, **CFG)


def mels_and_noise(seed: int, frames, n_mel: int = N_MEL):
    g = torch.Generator().manual_seed(seed)
    mels = [torch.randn((n_mel, t), generator=g) for t in frames]
    noise = [torch.randn((CFG["n_group"], t * 32), generator=g)
             for t in frames]
    return mels, noise


def ref_wave(model, mel, noise, sigma=0.6):
    return REF.infer(model.state_dict(), CFG, mel, noise, sigma)


def rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


@pytest.fixture(scope="module")
def voc():
    return WG.WaveGlowVocoder(tiny_waveglow(), dtype="float32", device="cpu")


@pytest.mark.parametrize("frames", [[5], [4, 6, 3]], ids=["alone", "batch"])
def test_matches_nvidia_equations(voc, frames):
    mels, noise = mels_and_noise(1, frames)
    wavs = voc.infer_batch(mels, noise)
    for mel, z, w in zip(mels, noise, wavs):
        ref = ref_wave(voc.model, mel, z)
        assert w.shape == (mel.shape[1] * 256,)
        assert rel(w, ref) < RTOL
        # the couplings move the waveform: the noise alone is far off
        assert rel(0.6 * z.T.reshape(-1), ref) > 0.1


def test_batch_rows_equal_alone(voc):
    mels, noise = mels_and_noise(2, [3, 7, 5, 7])
    wavs = voc.infer_batch(mels, noise)
    for mel, z, w in zip(mels, noise, wavs):
        alone = voc.infer_batch([mel], [z])[0]
        torch.testing.assert_close(w, alone, rtol=1e-6, atol=1e-6)


def test_noise_layout(voc, monkeypatch):
    """The reverse pass starts from channels [0, 4), takes [4, 6) after
    flow 4 and [6, 8) after flow 2, each in front of the audio."""
    mels, noise = mels_and_noise(3, [2])
    seen = {}
    inner = voc.reverse_flow

    def record(k, audio, *a, **kw):
        seen[k] = audio.clone()
        return inner(k, audio, *a, **kw)

    monkeypatch.setattr(voc, "reverse_flow", record)
    voc.infer_batch(mels, noise, sigma=0.5)
    z = 0.5 * noise[0].T
    torch.testing.assert_close(seen[5][0], z[:, 0:4], rtol=0, atol=0)
    torch.testing.assert_close(seen[3][0, :, :2], z[:, 4:6], rtol=0, atol=0)
    torch.testing.assert_close(seen[1][0, :, :2], z[:, 6:8], rtol=0, atol=0)
    assert [x.shape[-1] for x in (seen[5], seen[3], seen[1])] == [4, 6, 8]


def test_noise_drawn_from_generator(voc):
    mels, _ = mels_and_noise(4, [3, 2])
    a = voc.infer_batch(mels, generator=torch.Generator().manual_seed(9))
    g = torch.Generator().manual_seed(9)
    z = [torch.randn((8, m.shape[1] * 32), generator=g) for m in mels]
    for x, y in zip(a, voc.infer_batch(mels, z)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    with pytest.raises(ValueError, match="noise"):
        voc.infer_batch(mels, [z[0][:, :10], z[1]])


@pytest.mark.parametrize("k", [0, 3, 5])
def test_one_flow_inverted_by_hand(voc, k):
    mels, _ = mels_and_noise(5, [4])
    spect = REF.upsample(voc.model.state_dict(), CFG, mels[0])
    torch.testing.assert_close(voc.upsample(mels[0][None]),
                               spect.transpose(1, 2), rtol=1e-6, atol=1e-6)
    C = voc.model.convinv[k].conv.weight.shape[0]
    x = torch.randn((1, C, spect.shape[2]),
                    generator=torch.Generator().manual_seed(k))
    y = REF.forward_flow(voc.model.state_dict(), CFG, k, x, spect)
    back = voc.reverse_flow(k, y.transpose(1, 2), spect.transpose(1, 2))
    torch.testing.assert_close(back, x.transpose(1, 2), rtol=1e-5, atol=1e-5)
    assert rel(y, x) > 0.1


def test_bfloat16_near_float32():
    model = tiny_waveglow(6)
    mels, noise = mels_and_noise(6, [4, 3])
    f32 = WG.WaveGlowVocoder(model, dtype="float32", device="cpu")
    bf16 = WG.WaveGlowVocoder(model, dtype="bfloat16", device="cpu")
    assert bf16.flows[0].cond_w[0].dtype == torch.bfloat16
    assert bf16.flows[0].w_inv.dtype == torch.float32
    for a, b in zip(f32.infer_batch(mels, noise), bf16.infer_batch(mels, noise)):
        assert b.dtype == torch.float32
        assert 1e-5 < rel(b, a) < 0.05


@pytest.fixture(scope="module")
def tts():
    """A tiny Tacotron 2 (10 mels, r = 2) whose rows all decode to the
    cap, with a tiny WaveGlow of 10 mels attached."""
    mp = model_dict(max_decoder_steps=6)
    torch.manual_seed(0)
    model = Tacotron2NV(config_from_params(mp))
    with torch.no_grad():
        model.decoder.gate_layer.linear_layer.bias.fill_(-1e4)
    ap = dict(sample_rate=22050, n_fft=1024, win_length=1024,
              hop_length=256, f_min=0.0, f_max=8000.0, n_mels=10,
              griffinlim_iters=4)
    t = AdaptiveTTS({"model": mp, "audio_params": ap}, model, device="cpu")
    t.attach_vocoder("waveglow", WG.WaveGlowVocoder(
        tiny_waveglow(7, n_mel=10), dtype="float32", device="cpu"))
    return t


EMB = np.linspace(-0.5, 0.5, 8).astype(np.float32)
TEXTS = ["hello there", "a second sentence"]


def test_synthesize_batch_waveglow(tts):
    mels = tts.synthesize_batch(TEXTS, vocoder="none", spk_emb=EMB, seed=3)
    noise = [torch.randn((8, m.shape[1] * 32),
                         generator=torch.Generator().manual_seed(i))
             for i, m in enumerate(mels)]
    wavs = tts.synthesize_batch(TEXTS, vocoder="waveglow", spk_emb=EMB,
                                seed=3, voc_noise=noise)
    one = tts.synthesize(TEXTS[0], vocoder="waveglow", spk_emb=EMB, seed=3,
                         voc_noise=noise[:1])
    voc = tts._attached("waveglow")
    for mel, z, w in zip(mels, noise, wavs):
        assert isinstance(w, np.ndarray) and w.shape == (mel.shape[1] * 256,)
        ref = ref_wave(voc.model, torch.from_numpy(mel), z)
        assert rel(torch.from_numpy(w), ref) < RTOL
    assert one.shape == wavs[0].shape


@pytest.mark.parametrize("name", ["hifigan", "waveglow", "wavernn"])
def test_unattached_vocoder_names_its_class(name):
    """An unattached name raises, naming itself and the call to make."""
    t = AdaptiveTTS.__new__(AdaptiveTTS)
    t._vocoders = {}
    with pytest.raises(ValueError,
                       match=rf"no vocoder '{name}': "
                             rf"attach_vocoder\('{name}', \.\.\.\) first"):
        t._attached(name)


@pytest.mark.parametrize("name", ["griffinlim", "hifigan", "waveglow",
                                  "wavernn"])
def test_vocoder_classes_are_the_ones_named(name):
    """Each vocoder class meets the seam and carries its name; WaveGlow
    alone is not streamed, and the two that come up a hop short say
    so."""
    from msa_tts_tpu_torch import vocoders
    from msa_tts_tpu_torch.vocoders import griffinlim, hifigan, wavernn

    cls = {"griffinlim": griffinlim.GriffinLim, "hifigan": hifigan.HiFiGAN,
           "waveglow": WG.WaveGlowVocoder, "wavernn": wavernn.WaveRNN}[name]
    assert all(hasattr(cls, a) for a in vocoders.SEAM), name
    assert cls.name == name
    assert cls.streams == (name != "waveglow")
    assert cls.tail_frames == (name in ("griffinlim", "wavernn"))


def test_stream_refuses_waveglow(tts):
    with pytest.raises(ValueError, match="waveglow.*not streamed"):
        next(iter(tts.synthesize_stream(TEXTS[0], vocoder="waveglow",
                                        spk_emb=EMB)))


def test_spans_and_stamps(tts, monkeypatch):
    marks = []
    inner = WG._mark
    monkeypatch.setattr(WG, "_mark", lambda d: marks.append(1) or inner(d))
    voc = tts._attached("waveglow")
    calls = voc.calls
    RECORDER.clear()
    tts.synthesize_batch(TEXTS, vocoder="waveglow", spk_emb=EMB, seed=1)
    # off: nothing recorded, no mark made
    assert RECORDER.spans == [] and RECORDER.stamps("waveglow") == []
    assert marks == [] and voc.calls == calls + 1
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        wavs = tts.synthesize_batch(TEXTS, vocoder="waveglow", spk_emb=EMB,
                                    seed=1)
    names = [s.name for s in RECORDER.spans]
    for n in ("tts.vocode.waveglow", "waveglow.upsample", "waveglow.flows"):
        assert names.count(n) == 1, (n, names)
    by = {s.name: s for s in RECORDER.spans}
    assert by["waveglow.flows"].parent == by["tts.vocode.waveglow"].sid
    (st,) = RECORDER.stamps("waveglow")
    assert len(marks) == CFG["n_flows"] + 2 == st.steps
    assert st.info == {"rows": 2, "positions": sum(len(w) for w in wavs) // 8}
    assert set(st.us) == {"upsample", "flows", "total",
                          *(f"flow.{k}" for k in range(CFG["n_flows"]))}
    assert st.us["total"] == pytest.approx(st.us["upsample"] + st.us["flows"])
    assert voc.calls == calls + 2
    RECORDER.clear()


def test_cpu_takes_the_eager_ops(voc, monkeypatch):
    """On the CPU the WN passes neither build nor load their library and
    launch nothing; the kernels' wrappers refuse CPU tensors."""
    from msa_tts_tpu_torch.kernels import build
    from msa_tts_tpu_torch.vocoders import cuda_wn as CW

    def refuse(*a, **kw):
        raise AssertionError("the WN library was asked for on the CPU")

    monkeypatch.setattr(build, "load", refuse)
    monkeypatch.setattr(CW, "_lib", refuse)
    mels, noise = mels_and_noise(8, [4, 6])
    wavs = voc.infer_batch(mels, noise)
    assert CW.WN_LAUNCHES == 0
    for mel, z, w in zip(mels, noise, wavs):
        assert rel(w, ref_wave(voc.model, mel, z)) < RTOL
    zc = torch.zeros((1, 3, 8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        CW.cuda_gate(zc, zc)
    with pytest.raises(ValueError, match="CUDA tensors"):
        CW.cuda_residual(zc, zc[..., :4].contiguous(), None)
    assert CW.WN_LAUNCHES == 0
