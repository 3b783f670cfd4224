"""The port's vocoder seam (``msa_tts_tpu_torch/vocoders/__init__.py``) on
the CPU at tiny widths: the spans ``synthesize`` and
``synthesize_batch`` record for each vocoder, and a vocoder defined only
in this file served through every entry point."""

import json
import urllib.request

import numpy as np
import pytest
import torch

from msa_tts_tpu_torch.models.tacotron2nv import Tacotron2NV, config_from_params
from msa_tts_tpu_torch.server import TTSServer
from msa_tts_tpu_torch.serving import AdaptiveTTS
from msa_tts_tpu_torch.stream_mux import StreamMultiplexer
from msa_tts_tpu_torch.utils.profiling import RECORDER
from msa_tts_tpu_torch.vocoders import hifigan as TH
from msa_tts_tpu_torch.vocoders import waveglow as WG
from msa_tts_tpu_torch.vocoders import wavernn as TW
from torch_parity import HIFIGAN_H, one_torch_thread  # noqa: F401

SPK = 6
HOP = 128
AP = dict(sample_rate=22050, n_fft=512, win_length=512, hop_length=HOP,
          f_min=0.0, f_max=8000.0, n_mels=20, griffinlim_iters=2)
MODEL = {
    "mask_padding": False, "n_mel_channels": 20, "n_frames_per_step": 2,
    "n_symbols": 200, "symbols_embedding_dim": 16,
    "encoder_n_convolutions": 2, "encoder_embedding_dim": 16,
    "encoder_kernel_size": 5, "speaker_emb_type": "static",
    "num_speakers": 1, "speaker_embedding_dim": SPK,
    "attention_rnn_dim": 20, "decoder_rnn_dim": 20, "prenet_dim": 12,
    "max_decoder_steps": 6, "gate_threshold": 0.9,
    "p_attention_dropout": 0.1, "p_decoder_dropout": 0.1,
    "decoder_no_early_stopping": True, "postnet_embedding_dim": 16,
    "postnet_kernel_size": 5, "postnet_n_convolutions": 2,
    "attention_params": {
        "attention_type": "ForwardAttention", "attention_dim": 16,
        "attention_location_n_filters": 8,
        "attention_location_kernel_size": 15,
    },
}
EMB = np.linspace(-0.5, 0.5, SPK).astype(np.float32)
TEXTS = ["hello world", "a second sentence"]
TIMEOUT = 60


class FrameMeans:
    """A vocoder known only to this file: each frame's mean over the mel
    bins, held for a hop.  It meets the seam with no base class."""

    name = "framemeans"
    tail_frames = 0
    streams = True

    def __init__(self):
        self.generators = []

    def to(self, device):
        self.device = torch.device(device)
        return self

    def vocode(self, mels, generator, *, phase=None, noise=None):
        self.generators.append(generator)
        return [m.mean(0).repeat_interleave(HOP) for m in mels]

    def stream_noise(self, seed, *, phase=None, noise=None):
        return lambda width: (torch.Generator().manual_seed(seed), None,
                              noise)


def frame_means(mel: np.ndarray) -> np.ndarray:
    return np.repeat(mel.mean(0), HOP)


@pytest.fixture(scope="module")
def tts():
    """A tiny Tacotron 2 whose rows decode to the cap, with a tiny
    WaveRNN, HiFi-GAN and WaveGlow attached besides Griffin-Lim."""
    model = Tacotron2NV(config_from_params(dict(MODEL)),
                        generator=torch.Generator().manual_seed(0))
    t = AdaptiveTTS({"model": dict(MODEL), "audio_params": dict(AP)}, model,
                    device="cpu")
    cfg = TW.WaveRNNConfig(mode="MOL", rnn_dims=16, fc_dims=16,
                           res_out_dims=8, compute_dims=8, n_mels=20,
                           res_blocks=1, hop_length=HOP, pad=2,
                           upsample_factors=(4, 4, 8))
    t.attach_vocoder("wavernn", TW.WaveRNN(
        TW.WaveRNNModel(cfg, torch.Generator().manual_seed(1)), cfg,
        gen_dtype=None))
    torch.manual_seed(2)
    t.attach_vocoder("hifigan", TH.HiFiGAN.from_params(
        TH.Generator(HIFIGAN_H, 20), HIFIGAN_H))
    wg = WG.WaveGlow(20, n_flows=2, n_group=8, n_early_every=4,
                     n_early_size=2,
                     WN_config={"n_layers": 2, "n_channels": 8,
                                "kernel_size": 3})
    t.attach_vocoder("waveglow", WG.WaveGlowVocoder(wg, dtype="float32",
                                                    device="cpu"))
    return t


@pytest.fixture(scope="module")
def framemeans(tts):
    voc = FrameMeans()
    tts.attach_vocoder("framemeans", voc)
    return voc


# the spans one call records, in the order they close, each with the span
# it opened inside; fixed on the tree before the seam
CALL = [("tts.g2p", None), ("tts.inputs", None), ("tts.encode", None),
        ("tts.decode", None), ("tts.postnet", None), ("tts.sync", None)]
VOCODE = {
    "griffinlim": [("tts.vocode.griffinlim", None), ("tts.to_host", None)],
    "wavernn": [("wavernn.condition", "tts.vocode.wavernn"),
                ("wavernn.fold", "tts.vocode.wavernn"),
                ("wavernn.loop", "tts.vocode.wavernn"),
                ("tts.to_host", "tts.vocode.wavernn"),
                ("wavernn.unfold", "tts.vocode.wavernn"),
                ("tts.vocode.wavernn", None)],
    "hifigan": [("tts.vocode.hifigan", None), ("tts.to_host", None)],
    "waveglow": [("waveglow.upsample", "tts.vocode.waveglow"),
                 ("waveglow.flows", "tts.vocode.waveglow"),
                 ("tts.vocode.waveglow", None), ("tts.to_host", None)],
    "none": [("tts.to_host", None)],
}


@pytest.mark.parametrize("entry", ["synthesize", "synthesize_batch"])
@pytest.mark.parametrize("vocoder", sorted(VOCODE))
def test_spans_of_a_call(tts, vocoder, entry):
    RECORDER.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        if entry == "synthesize":
            tts.synthesize(TEXTS[0], spk_emb=EMB, vocoder=vocoder, seed=1)
        else:
            tts.synthesize_batch(TEXTS, spk_emb=EMB, vocoder=vocoder, seed=1)
    names = {s.sid: s.name for s in RECORDER.spans}
    got = [(s.name, names.get(s.parent)) for s in RECORDER.spans]
    RECORDER.clear()
    assert got == CALL + VOCODE[vocoder]


def _synthesize(tts):
    return [tts.synthesize(TEXTS[0], spk_emb=EMB, vocoder="framemeans",
                           seed=3)]


def _synthesize_batch(tts):
    return tts.synthesize_batch(TEXTS, spk_emb=EMB, vocoder="framemeans",
                                seed=3)


def _synthesize_stream(tts):
    return [np.concatenate(list(tts.synthesize_stream(
        TEXTS[0], spk_emb=EMB, vocoder="framemeans", seed=3,
        segment_steps=2, chunk_frames=4, vocode_ctx_frames=0)))]


def _mux(tts):
    mux = StreamMultiplexer(tts, n_slots=1, t_cap=16, segment_steps=2,
                            chunk_frames=4, vocode_ctx_frames=0)
    try:
        return [np.concatenate(list(mux.stream(
            TEXTS[0], spk_emb=EMB, vocoder="framemeans", seed=3)))]
    finally:
        mux.close()


def _server(tts):
    server = TTSServer(tts, default_spk_emb=EMB, window_ms=1.0)
    assert "framemeans" in server.servable_vocoders()
    port = server.start()
    try:
        rq = urllib.request.Request(
            f"http://127.0.0.1:{port}/synthesize",
            data=json.dumps({"text": TEXTS[0],
                             "vocoder": "framemeans"}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(rq, timeout=TIMEOUT) as r:
            assert r.status == 200
            pcm = np.frombuffer(r.read()[44:], "<i2")
    finally:
        server.stop()
    return [pcm]


ENTRIES = {"synthesize": (_synthesize, 1, 3),
           "synthesize_batch": (_synthesize_batch, 2, 3),
           "synthesize_stream": (_synthesize_stream, 1, 3),
           "mux": (_mux, 1, 3),
           "server": (_server, 1, 0)}


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_a_vocoder_defined_here_is_served(tts, framemeans, entry):
    """Attached under a name the port does not know, the vocoder serves
    each entry point: every waveform is its function of the mel the
    same call gives with ``vocoder="none"``, and it is handed a
    generator."""
    fn, n, seed = ENTRIES[entry]
    calls = len(framemeans.generators)
    wavs = fn(tts)
    mels = tts.synthesize_batch(TEXTS[:n], spk_emb=EMB, vocoder="none",
                                seed=seed)
    assert len(wavs) == n and len(framemeans.generators) > calls
    assert all(isinstance(g, torch.Generator)
               for g in framemeans.generators[calls:])
    for w, m in zip(wavs, mels):
        want = frame_means(m)
        if entry == "server":
            want = (np.clip(want, -1, 1) * 32767.0).astype("<i2")
            np.testing.assert_allclose(w, want, atol=1, rtol=0)
        else:
            np.testing.assert_allclose(w, want, atol=1e-6, rtol=1e-5)
