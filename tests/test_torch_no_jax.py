"""The port imports neither jax nor the JAX package: in a fresh
interpreter where ``import jax`` and ``import msa_tts_tpu`` both fail,
every ``msa_tts_tpu_torch`` module imports (serving, stream_mux and
server among them), the tiny CPU slice runs from text to a wav file
(once more with ``infer_dtype: bfloat16``), one stream and one multiplexed stream run to their end, and an attached
WaveRNN and HiFi-GAN each vocode a request."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises
sys.modules["msa_tts_tpu"] = None  # and so does the JAX package

import numpy as np
import torch

import msa_tts_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    msa_tts_tpu_torch.__path__, "msa_tts_tpu_torch.")]
for name in names:
    importlib.import_module(name)

from msa_tts_tpu_torch.ops.audio import save_wav
from msa_tts_tpu_torch.models.tacotron2nv import Tacotron2NV, config_from_params
from msa_tts_tpu_torch.serving import N_SYMBOLS, AdaptiveTTS

ap = {"attention_type": "ForwardAttention", "attention_dim": 16,
      "attention_location_n_filters": 8,
      "attention_location_kernel_size": 15}
mp = {"n_mel_channels": 10, "n_frames_per_step": 2, "n_symbols": N_SYMBOLS,
      "symbols_embedding_dim": 16, "encoder_n_convolutions": 2,
      "encoder_embedding_dim": 16, "encoder_kernel_size": 5,
      "speaker_emb_type": "static", "speaker_embedding_dim": 8,
      "attention_rnn_dim": 20, "decoder_rnn_dim": 20, "prenet_dim": 12,
      "max_decoder_steps": 12, "gate_threshold": 0.5,
      "p_attention_dropout": 0.1, "p_decoder_dropout": 0.1,
      "decoder_no_early_stopping": True, "postnet_embedding_dim": 16,
      "postnet_kernel_size": 5, "postnet_n_convolutions": 2,
      "attention_params": ap}
audio = dict(sample_rate=22050, n_fft=512, win_length=512, hop_length=128,
             f_min=0.0, f_max=8000.0, n_mels=10, griffinlim_iters=2)
model = Tacotron2NV(config_from_params(mp),
                    generator=torch.Generator().manual_seed(0))
tts = AdaptiveTTS({"model": mp, "audio_params": audio}, model)
wav = tts.synthesize("hello world", spk_emb=np.zeros(8, np.float32))
assert wav.ndim == 1 and len(wav) > 0 and np.isfinite(wav).all()
save_wav(sys.argv[1], wav, audio["sample_rate"])
tts16 = AdaptiveTTS(
    {"model": mp, "audio_params": audio, "infer_dtype": "bfloat16"},
    Tacotron2NV(config_from_params(mp),
                generator=torch.Generator().manual_seed(0)))
wav16 = tts16.synthesize("hello world", spk_emb=np.zeros(8, np.float32))
assert wav16.dtype == np.float32 and wav16.shape == wav.shape
assert np.isfinite(wav16).all()

from msa_tts_tpu_torch import server, stream_mux
assert {"msa_tts_tpu_torch.serving", "msa_tts_tpu_torch.stream_mux",
        "msa_tts_tpu_torch.server"} <= set(names)
emb = np.zeros(8, np.float32)
solo = np.concatenate(list(tts.synthesize_stream(
    "hello world", spk_emb=emb, segment_steps=5, text_pad_multiple=16)))
mux = stream_mux.StreamMultiplexer(tts, n_slots=2, t_cap=16,
                                   segment_steps=5)
try:
    muxed = np.concatenate(list(mux.stream("hello world", spk_emb=emb)))
finally:
    mux.close()
assert solo.shape == muxed.shape and len(solo) > 0
assert np.isfinite(muxed).all()
assert server.TTSServer(tts, default_spk_emb=emb).servable_vocoders()
from msa_tts_tpu_torch.vocoders.hifigan import Generator, HiFiGAN
from msa_tts_tpu_torch.vocoders.wavernn import WaveRNN, WaveRNNConfig
wcfg = WaveRNNConfig(rnn_dims=16, fc_dims=16, res_out_dims=8,
                     compute_dims=8, n_mels=10, res_blocks=1,
                     hop_length=128, upsample_factors=(4, 4, 8))
tts.attach_vocoder("wavernn", WaveRNN(
    cfg=wcfg, generator=torch.Generator().manual_seed(1), device="cpu"))
h = dict(resblock="2", upsample_rates=[8, 16], upsample_kernel_sizes=[16, 32],
         upsample_initial_channel=8, resblock_kernel_sizes=[3],
         resblock_dilation_sizes=[[1, 3]])
tts.attach_vocoder("hifigan", HiFiGAN.from_params(
    Generator(h, 10, torch.Generator().manual_seed(2)), h))
n_frames = 12 * 2
for voc, want in (("wavernn", (n_frames - 1) * 128), ("hifigan", n_frames * 128)):
    w = tts.synthesize("hello world", spk_emb=emb, vocoder=voc)
    assert w.shape == (want,) and np.isfinite(w).all(), (voc, w.shape)
assert server.TTSServer(tts, default_spk_emb=emb).servable_vocoders() == {
    "griffinlim", "wavernn", "hifigan"}
for blocked in ("jax", "msa_tts_tpu"):
    bad = sorted(m for m in sys.modules
                 if m == blocked or m.startswith(blocked + "."))
    assert bad == [blocked], bad       # only the blocked placeholder
print("modules", len(names))
"""


def test_port_imports_and_runs_without_jax(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "MSA_PLATFORM"}
    env["PYTHONPATH"] = REPO
    out = tmp_path / "hello.wav"
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(out)], capture_output=True,
        text=True, timeout=300, env=env, cwd=str(tmp_path),
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert "modules" in res.stdout
    assert out.stat().st_size > 44
