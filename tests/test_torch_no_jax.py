"""The port imports neither jax nor the JAX package: in a fresh
interpreter where ``import jax`` and ``import msa_tts_tpu`` both fail,
every ``msa_tts_tpu_torch`` module imports (serving, stream_mux and
server among them), the tiny CPU slice runs from text to a wav file
(once more with ``infer_dtype: bfloat16``), a voice is adapted from two
clips, saved, loaded and served, one stream and one multiplexed stream
run to their end, an attached WaveRNN and HiFi-GAN each vocode a
request, the MAML trainer takes two second-order steps on a synthetic
corpus and its checkpoint serves, the joint trainer, Reptile and an
EWC stream of two speakers run there, the WaveRNN and HiFi-GAN
trainers each take two steps and write their checkpoints, the inference
CLI adapts to a speaker from the MAML checkpoint and writes its wav, the
landscape, speaker-classifier and profiling utilities run, and two gloo
ranks (``parallel/launch.py``), each blocking both imports first thing,
take one data-parallel joint step of the tiny model and one
tensor-parallel one (``tp: 2``), and agree."""

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

clips = []
for i, n in enumerate((6000, 8000)):
    t = np.arange(n) / audio["sample_rate"]
    clips.append(f"clip{i}.wav")
    save_wav(clips[-1], 0.5 * np.sin(2 * np.pi * (150 + 60 * i) * t),
             audio["sample_rate"])
phones = [tts.g2p.text_to_phone(t) for t in ("hello", "good morning")]
voice = tts.adapt(clips, phones, np.zeros(8, np.float32), seed=1)
assert np.isfinite(voice.support_loss)
tts.save_voice(voice, "adapted.voice")
loaded = tts.load_voice("adapted.voice")
assert all(torch.equal(loaded.state_dict[k], v.cpu())
           for k, v in voice.state_dict.items())
assert np.array_equal(tts.synthesize("hello", loaded, seed=3),
                      tts.synthesize("hello", voice, seed=3))

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
from msa_tts_tpu_torch.dataloaders.synthetic import (
    make_synthetic_corpus, synthetic_params)
from msa_tts_tpu_torch.trainers.maml import MAML
make_synthetic_corpus("corpus", n_speakers=2, utterances_per_speaker=4,
                      min_dur=0.2, max_dur=0.3, spk_emb_dim=8)
mp = dict(mp, mask_padding=True)
params = synthetic_params("corpus", n_speakers=2, batch_size=2,
                          model_overrides=mp)
params.update(method="maml", output_path="out", device="cpu", n_epochs=2,
              audio_params=dict(audio, hop_length=256, n_fft=1024,
                                win_length=1024),
              use_tensorboard=False, plot_examples=False, n_inner_test=1,
              metatest_epoch_interval=2)
trainer = MAML(**params)
trainer.run()
assert trainer.step_global == 2
served = AdaptiveTTS.from_experiment("out/maml/synthetic", device="cpu")
assert np.isfinite(served.synthesize("hello", spk_emb=emb)).all()
from msa_tts_tpu_torch.trainers.baseline import JointTrainer
from msa_tts_tpu_torch.trainers.continual_ewc import EWCTrainer
from msa_tts_tpu_torch.trainers.reptile import Reptile
joint = JointTrainer(**dict(params, method="baseline", n_epochs=1))
joint.run()
assert joint.step_global > 0 and np.isfinite(joint.best_test_loss)
rep = Reptile(**dict(params, method="reptile", n_epochs=1,
                     reptile_mode="batched"))
rep.run()
assert rep.step_global == 2
ewc = EWCTrainer(**dict(params, method="continual_ewc", n_max_epochs=1,
                        buffer_sample_size=2, ewc_importance=10.0))
ewc.run()
assert ewc._ewc is not None and len(ewc.cumutest_dict) == 2
from msa_tts_tpu_torch.trainers.hifigan_train import HiFiGANTrainer
from msa_tts_tpu_torch.trainers.wavernn_train import WaveRNNTrainer
voc = dict(params, method="wavernn", n_steps=2, batch_size=2, seq_len=512,
           rnn_dims=16, fc_dims=16, compute_dims=8, res_out_dims=8,
           res_blocks=1, pad=2, upsample_factors=(4, 8, 8), lr=1e-3)
wt = WaveRNNTrainer(**voc)
assert np.isfinite(wt.run()) and wt.step_global == 2
hg = HiFiGANTrainer(**dict(
    voc, method="hifigan", audio_processor="ap2", hifigan=h,
    segment_size=1024, batch_size=1,
    audio_params={"n_fft": 512, "hop_size": 128, "win_size": 512,
                  "n_mels": 10, "sample_rate": 22050, "fmin": 0.0,
                  "fmax": 8000.0}))
assert all(np.isfinite(v) for v in hg.run().values()) and hg.step_global == 2
import glob
assert len(glob.glob("out/*/synthetic/checkpoints/*_2.ckpt")) == 2
new = {"infer", "infer_cumulative", "analysis.landscapes", "utils.spk_cls",
       "utils.profiling", "utils.limit_threads", "data_processing.common",
       "data_processing.convert_gt", "data_processing.prepare_comvoice",
       "data_processing.prepare_css10", "data_processing.prepare_ljspeech",
       "data_processing.prepare_vctk"}
assert {"msa_tts_tpu_torch." + n for n in new} <= set(names)
from msa_tts_tpu_torch import infer
from msa_tts_tpu_torch.analysis import landscapes
from msa_tts_tpu_torch.utils import profiling, spk_cls
inf = infer.main({"params_path": "out/maml/synthetic", "checkpoint_id": 0,
                  "speaker": "spk01", "input_text": "hello",
                  "spk_emb_path": "corpus/spk_emb.pkl", "device": "cpu"})
assert [t["speaker"] for t in inf.timings] == ["spk01"]
assert glob.glob("out/maml/synthetic/inference/spk01_hello_ckpt0.wav")
surf = landscapes.random_plane(lambda p: (p["w"] ** 2).sum(),
                               {"w": torch.ones(3)}, distance=1.0, steps=3)
assert surf.shape == (3, 3) and surf[1, 1] == 3.0
x = np.eye(4, dtype=np.float32).repeat(3, 0)
_, accs = spk_cls.train_classifier(x, np.arange(4).repeat(3), 4,
                                   hidden_size=8, n_epochs=2, device="cpu")
assert len(accs) == 2
with profiling.trace("trace", device="cpu"):
    with profiling.annotate("add"):
        torch.ones(2).add_(1)
assert glob.glob("trace/*")
import os
from msa_tts_tpu_torch.parallel.launch import spawn
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    msa_tts_tpu_torch.__file__)), "tests"))
import torch_parallel_ranks
os.makedirs("par")
torch.save({"model": mp, "sd": model.state_dict()}, "par/model.pt")
spawn(torch_parallel_ranks.joint_step_no_jax, 2, "par", store="par/store")
p0, p1 = (torch.load(f"par/rank{r}.pt") for r in (0, 1))
assert all(torch.equal(p0[k], p1[k]) for k in p0)
assert not all(torch.equal(p0[k], model.state_dict()[k]) for k in p0)
t0, t1 = (torch.load(f"par/rank{r}_tp.pt") for r in (0, 1))
assert all(torch.equal(t0[k], t1[k]) for k in t0)
assert all(torch.allclose(t0[k], p0[k], atol=3e-5) for k in t0)
for blocked in ("jax", "msa_tts_tpu"):
    bad = sorted(m for m in sys.modules
                 if m == blocked or m.startswith(blocked + "."))
    assert bad == [blocked], bad       # only the blocked placeholder
print("modules", len(names))
"""


def test_port_imports_and_runs_without_jax(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "MSA_PLATFORM"}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"     # tiny ops; workers run side by side
    out = tmp_path / "hello.wav"
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(out)], capture_output=True,
        text=True, timeout=300, env=env, cwd=str(tmp_path),
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert "modules" in res.stdout
    assert out.stat().st_size > 44
