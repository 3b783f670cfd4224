"""The port's continual-stream inference CLI
(``msa_tts_tpu_torch/infer_cumulative.py``) against the JAX package's
(``msa_tts_tpu/infer_cumulative.py``): a stream of two speakers whose
``best_{i}_{speaker}.ckpt`` files are written by the JAX package's
checkpoint writer from seeded ``init_tacotron2nv`` weights (a seed per
task), read by both; three sentences, so each speaker's batch is B = 3
rows padded to a multiple of 16 phonemes.

The JAX package decodes every batch under ``PRNGKey(0)``; the port takes
those prenet masks injected.  As in ``test_torch_infer.py`` the
checkpoints' gate bias is -30 and the margin is checked (``sigmoid(gate)``
below 1e-6 at every step of the port's decodes), so every row runs its 17
steps and the lengths are compared exactly.  Mels at the plain decoder's
tolerance (``test_torch_model.py``, 5e-5; read 5.5e-7).

One case makes the rows of a batch stop at different steps (seed 11,
gate weight x20, bias +2: the first speaker's four rows stop at step 0,
the second's at four different steps).  There the margin is
``sigmoid(gate)`` at least 1e-3 from ``gate_threshold`` at every step a
row ran (read 4.5e-3), and each row's cut of the mel (``max(len * r,
r)`` frames) is compared.
"""

import glob
import os

import jax
import numpy as np
import pytest
import torch

from msa_tts_tpu import infer_cumulative as JIC
from msa_tts_tpu.models.pallas_decoder import _prenet_masks
from msa_tts_tpu_torch import infer_cumulative as TIC
from msa_tts_tpu_torch.models import tacotron2nv as TT
from test_torch_infer import write_jax_checkpoint
from torch_parity import (
    one_torch_thread,  # noqa: F401  (an autouse fixture)
    tiny_corpus,
    tiny_train_params,
)

MEL_ATOL, GATE_MARGIN, STOP_MARGIN = 5e-5, 1e-6, 1e-3
SENTS = "hello there\ngood morning to you all\nhi\n"


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return tiny_corpus(str(tmp_path_factory.mktemp("cum_corpus")))


def _params(corpus, out, sents, **over):
    p = tiny_train_params(corpus, str(out), "continual_er", speaker_seed=5,
                          num_initial_speakers=0)
    p.update(spk_emb_path=os.path.join(corpus, "spk_emb.pkl"),
             input_text_file=sents, vocoder="griffinlim",
             checkpoint_id="all", device="cpu")
    p.update(over)
    return p


def _stream_checkpoints(params):
    """``best_{i}_{speaker}`` for the stream's order (speaker_seed 5),
    task i from seed 10 + i; returns the JAX config."""
    import random

    order = list(params["dataset_train"]["speakers_list"])
    random.Random(params["speaker_seed"]).shuffle(order)
    for i, spk in enumerate(order):
        jcfg = write_jax_checkpoint(params, f"best_{i}_{spk}", seed=10 + i)
    return jcfg


class FromJax(TIC.InferCumulative):
    jcfg = None

    def _prenet_masks(self, B):
        dcfg = self.jcfg.decoder_config()
        key = jax.random.fold_in(jax.random.PRNGKey(0), 2)
        return torch.as_tensor(np.array(_prenet_masks(
            dcfg, key, dcfg.max_decoder_steps, B)))


@pytest.fixture(scope="module")
def runs(corpus, tmp_path_factory):
    base = tmp_path_factory.mktemp("cum_runs")
    sents = str(base / "sents.txt")
    with open(sents, "w") as f:
        f.write(SENTS)
    jp, tp = (_params(corpus, base / side, sents) for side in ("jax", "port"))
    jcfg = _stream_checkpoints(jp)
    _stream_checkpoints(tp)

    jseen = []
    jic = JIC.InferCumulative(**jp)
    jit = jic._infer_jit

    def infer_jit(*a):
        out = jit(*a)
        jseen.append(jax.device_get((a[2:5], out[:2])))
        return out

    jic._infer_jit = infer_jit
    jic.run()

    tseen, gates = [], []
    FromJax.jcfg = jcfg
    tic = FromJax(**tp)
    batch = tic._infer_batch

    def infer_batch(*a):
        out = batch(*a)
        tseen.append((a, (out[0].numpy(), out[1])))
        return out

    dec = TT.decoder_infer

    def decoder_infer(*a, **k):
        out = dec(*a, **k)
        gates.append(out[1])
        return out

    tic._infer_batch, TT.decoder_infer = infer_batch, decoder_infer
    try:
        tic.run()
    finally:
        TT.decoder_infer = dec
    return (jic, jseen), (tic, tseen, gates)


def test_batches_mels_and_lengths_match_jax(runs):
    """Each (checkpoint, target speaker) batch: the padded phoneme ids,
    lengths and speaker rows equal JAX's, the mels and lengths agree."""
    (jic, jseen), (tic, tseen, gates) = runs
    assert tic.all_speakers == jic.all_speakers
    # task 0: one speaker so far; task 1: two
    assert len(jseen) == len(tseen) == len(gates) == 3
    assert max(float(torch.sigmoid(g).max()) for g in gates) < GATE_MARGIN
    for ((ji, jl, js), (jm, jlen)), ((ti, tl, ts), (tm, tlen)) in zip(
            jseen, tseen):
        assert ti.shape == (3, 32) and ti.shape[1] % 16 == 0
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_array_equal(tlen, jlen)
        assert (tlen == 17).all()
        np.testing.assert_allclose(tm, jm, atol=MEL_ATOL, rtol=0)
    # other checkpoints, other mels
    assert np.abs(tseen[0][1][0] - tseen[1][1][0]).max() > 1e-3


def test_wavs_written_under_the_same_names(runs):
    (jic, _), (tic, _, _) = runs

    def names(ic):
        return sorted(os.path.basename(f) for f in glob.glob(
            os.path.join(ic.path_manager.inference_path, "*.wav")))

    # task 0: 1 speaker x 3 sentences; task 1: 2 x 3
    assert names(tic) == names(jic) and len(names(tic)) == 9
    assert [(t["step"], t["speaker"]) for t in tic.timings] == [
        (0, tic.all_speakers[0]), (1, tic.all_speakers[0]),
        (1, tic.all_speakers[1])]


def test_wavernn_and_joint_checkpoint(corpus, tmp_path):
    """``joint_training``: one ``checkpoint_{id}`` for every speaker, in
    the corpus order; the sentences vocoded by a tiny WaveRNN in one
    ``generate_batch`` call (the plain sample loop on the CPU)."""
    from msa_tts_tpu_torch.vocoders import wavernn as TW

    sents = str(tmp_path / "sents.txt")
    with open(sents, "w") as f:
        f.write(SENTS)
    p = _params(corpus, tmp_path / "out", sents, joint_training=True,
                checkpoint_id=3, vocoder="wavernn")
    write_jax_checkpoint(p, "checkpoint_3")
    hop = p["audio_params"]["hop_length"]
    cfg = TW.WaveRNNConfig(mode="MOL", n_mels=10, rnn_dims=16, fc_dims=16,
                           compute_dims=8, res_out_dims=8, res_blocks=1,
                           hop_length=hop, pad=2,
                           upsample_factors=(4, 8, hop // 32))
    voc = TW.WaveRNN(cfg=cfg, gen_dtype=None, device="cpu")
    calls = []
    gb = voc.generate_batch

    def generate_batch(mels, **kw):
        calls.append(len(mels))
        return gb(mels, **kw)

    voc.generate_batch = generate_batch
    ic = TIC.InferCumulative(**p)
    ic._load_vocoder = lambda: ("wavernn", voc,
                                {"target": 400, "overlap": 100}, None)
    ic.run()
    assert ic.all_speakers == ["spk00", "spk01"]
    assert calls == [3, 3]
    wavs = sorted(glob.glob(os.path.join(ic.path_manager.inference_path,
                                         "*.wav")))
    assert [os.path.basename(w) for w in wavs] == [
        f"0_spk00_to_{s}_sent{i}.wav" for s in ("spk00", "spk01")
        for i in range(3)]
    from msa_tts_tpu_torch.ops.audio import load_wav

    for w in wavs:
        x = load_wav(w)
        assert x.size > hop and np.isfinite(x).all()
        assert np.abs(x).max() <= 1.0


def test_rows_stop_at_different_steps(corpus, tmp_path, monkeypatch):
    """One ``checkpoint_{id}`` whose gate fires at different steps in
    different rows of a B = 4 batch: both sides hand Griffin-Lim the same
    per-row cuts of the mel, and the lengths are equal."""
    sents = str(tmp_path / "sents.txt")
    with open(sents, "w") as f:
        f.write(SENTS + "how are you today\n")
    jp, tp = (_params(corpus, tmp_path / side, sents, joint_training=True,
                      checkpoint_id=3) for side in ("jax", "port"))
    for p in (jp, tp):
        jcfg = write_jax_checkpoint(p, "checkpoint_3", seed=11,
                                    gate_bias=2.0, gate_scale=20.0)
    cuts = {"jax": [], "port": []}

    def recording(side, fn):
        def griffinlim(mel, audio_params):
            cuts[side].append(np.asarray(mel))
            return fn(mel, audio_params)
        return griffinlim

    monkeypatch.setattr(JIC, "griffinlim_logmelspec",
                        recording("jax", JIC.griffinlim_logmelspec))
    monkeypatch.setattr(TIC, "griffinlim_logmelspec",
                        recording("port", TIC.griffinlim_logmelspec))
    decodes = []
    dec = TT.decoder_infer

    def decoder_infer(*a, **k):
        out = dec(*a, **k)
        decodes.append((out[1], out[3]))
        return out

    monkeypatch.setattr(TT, "decoder_infer", decoder_infer)
    JIC.InferCumulative(**jp).run()
    FromJax.jcfg = jcfg
    FromJax(**tp).run()

    r = tp["model"]["n_frames_per_step"]
    thr = tp["model"]["gate_threshold"]
    lengths = []
    for gates, lens in decodes:
        step_gates = torch.sigmoid(gates[:, ::r])
        for row, n in enumerate(lens.tolist()):
            ran = step_gates[row, : n + 1]
            assert float((ran - thr).abs().min()) > STOP_MARGIN
            lengths.append(n)
    assert len(decodes) == 2 and lengths[:4] == [0] * 4
    assert len(set(lengths[4:])) == 4 and max(lengths) < 17
    assert len(cuts["port"]) == len(cuts["jax"]) == 8
    for tm, jm, n in zip(cuts["port"], cuts["jax"], lengths):
        assert tm.shape == jm.shape == (jm.shape[0], max(n * r, r))
        np.testing.assert_allclose(tm, jm, atol=MEL_ATOL, rtol=0)


def test_loads_onto_the_card_by_default(corpus, tmp_path):
    """Without ``device`` the CLI loads onto the GPU, and raises where
    there is none (``device: cpu`` asks for the CPU); ``decode_backend:
    cuda`` on the CPU raises at once."""
    p = _params(corpus, tmp_path / "out", str(tmp_path / "s.txt"))
    p.pop("device")
    if torch.cuda.is_available():
        assert TIC.InferCumulative(**p).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            TIC.InferCumulative(**p)
    with pytest.raises(ValueError, match="backend"):
        TIC.InferCumulative(**dict(p, device="cpu", decode_backend="cuda"))
