"""The port's meta-learning data path against the JAX package's on a tiny
synthetic corpus: the corpus files (``make_synthetic_corpus``),
``parse_metafile`` / ``split_speakers`` / ``load_speaker_embeddings`` /
``resolve_audio_path``, ``TTSDataset`` (phonemes, speakers, log-mels)
and ``MetaDataLoader``'s stacked episodes over two epochs, before and
after ``skip_epoch``.

Everything is held byte for byte: the log-mels of each package's numpy
path, and of each package's host C++ feature library (``native/
feats.cpp``, the same source in both).  The two paths are held to each
other at 3e-5 absolute, on log10-mels of up to 4.6 (read 8.1e-6: the
library sums in other orders; where it does not build, both packages
fall back to their numpy paths and the two are equal)."""

import os
import pickle

import numpy as np
import pytest

from msa_tts_tpu.dataloaders import dataset as JD
from msa_tts_tpu.dataloaders import loader_meta as JL
from msa_tts_tpu.dataloaders import metafile as JM
from msa_tts_tpu.dataloaders.synthetic import (
    make_synthetic_corpus as jax_corpus,
)
from msa_tts_tpu.dataloaders.synthetic import synthetic_params as jax_params
from msa_tts_tpu_torch.dataloaders import dataset as TD
from msa_tts_tpu_torch.dataloaders import loader_meta as TL
from msa_tts_tpu_torch.dataloaders import metafile as TM
from msa_tts_tpu_torch.dataloaders.synthetic import (
    make_synthetic_corpus,
    synthetic_params,
)
from torch_parity import one_torch_thread  # noqa: F401  (an autouse fixture)

NATIVE_ATOL = 3e-5
CORPUS = dict(n_speakers=3, utterances_per_speaker=5, min_dur=0.25,
              max_dur=0.5, seed=3)


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = tmp_path_factory.mktemp("meta_data")
    jroot, troot = str(root / "jax"), str(root / "port")
    return jax_corpus(jroot, **CORPUS), make_synthetic_corpus(troot, **CORPUS)


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


def test_synthetic_corpus_is_byte_identical(corpora):
    jmeta, tmeta = corpora
    jf, tf = _files(os.path.dirname(jmeta)), _files(os.path.dirname(tmeta))
    assert sorted(jf) == sorted(tf)
    assert sum(n.endswith(".wav") for n in tf) == 15
    for name in jf:
        assert jf[name] == tf[name], name
    j = synthetic_params("/x", n_speakers=3, batch_size=2)
    assert j == jax_params("/x", n_speakers=3, batch_size=2)


def _split_args():
    return dict(total_duration_per_spk=0.03, perc_train=0.6, seed=5)


def test_metafile_and_split_match_jax(corpora):
    jmeta, tmeta = corpora
    ju, tu = JM.parse_metafile(jmeta), TM.parse_metafile(tmeta)
    assert [vars(u) for u in ju] == [vars(u) for u in tu]
    speakers = ["spk02", "spk00", "spk01"]
    for kw in (_split_args(), dict(perc_train=0.8, seed=0)):
        (js, jlog), (ts, tlog) = (JM.split_speakers(ju, speakers, **kw),
                                  TM.split_speakers(tu, speakers, **kw))
        assert jlog == tlog
        assert list(js) == list(ts) == speakers
        for s in speakers:
            for mode in ("train", "test"):
                assert ([vars(u) for u in getattr(js[s], mode)]
                        == [vars(u) for u in getattr(ts[s], mode)])
    root = os.path.dirname(tmeta)
    je, te = (JM.load_speaker_embeddings(os.path.dirname(jmeta)),
              TM.load_speaker_embeddings(root))
    assert list(je) == list(te)
    for k in je:
        assert je[k].tobytes() == te[k].tobytes()
    for args in ((root, "wavs", "spk01", "a.wav", 3), (root, "", "s", "b.wav",
                                                       1)):
        assert JM.resolve_audio_path(*args) == TM.resolve_audio_path(*args)


AP = dict(sample_rate=22050, n_fft=1024, win_length=1024, hop_length=256,
          f_min=0.0, f_max=8000.0, n_mels=20)


def _datasets(meta, pkg_m, pkg_d, trim, **kw):
    utts = pkg_m.parse_metafile(meta)
    splits, _ = pkg_m.split_speakers(utts, ["spk00", "spk01", "spk02"],
                                     perc_train=0.6, seed=1)
    common = dict(dataset_path=os.path.dirname(meta), audio_params=AP,
                  trim_margin_silence=trim, ref_level_db=20, **kw)
    return (pkg_d.TTSDataset(splits, "train", **common),
            pkg_d.TTSDataset(splits, "test", **common))


@pytest.mark.parametrize("trim", [False, True], ids=["untrimmed", "trimmed"])
def test_dataset_matches_jax(corpora, trim):
    """Phonemes, speakers and their ids exactly; the log-mels (of the
    silence-trimmed clips in the second case) equal to the JAX package's
    numpy path, the port's library features (its default) equal to the
JAX package's, and the two paths within NATIVE_ATOL of each other."""
    jmeta, tmeta = corpora
    ports = _datasets(tmeta, TM, TD, trim, use_native_feats=False)
    refs = _datasets(jmeta, JM, JD, trim, use_native_feats=False)
    natives = _datasets(jmeta, JM, JD, trim)
    port_natives = _datasets(tmeta, TM, TD, trim)
    for pn, native in zip(port_natives, natives):
        for a, c in zip(pn.items, native.items):
            assert a.mel.tobytes() == c.mel.tobytes(), c.item_id
            assert a.trim == c.trim
            assert (os.path.relpath(a.audio_path, os.path.dirname(tmeta))
                    == os.path.relpath(c.audio_path, os.path.dirname(jmeta)))
    for port, ref, native in zip(ports, refs, natives):
        assert port.speaker_to_id == ref.speaker_to_id
        assert len(port) == len(ref) > 0
        for a, b, c in zip(port.items, ref.items, native.items):
            assert (a.speaker, a.speaker_id) == (b.speaker, b.speaker_id)
            assert a.phonemes.tobytes() == b.phonemes.tobytes()
            assert a.spk_emb.tobytes() == b.spk_emb.tobytes()
            assert (b.trim is not None) == trim
            assert a.mel.dtype == b.mel.dtype and a.mel.shape == b.mel.shape
            assert a.mel.tobytes() == b.mel.tobytes(), b.item_id
            assert a.mel.shape == c.mel.shape
            np.testing.assert_allclose(a.mel, c.mel, atol=NATIVE_ATOL, rtol=0)
        assert port.max_text_len() == ref.max_text_len()
        assert port.max_mel_len() == ref.max_mel_len()


def _loaders(corpora, **kw):
    jmeta, tmeta = corpora
    js, jq = _datasets(jmeta, JM, JD, False)
    ts, tq = _datasets(tmeta, TM, TD, False)
    args = dict(shots=3, meta_batch_size=2, reduction_factor=2, seed=4, **kw)
    return JL.MetaDataLoader(js, jq, **args), TL.MetaDataLoader(ts, tq,
                                                               **args)


def _epoch(loader):
    return [(spk, [a.tobytes() for a in sup] + [a.tobytes() for a in qry],
             sup.mels.shape)
            for spk, sup, qry in loader.iter_stacked()]


@pytest.mark.parametrize("shots", [3, 9], ids=["shots3", "shots9_repeat"])
def test_meta_loader_episodes_are_byte_identical(corpora, shots):
    """Two epochs of stacked episodes; 9 shots is more than a speaker's
    pool, so the draw repeats items (with replacement).  The static pads
    follow the JAX package's rounding (text to 16, mels to max(16, r))."""
    jl, tl = _loaders(corpora)
    jl.shots = tl.shots = shots
    assert (tl.text_pad_to, tl.mel_pad_to) == (jl.text_pad_to, jl.mel_pad_to)
    assert tl.text_pad_to % 16 == 0 and tl.mel_pad_to % 16 == 0
    assert len(tl) == len(jl) == 2
    for _ in range(2):
        je, te = _epoch(jl), _epoch(tl)
        assert [e[0] for e in je] == [e[0] for e in te]
        assert je == te
        assert te[0][2] == (2, shots, AP["n_mels"], tl.mel_pad_to)


def test_skip_epoch_matches_jax(corpora):
    """After ``skip_epoch`` the next epoch equals the JAX loader's after
    its ``skip_epoch``, and an unbroken run's second epoch."""
    jl, tl = _loaders(corpora)
    _, unbroken = _loaders(corpora)
    jl.skip_epoch()
    tl.skip_epoch()
    _epoch(unbroken)
    second = _epoch(tl)
    assert second == _epoch(jl)
    assert second == _epoch(unbroken)


def test_get_dataloader_and_unpack(corpora):
    """``get_dataloader`` from a params dict, and an episode unpacked
    into the model's batch dictionary (integers as int64)."""
    _, tmeta = corpora
    root = os.path.dirname(tmeta)
    params = synthetic_params(root, n_speakers=3, batch_size=2)
    params["audio_params"] = dict(AP)
    params["meta_batch_size"] = 3
    loader, logs = TL.get_dataloader("metatrain", **params)
    assert "spk02" in logs and len(loader) == 1
    spk, sup, qry = next(loader.iter_stacked())
    b = TL.unpack_task_batch(sup, "static", "cpu")
    assert b["inputs"].dtype.is_floating_point is False
    assert tuple(b["melspecs"].shape) == sup.mels.shape
    assert b["speaker_vecs"].shape == (3, 2, 64)
    ids = TL.unpack_task_batch(sup, "learnable_lookup", "cpu")
    assert ids["speaker_vecs"].shape == (3, 2)
    with open(os.path.join(root, "spk_emb.pkl"), "rb") as f:
        assert set(pickle.load(f)) == {"spk00", "spk01", "spk02"}


def test_mcd_matches_jax():
    """Mel cepstral distortion, one pair and a masked batch (numpy and
    tensors in): the JAX package's numpy path's values, exactly."""
    import torch

    from msa_tts_tpu.ops import metrics as JMet
    from msa_tts_tpu_torch.ops import metrics as TMet

    rng = np.random.default_rng(0)
    out = rng.standard_normal((3, 17, 10)).astype(np.float32)
    mel = rng.standard_normal((3, 17, 10)).astype(np.float32)
    lens = np.array([17, 9, 0], np.int32)
    assert TMet.mcd(out[0], mel[0]) == float(JMet.mcd(out[0], mel[0],
                                                      xp=np))
    ref = JMet.mcd_batch_np(out, mel, lens)
    assert TMet.mcd_batch(out, mel, lens) == ref
    assert TMet.mcd_batch(torch.as_tensor(out), torch.as_tensor(mel),
                          torch.as_tensor(lens)) == ref
