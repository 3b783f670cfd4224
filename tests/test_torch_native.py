"""The port's host C++ feature library (``msa_tts_tpu_torch/native``, its
own copy of ``feats.cpp``) against the JAX package's, each built here
with g++ from its own source: ``extract_logmels_batch`` for both
frontends, trimmed and not, threaded or not; ``resample`` and
``trim_slice``; the port's ``TTSDataset`` with library features against
the JAX package's; ``load_wav`` with resampling.  Everything is held bit
for bit (the same source compiled the same way).  The library against
the port's numpy path: 1e-5 absolute for the mels (as
``tests/test_native_feats.py`` holds the JAX package's), the trim slices
exact.  Skips only where a library does not build."""

import os

import numpy as np
import pytest

from msa_tts_tpu import native as JN
from msa_tts_tpu.dataloaders import dataset as JD
from msa_tts_tpu.dataloaders import metafile as JM
from msa_tts_tpu.dataloaders.synthetic import (
    make_synthetic_corpus as jax_corpus,
)
from msa_tts_tpu.ops import audio as JA
from msa_tts_tpu_torch import native as TN
from msa_tts_tpu_torch.dataloaders import dataset as TD
from msa_tts_tpu_torch.dataloaders import metafile as TM
from msa_tts_tpu_torch.dataloaders.synthetic import make_synthetic_corpus
from msa_tts_tpu_torch.ops import audio as TA

pytestmark = pytest.mark.skipif(
    not (TN.native_available() and JN.native_available()),
    reason="no C++ toolchain for the host feature library")

AP = dict(sample_rate=22050, n_fft=1024, win_length=1024, hop_length=256,
          f_min=0.0, f_max=8000.0, n_mels=80)
AP2 = dict(sample_rate=22050, n_fft=1024, win_size=1024, hop_size=256,
           fmin=0.0, fmax=8000.0, n_mels=80, center=False)
NUMPY_ATOL = 1e-5


def _wavs(seed=0, durs=(0.4, 1.0, 2.3)):
    rng = np.random.default_rng(seed)
    out = []
    for d in durs:
        w = rng.standard_normal(int(22050 * d)).astype(np.float32) * 0.3
        w[: len(w) // 5] *= 1e-3         # a quiet lead-in the trim cuts
        out.append(w)
    return out


def test_library_builds_into_the_build_directory():
    so = TN.library_path()
    assert so.exists() and so.parent.name == "native"
    assert so.parent.parent.name == "build"


@pytest.mark.parametrize("proc,ap", [("ap", AP), ("ap2", AP2),
                                     ("ap2", dict(AP2, center=True))],
                         ids=["ap", "ap2", "ap2_center"])
@pytest.mark.parametrize("trim", [False, True], ids=["untrimmed", "trimmed"])
@pytest.mark.parametrize("threads", [1, 3])
def test_extract_logmels_batch_equals_jax(proc, ap, trim, threads):
    wavs = _wavs()
    calls = TN.CALLS
    mels, slices = TN.extract_logmels_batch(
        wavs, proc, ap, trim_margin_silence=trim, ref_level_db=20,
        n_threads=threads)
    assert TN.CALLS == calls + 1
    jm, js = JN.extract_logmels_batch(wavs, proc, ap,
                                      trim_margin_silence=trim,
                                      ref_level_db=20, n_threads=threads)
    assert slices == js
    for a, b in zip(mels, jm):
        assert a.dtype == b.dtype == np.float32
        assert a.shape == b.shape and a.tobytes() == b.tobytes()
    for w, m, (s, e) in zip(wavs, mels, slices):
        if trim:
            assert (s, e) == TA.trim_margin_silence_slice(w, 20) and s > 0
        else:
            assert (s, e) == (0, len(w))
        ref = (TA.melspec_ap(w[s:e], ap) if proc == "ap"
               else TA.melspec_ap2(w[None, s:e], ap)[0])
        np.testing.assert_allclose(m, ref, atol=NUMPY_ATOL, rtol=0)


@pytest.mark.parametrize("rates", [(22050, 16000), (16000, 22050),
                                   (44100, 22050), (8000, 22050)])
def test_resample_and_trim_equal_jax(rates):
    w = _wavs(seed=1, durs=(0.7,))[0]
    a, b = TN.resample(w, *rates), JN.resample(w, *rates)
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    from scipy.signal import resample_poly
    import math

    g = math.gcd(*rates)
    ref = resample_poly(w, rates[1] // g, rates[0] // g)
    assert a.shape == ref.shape
    np.testing.assert_allclose(a, ref, atol=1e-5, rtol=0)
    assert TN.trim_slice(w, 20) == JN.trim_slice(w, 20)
    assert TN.trim_slice(w, 20) == TA.trim_margin_silence_slice(w, 20)


def test_resample_batch_threads_agree():
    wavs = _wavs(seed=2)
    one = TN.resample_batch(wavs, 16000, 22050, n_threads=1)
    many = TN.resample_batch(wavs, 16000, 22050, n_threads=3)
    jax = JN.resample_batch(wavs, 16000, 22050, n_threads=2)
    for a, b, c in zip(one, many, jax):
        assert a.tobytes() == b.tobytes() == c.tobytes()


def test_load_wav_resamples_as_jax(tmp_path):
    path = str(tmp_path / "a.wav")
    w = _wavs(seed=3, durs=(0.5,))[0]
    TA.save_wav(path, 0.5 * w / np.abs(w).max(), 16000)
    calls = TN.CALLS
    a = TA.load_wav(path, target_sample_rate=22050)
    assert TN.CALLS == calls + 1
    b = JA.load_wav(path, target_sample_rate=22050)
    assert a.dtype == b.dtype == np.float32
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("proc,trim", [("ap", True), ("ap2", False)])
def test_dataset_library_features_equal_jax(tmp_path, proc, trim):
    """The port's ``TTSDataset`` with its library (the default) against
    the JAX package's with its own, on a corpus at 16 kHz resampled to
    22.05 kHz: mels, trim slices and audio paths."""
    kw = dict(n_speakers=2, utterances_per_speaker=3, min_dur=0.3,
              max_dur=0.5, seed=5, sample_rate=16000)
    metas = (jax_corpus(str(tmp_path / "j"), **kw),
             make_synthetic_corpus(str(tmp_path / "t"), **kw))
    ap = AP if proc == "ap" else AP2
    out = []
    for meta, M, D in zip(metas, (JM, TM), (JD, TD)):
        splits, _ = M.split_speakers(M.parse_metafile(meta),
                                     ["spk00", "spk01"], perc_train=0.7,
                                     seed=1)
        out.append(D.TTSDataset(
            splits, "train", dataset_path=os.path.dirname(meta),
            audio_params=ap, audio_processor=proc, trim_margin_silence=trim,
            ref_level_db=20, feats_threads=2))
    jds, tds = out
    assert len(tds) == len(jds) > 0
    for a, b in zip(tds.items, jds.items):
        assert a.mel.tobytes() == b.mel.tobytes(), b.item_id
        assert a.trim == b.trim and (a.trim is not None) == trim
        assert os.path.basename(a.audio_path) == os.path.basename(
            b.audio_path)
