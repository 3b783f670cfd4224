"""The port's dataset scripts (``msa_tts_tpu_torch/data_processing/``)
against the JAX package's on directories laid out like each dataset
(LJSpeech, VCTK, CSS10, CommonVoice), built from the synthetic corpus'
clips: each metafile must match the JAX package's byte for byte, and so
must the clips the scripts resample and rewrite.  ``convert_gt``: the
log-mel each clip is vocoded from matches the JAX package's at
``test_torch_adapt.py``'s forward tolerance (1e-6; read 0: both compute
the dataset's host features), and the re-synthesized wavs are written
under the same names.
"""

import filecmp
import os
import shutil

import numpy as np
import pytest

from msa_tts_tpu.data_processing import convert_gt as JG
from msa_tts_tpu.data_processing import prepare_comvoice as JCV
from msa_tts_tpu.data_processing import prepare_css10 as JCSS
from msa_tts_tpu.data_processing import prepare_ljspeech as JLJ
from msa_tts_tpu.data_processing import prepare_vctk as JV
from msa_tts_tpu_torch.data_processing import convert_gt as TG
from msa_tts_tpu_torch.data_processing import prepare_comvoice as TCV
from msa_tts_tpu_torch.data_processing import prepare_css10 as TCSS
from msa_tts_tpu_torch.data_processing import prepare_ljspeech as TLJ
from msa_tts_tpu_torch.data_processing import prepare_vctk as TV
from msa_tts_tpu_torch.ops.audio import load_wav, save_wav
from torch_parity import TINY_AUDIO, tiny_corpus

FWD_ATOL = 1e-6
TEXTS = ["Hello there, how are you", "A somewhat longer sentence here!",
         "good morning", "Is it raining?", "numbers and words"]


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """The synthetic corpus' clips: ``[(speaker, path), ...]``."""
    root = tiny_corpus(str(tmp_path_factory.mktemp("dp_corpus")))
    out = []
    for spk in ("spk00", "spk01"):
        d = os.path.join(root, "wavs", spk)
        out += [(spk, os.path.join(d, f)) for f in sorted(os.listdir(d))]
    return out


def _both(tmp_path, build):
    """The dataset directory built twice, for each package's run."""
    roots = []
    for side in ("jax", "port"):
        root = str(tmp_path / side)
        os.makedirs(root)
        build(root)
        roots.append(root)
    return roots


def _same_tree(a: str, b: str):
    """Every file under ``a`` equals the one under ``b``, byte for byte."""
    for dirpath, _, files in os.walk(a):
        for f in files:
            pa = os.path.join(dirpath, f)
            pb = os.path.join(b, os.path.relpath(pa, a))
            assert filecmp.cmp(pa, pb, shallow=False), pa


def test_ljspeech_metafile_matches_jax(tmp_path, clips):
    def build(root):
        os.makedirs(os.path.join(root, "wavs"))
        rows = []
        for i, (_, src) in enumerate(clips[:4]):
            wav_id = f"LJ001-{i:04d}"
            shutil.copy(src, os.path.join(root, "wavs", wav_id + ".wav"))
            rows.append(f"{wav_id}|Raw {i}|{TEXTS[i]}")
        with open(os.path.join(root, "metadata.csv"), "w") as f:
            f.write("\n".join(rows))

    a, b = _both(tmp_path, build)
    ma = JLJ.LJSpeechProcessor(a, workers=1).create_metadata()
    mb = TLJ.LJSpeechProcessor(b, workers=1).create_metadata()
    assert open(mb, "rb").read() == open(ma, "rb").read()
    lines = open(mb).read().splitlines()
    assert len(lines) == 4 and all(ln.startswith("lj|wavs/") for ln in lines)


def test_vctk_metafile_and_resampled_clips_match_jax(tmp_path, clips):
    """48 kHz clips under ``wav48/<spk>/``, transcripts under
    ``txt/<spk>/``: resampled to 22.05 kHz into ``wavs/<spk>/``."""
    def build(root):
        for i, (spk, src) in enumerate(clips[:3] + clips[5:7]):
            for sub in ("txt", "wav48"):
                os.makedirs(os.path.join(root, sub, spk), exist_ok=True)
            name = f"{spk}_{i:03d}"
            save_wav(os.path.join(root, "wav48", spk, name + ".wav"),
                     load_wav(src, target_sample_rate=48000), 48000)
            with open(os.path.join(root, "txt", spk, name + ".txt"),
                      "w") as f:
                f.write(TEXTS[i] + "\n")

    a, b = _both(tmp_path, build)
    # both packages read the clips in glob order: the same on one disk
    ma = JV.VCTKProcessor(a, workers=1).create_metadata()
    mb = TV.VCTKProcessor(b, workers=1).create_metadata()
    assert open(mb, "rb").read() == open(ma, "rb").read()
    assert len(open(mb).read().splitlines()) == 5
    _same_tree(os.path.join(a, "wavs"), os.path.join(b, "wavs"))
    assert len(os.listdir(os.path.join(b, "wavs", "spk00"))) == 3


def test_css10_metafile_matches_jax(tmp_path, clips):
    def build(root):
        os.makedirs(os.path.join(root, "clips"))
        rows = []
        for i, (_, src) in enumerate(clips[:3]):
            rel = f"clips/utt{i}.wav"
            shutil.copy(src, os.path.join(root, rel))
            rows.append(f"{rel}|roh {i}|{TEXTS[i]}|1.0")
        with open(os.path.join(root, "transcript.txt"), "w") as f:
            f.write("\n".join(rows))

    a, b = _both(tmp_path, build)
    ma = JCSS.CSS10Processor(a, lang="en-us", workers=1).create_metadata()
    mb = TCSS.CSS10Processor(b, lang="en-us", workers=1).create_metadata()
    assert open(mb, "rb").read() == open(ma, "rb").read()
    assert all(ln.startswith("css10_en-us|")
               for ln in open(mb).read().splitlines())


def test_commonvoice_metafile_and_clips_match_jax(tmp_path, clips):
    """Flat clips under ``clips_wav/`` and ``validated.tsv``; speakers
    with fewer than ``min_per_spk`` clips dropped, the rest rewritten to
    ``wavs/<speaker>/``."""
    def build(root):
        os.makedirs(os.path.join(root, "clips_wav"))
        rows = ["client_id\tpath\tsentence"]
        for i, (spk, src) in enumerate(clips[:7]):
            name = f"{spk}_{i}"
            shutil.copy(src, os.path.join(root, "clips_wav", name + ".wav"))
            rows.append(f"c_{spk}\t{name}.mp3\t{TEXTS[i % 5]}")
        with open(os.path.join(root, "validated.tsv"), "w") as f:
            f.write("\n".join(rows))

    a, b = _both(tmp_path, build)
    kw = dict(lang="en-us", workers=1, min_per_spk=3)
    ma = JCV.CommonVoiceProcessor(a, **kw).create_metadata()
    mb = TCV.CommonVoiceProcessor(b, **kw).create_metadata()
    assert open(mb, "rb").read() == open(ma, "rb").read()
    # spk00 has 5 clips, spk01 2 (< min_per_spk): dropped
    assert {ln.split("|")[0] for ln in open(mb).read().splitlines()} == {
        "c_spk00"}
    _same_tree(os.path.join(a, "wavs"), os.path.join(b, "wavs"))


def test_convert_gt_matches_jax(tmp_path, clips, monkeypatch):
    """Each clip's log-mel as the JAX package computes it, and the
    Griffin-Lim re-synthesis written under the same name and length, on
    the CPU asked for by ``device: cpu``."""
    def build(root):
        for spk, src in clips[:2] + clips[5:6]:
            os.makedirs(os.path.join(root, "src", spk), exist_ok=True)
            shutil.copy(src, os.path.join(root, "src", spk))

    a, b = _both(tmp_path, build)
    mels = {"jax": [], "port": []}
    for side, mod in (("jax", JG), ("port", TG)):
        orig = mod.compute_logmel

        def capture(*args, _o=orig, _s=side):
            out = _o(*args)
            mels[_s].append(np.asarray(out))
            return out

        monkeypatch.setattr(mod, "compute_logmel", capture)
    params = {"audio_params": dict(TINY_AUDIO), "source_folder": "src",
              "target_folder": "gt", "vocoder": "griffinlim"}
    JG.GTConvertor(dict(params, ds_path=a)).run()
    TG.GTConvertor(dict(params, ds_path=b, device="cpu")).run()
    assert len(mels["port"]) == len(mels["jax"]) == 3
    for m, r in zip(mels["port"], mels["jax"]):
        assert m.shape == r.shape and m.shape[0] == TINY_AUDIO["n_mels"]
        np.testing.assert_allclose(m, r, atol=FWD_ATOL, rtol=0)
    for dirpath, _, files in os.walk(os.path.join(a, "gt")):
        for f in files:
            pa = os.path.join(dirpath, f)
            pb = os.path.join(b, os.path.relpath(pa, a))
            wa, wb = load_wav(pa), load_wav(pb)
            assert wa.shape == wb.shape and np.isfinite(wb).all()
    assert sum(len(f) for _, _, f in os.walk(os.path.join(b, "gt"))) == 3
