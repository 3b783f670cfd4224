"""The port's joint-training data path against the JAX package's on a
tiny synthetic corpus: the samplers (``BinnedLengthSampler``,
``ShuffleSampler``, ``SequentialSampler``) over three epochs, the default
loader's train and test batches (shuffled and duration-binned) over two
epochs and after ``skip_epoch``, a loader over a plain list of items,
``collate`` with soft targets (``set_soft_target``, ``sort_by_length``,
``use_soft_mel``), the items' ids and durations; and ``prefetch_to_device``
yields every batch, in order, with its values.

Everything is held byte for byte: both sides draw from numpy's
``default_rng`` and the port's features equal the JAX package's numpy
path (``tests/test_torch_meta_data.py``)."""

import numpy as np
import pytest
import torch

from msa_tts_tpu.dataloaders import loader_buffer as JB
from msa_tts_tpu.dataloaders import loader_default as JL
from msa_tts_tpu.dataloaders import sampler as JS
from msa_tts_tpu.dataloaders.collate import collate as jax_collate
from msa_tts_tpu_torch.dataloaders import collate as TC
from msa_tts_tpu_torch.dataloaders import loader_buffer as TB
from msa_tts_tpu_torch.dataloaders import loader_default as TL
from msa_tts_tpu_torch.dataloaders import sampler as TS
from msa_tts_tpu_torch.dataloaders.prefetch import prefetch_to_device
from torch_parity import (
    one_torch_thread,  # noqa: F401  (an autouse fixture)
    tiny_corpus,
    tiny_train_params,
)

FIELDS = TC.Batch._fields


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return tiny_corpus(str(tmp_path_factory.mktemp("joint_data")),
                       n_speakers=3)


def _params(corpus, tmp, **ds):
    p = tiny_train_params(corpus, str(tmp), "baseline", n_speakers=3)
    p["dataset_train"] = dict(p["dataset_train"], **ds)
    return p


@pytest.fixture(scope="module")
def jax_numpy_feats():
    """Both packages on their numpy features (equal byte for byte)."""
    import msa_tts_tpu.native as native
    import msa_tts_tpu_torch.native as port_native

    with pytest.MonkeyPatch.context() as mp:
        for mod in (native, port_native):
            mp.setattr(mod, "extract_logmels_batch", lambda *a, **k: None)
        yield


def _same_batch(a, b, where=""):
    for name in FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.shape == y.shape, (where, name)
        assert x.tobytes() == y.tobytes(), (where, name)


@pytest.mark.parametrize("kind", ["binned", "shuffle", "sequential"])
def test_samplers_match_jax(kind):
    """Three epochs of each sampler give the JAX package's orders."""
    lengths = np.random.default_rng(0).uniform(0.3, 4.0, 23)
    make = {
        "binned": lambda M: M.BinnedLengthSampler(lengths, 3, 6, seed=5),
        "shuffle": lambda M: M.ShuffleSampler(23, seed=5),
        "sequential": lambda M: M.SequentialSampler(23),
    }[kind]
    js, ts = make(JS), make(TS)
    assert len(js) == len(ts) == 23
    for _ in range(3):
        assert [int(i) for i in ts] == [int(i) for i in js]
    with pytest.raises(ValueError, match="multiple"):
        TS.BinnedLengthSampler(lengths, 3, 4)


@pytest.mark.parametrize("binned", [False, True], ids=["shuffled", "binned"])
def test_default_loader_matches_jax(corpus, tmp_path, jax_numpy_feats,
                                    binned):
    """``get_dataloader``: the datasets' item ids, durations and speaker
    ids; two epochs of train batches and the test batches; after
    ``skip_epoch`` on both sides, the next epoch's batches."""
    ds = dict(use_binned_sampler=True, bin_size=4) if binned else {}
    p = _params(corpus, tmp_path, **ds)
    jtr, jte, jlog = JL.get_dataloader(**p)
    ttr, tte, tlog = TL.get_dataloader(**p)
    assert jlog == tlog
    assert len(ttr) == len(jtr) and len(tte) == len(jte)
    for j, t in ((jtr, ttr), (jte, tte)):
        assert [(it.item_id, it.duration, it.speaker_id)
                for it in t.dataset.items] == [
            (it.item_id, it.duration, it.speaker_id)
            for it in j.dataset.items]
        assert t.dataset.get_audio_durations() == \
            j.dataset.get_audio_durations()
    assert ttr.dataset.speaker_to_id == jtr.dataset.speaker_to_id
    for epoch in range(2):
        for k, (a, b) in enumerate(zip(ttr, jtr, strict=True)):
            _same_batch(a, b, f"train epoch {epoch} batch {k}")
    for k, (a, b) in enumerate(zip(tte, jte, strict=True)):
        _same_batch(a, b, f"test batch {k}")
    jtr.skip_epoch()
    ttr.skip_epoch()
    for k, (a, b) in enumerate(zip(ttr, jtr, strict=True)):
        _same_batch(a, b, f"after skip_epoch, batch {k}")


def test_loader_over_items_and_soft_targets(corpus, tmp_path,
                                            jax_numpy_feats):
    """A ``DataLoader`` over a list of items (as the continual trainers'
    task views), shuffled, with soft targets on some items; ``collate``
    with and without sorting and soft targets."""
    p = _params(corpus, tmp_path)
    jds = JL.build_datasets(**p)[0]
    tds = TL.build_datasets(**p)[0]
    rng = np.random.default_rng(2)
    pick = [0, 3, 4, 6, 7]
    jitems, titems = [], []
    for i in pick:
        j, t = jds.items[i], tds.items[i]
        if i % 2 == 0:
            # a soft target shorter than the ground truth
            soft = rng.standard_normal(
                (j.mel.shape[0], j.mel.shape[1] - 3)).astype(np.float32)
            j, t = JB.set_soft_target(j, soft), TB.set_soft_target(t, soft)
            assert t.mel_for_training is t.soft_mel
        else:
            assert t.mel_for_training is t.mel
        jitems.append(j)
        titems.append(t)
    kw = dict(batch_size=2, shuffle=True, seed=4, reduction_factor=2)
    jl, tl = JL.DataLoader(jitems, **kw), TL.DataLoader(titems, **kw)
    for epoch in range(2):
        for k, (a, b) in enumerate(zip(tl, jl, strict=True)):
            _same_batch(a, b, f"epoch {epoch} batch {k}")
    for sort in (True, False):
        for soft in (True, False):
            kw = dict(reduction_factor=2, sort_by_length=sort,
                      use_soft_mel=soft)
            _same_batch(TC.collate(titems, **kw), jax_collate(jitems, **kw),
                        f"sort {sort}, soft {soft}")


def _host_batches(n):
    rng = np.random.default_rng(0)
    for i in range(n):
        yield {"inputs": rng.integers(0, 9, (2, 5)).astype(np.int32),
               "melspecs": rng.standard_normal((2, 3, 4)).astype(np.float32),
               "name": f"b{i}"}


@pytest.mark.parametrize("threaded", [True, False],
                         ids=["thread", "inline"])
def test_prefetch_order_and_values(threaded):
    """Every item comes out once, in order, as tensors (integers as
    int64) equal to the arrays put in; other leaves pass through; an
    error of the producer reaches the consumer; a consumer that stops
    early stops the producer."""
    want = list(_host_batches(7))
    got = list(prefetch_to_device(_host_batches(7), size=2, device="cpu",
                                  threaded=threaded))
    assert len(got) == 7
    for g, w in zip(got, want):
        assert g["name"] == w["name"]
        assert g["inputs"].dtype == torch.int64
        assert np.array_equal(g["inputs"].numpy(), w["inputs"])
        assert g["melspecs"].dtype == torch.float32
        assert g["melspecs"].numpy().tobytes() == w["melspecs"].tobytes()

    def broken():
        yield from _host_batches(2)
        raise RuntimeError("producer failed")

    it = prefetch_to_device(broken(), size=2, device="cpu",
                            threaded=threaded)
    assert [b["name"] for b in (next(it), next(it))] == ["b0", "b1"]
    with pytest.raises(RuntimeError, match="producer failed"):
        next(it)
    it = prefetch_to_device(_host_batches(50), size=2, device="cpu",
                            threaded=threaded)
    assert next(it)["name"] == "b0"
    it.close()


def test_prefetch_defaults_to_the_card(monkeypatch):
    """``prefetch_to_device`` loads onto the card unless ``device="cpu"``
    is asked for: without a CUDA device the default raises at the call,
    naming the way to the CPU, instead of yielding host tensors."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        prefetch_to_device(_host_batches(2), size=2)
    got = list(prefetch_to_device(_host_batches(2), size=2, device="cpu"))
    assert [b["inputs"].device.type for b in got] == ["cpu", "cpu"]
