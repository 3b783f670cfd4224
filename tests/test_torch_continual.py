"""The port's continual trainers (``trainers/continual_*.py``,
``cumulative.py``) against the JAX package's on a tiny synthetic corpus
of 3 speakers (the tiny model of ``tests/torch_parity.py``, batches of
2, 2 items a task into the buffer):

* the seeded speaker order, each task's training and test items, every
  task loader's batches and the replay buffer after each task (ids and
  soft targets), for every method, with and without an initial phase:
  byte for byte (the same ``random`` and numpy generators);
* EWC's Fisher over the buffer and its penalised step, ER-KD's soft
  targets, ER-reg's similarities, its weight decay (coupled L2, read in
  Adam's first moment) and clip threshold: against the JAX trainer's
  under JAX's dropout masks (injected at the port's seam), from JAX's
  initial weights, in float32 and with ``compute_dtype: bfloat16``;
* every trainer through its ``main`` on the CPU; a stream that dies
  entering task 2, resumed, equal bit for bit to the unbroken stream
  (weights, statistics, cumulative-test matrix, buffer and its soft
  targets); a resume under another speaker order refused.

Tolerances, 4x the largest reading here.  EWC (its step is SGD with lr 1
and the clip at 1, so the new weights carry the clipped gradient),
float32: the Fisher 1.3e-6 relative to its largest value (read 3.3e-7;
held against its largest value, since the biases that feed a batch norm
have a true gradient of 0 and a Fisher of float noise, ~1e-14), new
weights 7.2e-7 absolute (read 1.8e-7; the step moved them by up to
0.43), the total and base losses 8.4e-7 relative (read 1.1e-7, 2.1e-7),
the gradient norm 4.1e-7 (read 1.0e-7); bfloat16: the Fisher 0.12
(read 2.9e-2), weights 0.1 (read 2.5e-2 where the step moved them by up
to 0.44), losses 4.8e-3 (read 1.2e-3, 3.4e-5), gradient norm 5.7e-2
(read 1.4e-2).  ER-KD's soft targets come from the float32 weights under
either compute type: 1.7e-5 absolute on log-mels of up to 6.1 (read
4.1e-6)."""

import argparse
import os
import pickle
import random

import jax
import numpy as np
import pytest
import torch

from msa_tts_tpu.trainers import continual_er_reg as JR
from msa_tts_tpu.trainers.continual_er import ExperienceReplayTrainer as JER
from msa_tts_tpu.trainers.continual_erkd import (
    ExperienceReplayKnowledgeDistillTrainer as JERKD,
)
from msa_tts_tpu.trainers.continual_ewc import EWCTrainer as JEWC
from msa_tts_tpu.trainers.cumulative import CumulativeTrainer as JCUM
from msa_tts_tpu_torch.config import save_params
from msa_tts_tpu_torch.trainers import continual_er as TER
from msa_tts_tpu_torch.trainers import continual_er_reg as TR
from msa_tts_tpu_torch.trainers import continual_erkd as TKD
from msa_tts_tpu_torch.trainers import continual_ewc as TEWC
from msa_tts_tpu_torch.trainers import cumulative as TCUM
from msa_tts_tpu_torch.utils.convert import state_dict_from_jax
from torch_parity import (
    from_jax_masks,
    install_jax_init,
    jax_step_key,
    one_torch_thread,  # noqa: F401  (an autouse fixture)
    port_guard,  # noqa: F401  (taken by pytestmark)
    tiny_corpus,
    tiny_train_params,
)

pytestmark = pytest.mark.usefixtures("port_guard")

EWC_TOL = {"float32": dict(fisher=1.3e-6, w=7.2e-7, loss=8.4e-7, norm=4.1e-7),
           "bfloat16": dict(fisher=0.12, w=0.1, loss=4.8e-3, norm=5.7e-2)}
KD_ATOL = 1.7e-5
SEED = 3

METHODS = {
    "continual_er": (JER, TER, "ExperienceReplayTrainer", {}),
    "continual_erkd": (JERKD, TKD, "ExperienceReplayKnowledgeDistillTrainer",
                       {}),
    "continual_er_reg": (JR.ExperienceReplayRegTrainer, TR,
                         "ExperienceReplayRegTrainer",
                         dict(regularizaton_method="buffer_replicate",
                              buffer_replicate_factor=2)),
    "continual_ewc": (JEWC, TEWC, "EWCTrainer", {}),
    "cumulative": (JCUM, TCUM, "CumulativeTrainer", {}),
}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return tiny_corpus(str(tmp_path_factory.mktemp("continual_corpus")),
                       n_speakers=3)


@pytest.fixture
def jax_numpy_feats(monkeypatch):
    """Both packages on their numpy features (equal byte for byte)."""
    import msa_tts_tpu.native as native
    import msa_tts_tpu_torch.native as port_native

    for mod in (native, port_native):
        monkeypatch.setattr(mod, "extract_logmels_batch",
                            lambda *a, **k: None)


def _params(corpus, out, method, **over):
    p = dict(speaker_seed=11, num_initial_speakers=0, n_max_epochs=1,
             test_interval=1, early_stopping=False, buffer_sample_size=2,
             buffer_batch_size=2, buffer_shuffle=True, ewc_importance=1000.0,
             kd_seed=7, train_seed=SEED)
    p.update(over)
    return tiny_train_params(corpus, out, method, n_speakers=3, **p)


def _ids(items):
    return [it.item_id for it in items]


def _same_batches(jl, tl, where):
    for k, (a, b) in enumerate(zip(tl, jl, strict=True)):
        for name in type(a)._fields:
            x, y = getattr(a, name), getattr(b, name)
            assert x.tobytes() == y.tobytes(), (where, k, name)


@pytest.mark.parametrize("num_initial", [0, 1], ids=["stream", "initial"])
@pytest.mark.parametrize("method", sorted(METHODS))
def test_items_and_buffer_match_jax(corpus, tmp_path, jax_numpy_feats,
                                    method, num_initial):
    """The speaker order; per task its training items (the initial
    phase's too), its test items, its loader's batches and the buffer
    after it, without training (soft targets and the Fisher are held
    below)."""
    jcls, tmod, name, over = METHODS[method]
    p = _params(corpus, str(tmp_path), method,
                num_initial_speakers=num_initial, **over)
    jt, pt = jcls(**p), getattr(tmod, name)(**p, device="cpu")
    assert pt.all_speakers == jt.all_speakers
    for t in (jt, pt):
        t.speakers_so_far = []
        if hasattr(t, "_soften"):
            t._soften = lambda items: list(items)
        if hasattr(t, "_compute_fisher"):
            t._compute_fisher = lambda *a: None
    if num_initial:
        initial = pt.all_speakers[:num_initial]
        items = (jt._initial_task_items(initial),
                 pt._initial_task_items(initial))
        assert _ids(items[1]) == _ids(items[0])
        assert _ids(getattr(pt, "buffer", [])) == _ids(
            getattr(jt, "buffer", []))
    for spk_itr, spk in enumerate(pt.all_speakers, num_initial):
        for t in (jt, pt):
            t.speakers_so_far.append(spk)
        jitems = jt._task_train_items(spk, spk_itr)
        titems = pt._task_train_items(spk, spk_itr)
        assert _ids(titems) == _ids(jitems), spk_itr
        assert _ids(getattr(pt, "buffer", [])) == _ids(
            getattr(jt, "buffer", [])), spk_itr
        assert _ids(pt._task_items([spk], "test")) == _ids(
            jt._task_items([spk], "test"))
        _same_batches(jt._make_loader(jitems, seed=spk_itr),
                      pt._make_loader(titems, seed=spk_itr),
                      f"task {spk_itr}")
    if method == "continual_er_reg":
        assert len(pt.buffer) == 3 * 2 * 2 + (4 if num_initial else 0)


def _sd(trainer, state):
    return state_dict_from_jax(jax.device_get(state.params),
                               jax.device_get(state.model_state),
                               trainer.cfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ewc_fisher_and_step_match_jax(corpus, tmp_path, jax_numpy_feats,
                                       dtype):
    """Task 1 of an EWC stream from JAX's initial weights: the Fisher over
    the buffer (its masks keyed on the task), then, at weights moved off
    the anchor, one penalised step: new weights, total and base loss,
    gradient norm."""
    tol = EWC_TOL[dtype]
    p = _params(corpus, str(tmp_path), "continual_ewc", compute_dtype=dtype,
                optim={"optimizer_type": "SGD", "lr": "1.0"})
    jt = JEWC(**p)
    pt = from_jax_masks(TEWC.EWCTrainer, jt.cfg, SEED)(**p, device="cpu")
    init = install_jax_init(pt, jt)
    for t in (jt, pt):
        t.speakers_so_far = []
        for spk_itr, spk in enumerate(t.all_speakers[:2]):
            t.speakers_so_far.append(spk)
            t._reset_optimizer(spk)
            items = t._task_train_items(spk, spk_itr)
    (jf, jm), (pf, pm) = jt._ewc, pt._ewc
    jf = _sd(pt, jt.train_state._replace(params=jf))
    top = max(float(v.abs().max()) for v in jf.values())
    assert top > 0
    assert max(float((v - jf[k]).abs().max())
               for k, v in pf.items()) <= tol["fisher"] * top
    assert all(torch.equal(pm[k], init[k]) for k in pm)

    # move the weights off the anchor (the same on both sides)
    rng = np.random.default_rng(0)
    shift = jax.tree_util.tree_map(
        lambda x: (rng.standard_normal(x.shape) * 1e-2).astype(np.float32),
        jax.device_get(jt.train_state.params))
    jt.train_state = jt.train_state._replace(params=jax.tree_util.tree_map(
        lambda a, b: a + b, jt.train_state.params, shift))
    moved = _sd(pt, jt.train_state)
    pt.train_state = pt.train_state._replace(
        params={k: moved[k] for k in pt.param_names})
    jb = next(iter(jt._make_loader(items, seed=1)))
    tb = next(iter(pt._make_loader(items, seed=1)))
    key = (1, 0)
    js, jmet, _ = jt._task_step(jt.train_state, jt._unpack_batch(jb),
                                jax_step_key(SEED, "task", key))
    batch = pt._unpack_batch(tb)
    ps, pmet, _ = pt._task_step(pt.train_state, batch,
                                pt._draw_step_masks("task", key, batch))
    ref = _sd(pt, js)
    w = max(float((ps.params[k] - ref[k]).abs().max()) for k in ps.params)
    step = max(float((ref[k] - moved[k]).abs().max()) for k in ps.params)
    assert step > 1e-2 and w <= tol["w"], (w, step)
    assert float(pmet["loss"]) > float(pmet["base_loss"]) > 0
    for k, lim in (("loss", tol["loss"]), ("base_loss", tol["loss"]),
                   ("grad_norm", tol["norm"])):
        rel = abs(float(pmet[k]) - float(jmet[k])) / abs(float(jmet[k]))
        assert rel <= lim, (k, rel)


def test_erkd_soft_targets_match_jax(corpus, tmp_path, jax_numpy_feats):
    """The soft targets of the first task's buffer items, from the
    float32 weights though ``compute_dtype`` is bfloat16: unsorted
    batches, each cut to its item's length."""
    p = _params(corpus, str(tmp_path), "continual_erkd",
                compute_dtype="bfloat16")
    jt = JERKD(**p)
    pt = from_jax_masks(TKD.ExperienceReplayKnowledgeDistillTrainer, jt.cfg,
                        SEED)(**p, device="cpu")
    install_jax_init(pt, jt)
    spk = pt.all_speakers[0]
    jitems = jt._task_items([spk], "train")[:3]
    titems = pt._task_items([spk], "train")[:3]
    js, ts = jt._soften(jitems), pt._soften(titems)
    assert _ids(ts) == _ids(js) == _ids(titems)
    for a, b, it in zip(ts, js, titems):
        assert a.soft_mel.shape == it.mel.shape == b.soft_mel.shape
        assert a.soft_mel.dtype == np.float32
        assert np.abs(a.soft_mel - b.soft_mel).max() <= KD_ATOL
        assert not np.allclose(a.soft_mel, it.mel)
        assert a.mel is it.mel


def test_er_reg_similarity_decay_and_clip_match_jax(corpus, tmp_path,
                                                    jax_numpy_feats):
    """``get_similarity`` (cosine, dot product, the L1 sum named
    ``l2_dist``) and ``get_spk_similarity``; per task of a stream the
    similarity, the optimizer's weight decay (Adam's first moment after
    one update of the same gradients) and the clip threshold; the
    misspelt config key read, a missing one refused."""
    rng = np.random.default_rng(1)
    v, vs = rng.standard_normal(8), list(rng.standard_normal((3, 8)))
    for kind in ("cosine", "dot_prod", "l2_dist"):
        assert TR.get_similarity(v, vs, kind) == JR.get_similarity(v, vs,
                                                                   kind)
    emb = {s: rng.standard_normal(8) for s in "abc"}
    assert TR.get_spk_similarity(emb, ["a", "b"], "c") == \
        JR.get_spk_similarity(emb, ["a", "b"], "c")
    with pytest.raises(ValueError, match="regularization_method"):
        TR.ExperienceReplayRegTrainer(**_params(corpus, str(tmp_path), "x"),
                                      device="cpu")
    for method in ("adaptive_weightdecay", "adaptive_weightclipping"):
        p = _params(corpus, str(tmp_path / method), "continual_er_reg",
                    regularizaton_method=method, weightdecay_value=0.5,
                    clip_grad_norm=True, grad_clip_thresh=2.0)
        jt = JR.ExperienceReplayRegTrainer(**p)
        pt = TR.ExperienceReplayRegTrainer(**p, device="cpu")
        install_jax_init(pt, jt)
        jparams = jax.device_get(jt.train_state.params)
        for t in (jt, pt):
            t.speakers_so_far = []
        for spk in pt.all_speakers:
            for t in (jt, pt):
                t.speakers_so_far.append(spk)
                t._reset_optimizer(spk)
            assert pt._spk_similarity == jt._spk_similarity
            assert pt.params["grad_clip_thresh"] == \
                jt.params["grad_clip_thresh"]
            g = jax.tree_util.tree_map(
                lambda x: rng.standard_normal(x.shape).astype(np.float32),
                jparams)
            _, jstate = jt.tx.update(g, jt.tx.init(jparams), jparams)
            jmu = next(st.mu for st in jstate if hasattr(st, "mu"))
            tg = _sd(pt, jt.train_state._replace(params=g))
            _, tstate = pt.tx.update(
                {k: tg[k] for k in pt.param_names},
                pt.tx.init(pt.train_state.params), pt.train_state.params)
            tmu = next(st["mu"] for st in tstate
                       if isinstance(st, dict) and "mu" in st)
            ref = _sd(pt, jt.train_state._replace(params=jmu))
            for k in pt.param_names:
                np.testing.assert_allclose(tmu[k].numpy(), ref[k].numpy(),
                                           rtol=1e-6, atol=1e-7, err_msg=k)
        assert pt._spk_similarity != 1.0


def _run_main(tmod, name, params, workdir):
    os.makedirs(workdir, exist_ok=True)
    save_params(params, os.path.join(workdir, "params.yml"))
    ran = []
    cls = getattr(tmod, name)

    class Kept(cls):
        def run(self):
            ran.append(self)
            super().run()

    setattr(tmod, name, Kept)
    try:
        tmod.main(argparse.Namespace(params_path=workdir))
    finally:
        setattr(tmod, name, cls)
    return ran[0]


def _cumutest(t):
    with open(os.path.join(t.path_manager.examples_path, "cumutest.pkl"),
              "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("method", sorted(METHODS))
def test_main_runs(corpus, tmp_path, method):
    """``main`` with ``device: cpu``: a checkpoint per task, the
    cumulative-test matrix over every speaker seen, all finite; ER's
    example plots written (one method plots: a plot costs ~0.5 s)."""
    _, tmod, name, over = METHODS[method]
    plots = method == "continual_er"
    t = _run_main(tmod, name, _params(corpus, str(tmp_path / "out"), method,
                                      device="cpu", plot_examples=plots,
                                      **over),
                  str(tmp_path / "params"))
    pngs = os.listdir(t.path_manager.examples_path)
    assert any(n.startswith("cumTest_2_") for n in pngs) == plots
    names = [n for n in os.listdir(t.path_manager.checkpoints_path)
             if n.startswith("best_")]
    assert len(names) == 3
    cumu = _cumutest(t)
    assert sorted(cumu) == [0, 1, 2]
    assert len(cumu[2]["losses"]) == 3
    assert all(np.isfinite(x) for x in cumu[2]["losses"].values())
    if method == "continual_erkd":
        assert all(it.soft_mel is not None for it in t.buffer)


@pytest.mark.parametrize("method", ["continual_erkd", "continual_ewc"])
def test_stream_resume_bit_identical(corpus, tmp_path, method):
    """A stream that dies entering task 2, resumed: the unbroken stream's
    weights, statistics, step count, cumulative-test matrix and buffer
    (ids and soft targets), bit for bit; under another speaker order the
    resume is refused."""
    _, tmod, name, over = METHODS[method]
    cls = getattr(tmod, name)
    # EWC writes its stream state on the training thread, ER-KD on the
    # checkpoint writer's (AsyncCheckpointer.save_pickle)
    over = dict(over, async_checkpoint=method == "continual_erkd")
    full = cls(**_params(corpus, str(tmp_path / "full"), method,
                         device="cpu", **over))
    full.run()
    p = _params(corpus, str(tmp_path / "part"), method, device="cpu", **over)

    class Preempted(cls):
        def _task_train_items(self, speaker, spk_itr):
            if spk_itr == 2:
                raise RuntimeError("simulated preemption")
            return super()._task_train_items(speaker, spk_itr)

    with pytest.raises(RuntimeError, match="preemption"):
        Preempted(**p).run()
    res = cls(**dict(p, resume=True))
    res.run()
    assert res.step_global == full.step_global
    for k, v in full.train_state.params.items():
        assert torch.equal(res.train_state.params[k], v), k
    for k, v in full.train_state.model_state.items():
        assert torch.equal(res.train_state.model_state[k], v), k
    assert _cumutest(res) == _cumutest(full)
    assert _ids(res.buffer) == _ids(full.buffer)
    for a, b in zip(res.buffer, full.buffer):
        assert (a.soft_mel is None) == (b.soft_mel is None)
        if a.soft_mel is not None:
            assert a.soft_mel.tobytes() == b.soft_mel.tobytes()

    base = list(p["dataset_train"]["speakers_list"])
    ref = list(base)
    random.Random(11).shuffle(ref)
    seed = next(s for s in range(100, 200)
                if (lambda o: (random.Random(s).shuffle(o), o)[1])(
                    list(base)) != ref)
    with pytest.raises(ValueError, match="speaker order"):
        cls(**dict(p, resume=True, speaker_seed=seed)).run()


def test_make_reproducible_settings():
    """What the trainers set when they start on a CUDA device: the
    backward on the calling thread, cuDNN's deterministic algorithms, a
    fixed cuBLAS workspace (no CUDA runtime is needed to set them); on the
    CPU nothing changes."""
    from msa_tts_tpu_torch.utils.determinism import make_reproducible

    before = (torch._C._is_multithreading_enabled(),
              torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark,
              os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    try:
        make_reproducible("cpu")
        assert (torch._C._is_multithreading_enabled(),
                torch.backends.cudnn.deterministic,
                torch.backends.cudnn.benchmark,
                os.environ.get("CUBLAS_WORKSPACE_CONFIG")) == before
        make_reproducible("cuda")
        assert not torch._C._is_multithreading_enabled()
        assert torch.backends.cudnn.deterministic
        assert not torch.backends.cudnn.benchmark
        assert os.environ["CUBLAS_WORKSPACE_CONFIG"] in (before[3],
                                                         ":4096:8")
    finally:
        torch.autograd.set_multithreading_enabled(before[0])
        torch.backends.cudnn.deterministic = before[1]
        torch.backends.cudnn.benchmark = before[2]
        if before[3] is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
