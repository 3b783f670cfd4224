"""The port's joint trainer (``msa_tts_tpu_torch/trainers/baseline.py``)
against the JAX package's on a tiny synthetic corpus (the tiny model of
``tests/torch_parity.py``, 2 speakers, batches of 2): one training step
and one test pass against the JAX trainer's ``_train_step_jit`` and
``_eval_step_jit`` under JAX's dropout masks (injected at the port's one
seam, ``torch_parity.from_jax_masks``), from JAX's initial weights, in
float32 and with ``compute_dtype: bfloat16``; the trainer's ``main`` on
the CPU (logs, checkpoints, the meta-test), a run preempted in its third
epoch and resumed, equal bit for bit to the unbroken run, and
``checkpoint_best.ckpt`` read by the other package.

The step here is SGD with lr 1 (the clip at 1 on): the new weights carry
the clipped gradient itself (Adam's first step is lr·sign(g), which turns
float noise in a near-zero gradient into a step of lr; Adam is held to
optax in ``tests/test_torch_meta_step.py``).  Tolerances, each 4x the
largest reading here: float32, new weights 3.6e-7 absolute (read 8.9e-8;
the step moved them by up to 0.22), the losses and MCDs of the step and
the test pass 2.1e-6 relative (read 4.3e-7, 5.3e-7, 1.9e-7, 0), the
gradient norm 7.2e-7 (read 1.8e-7), the batch-norm statistics after the
step and after the test pass 1.4e-6 relative to each tensor's largest
value (read 2.8e-7, 3.4e-7); bfloat16, weights 1.3e-2 (read 3.2e-3),
losses and MCDs 1e-2 (read 1.9e-4, 2.5e-3, 7.7e-5, 1.6e-3), the
gradient norm 7.6e-3 (read 1.9e-3), statistics 5.3e-2 (read 8.8e-3,
1.3e-2): bfloat16 keeps 8 bits and XLA rounds fused chains once where
PyTorch rounds each operation."""

import argparse
import json
import os

import jax
import numpy as np
import pytest
import torch

from msa_tts_tpu.trainers.baseline import JointTrainer as JaxJoint
from msa_tts_tpu_torch.config import save_params
from msa_tts_tpu_torch.trainers import baseline as TB
from msa_tts_tpu_torch.trainers.baseline import JointTrainer
from msa_tts_tpu_torch.utils.checkpoint import load_checkpoint
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

TOL = {"float32": dict(w=3.6e-7, log=2.1e-6, norm=7.2e-7, stat=1.4e-6),
       "bfloat16": dict(w=1.3e-2, log=1e-2, norm=7.6e-3, stat=5.3e-2)}
SEED = 3


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return tiny_corpus(str(tmp_path_factory.mktemp("joint_corpus")))


@pytest.fixture
def jax_numpy_feats(monkeypatch):
    """Both packages on their numpy features (equal byte for byte)."""
    import msa_tts_tpu.native as native
    import msa_tts_tpu_torch.native as port_native

    for mod in (native, port_native):
        monkeypatch.setattr(mod, "extract_logmels_batch",
                            lambda *a, **k: None)


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _stat_err(ours: dict, ref: dict) -> float:
    return max(float((ours[k] - ref[k]).abs().max() / ref[k].abs().max())
               for k in ref if "running" in k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_step_and_test_pass_match_jax(corpus, tmp_path, jax_numpy_feats,
                                      dtype):
    """Step 1 of epoch 1 and the first test batch of epoch 1: the new
    weights and batch-norm statistics, the loss, MCD and gradient norm;
    the test pass's loss, MCD and statistics."""
    tol = TOL[dtype]
    p = tiny_train_params(corpus, str(tmp_path), "baseline",
                          compute_dtype=dtype, train_seed=SEED,
                          optim={"optimizer_type": "SGD", "lr": "1.0"})
    jt = JaxJoint(**p)
    pt = from_jax_masks(JointTrainer, jt.cfg, SEED)(**p, device="cpu")
    init = install_jax_init(pt, jt)

    jb, tb = next(iter(jt.dataloader_train)), next(iter(pt.dataloader_train))
    assert jb.inputs.tobytes() == tb.inputs.tobytes()
    js, jm, _ = jt._train_step_jit(jt.train_state, jt._unpack_batch(jb),
                                   jax_step_key(SEED, "train", (1, 1)))
    batch = pt._unpack_batch(tb)
    ps, pm, _ = pt._train_step(pt.train_state, batch,
                               pt._draw_step_masks("train", (1, 1), batch))
    ref = state_dict_from_jax(jax.device_get(js.params),
                              jax.device_get(js.model_state), pt.cfg)
    w = max(float((ps.params[k] - ref[k]).abs().max()) for k in ps.params)
    moved = max(float((ref[k] - init[k]).abs().max()) for k in ps.params)
    assert moved > 1e-2 and w <= tol["w"], (w, moved)
    assert all(v.dtype == torch.float32 for v in ps.params.values())
    assert _stat_err(ps.model_state, ref) <= tol["stat"]
    assert _rel(pm["loss"], jm["loss"]) <= tol["log"]
    assert _rel(pm["mcd"], jm["mcd"]) <= tol["log"]
    assert _rel(pm["grad_norm"], jm["grad_norm"]) <= tol["norm"]

    jb, tb = next(iter(jt.dataloader_test)), next(iter(pt.dataloader_test))
    je, jem, _ = jt._eval_step_jit(js, jt._unpack_batch(jb),
                                   jax_step_key(SEED, "test", (1, 1)))
    batch = pt._unpack_batch(tb)
    pe, pem, _ = pt._eval_step(ps, batch,
                               pt._draw_step_masks("test", (1, 1), batch))
    assert all(pe.params[k] is ps.params[k] for k in ps.params)
    ref = state_dict_from_jax(jax.device_get(je.params),
                              jax.device_get(je.model_state), pt.cfg)
    assert _stat_err(pe.model_state, ref) <= tol["stat"]
    assert _rel(pem["loss"], jem["loss"]) <= tol["log"]
    assert _rel(pem["mcd"], jem["mcd"]) <= tol["log"]


def _logs(trainer):
    out = {}
    for line in open(trainer.logger.jsonl_path):
        d = json.loads(line)
        out[(d["tag"], d["step"])] = d["value"]
    return out


def _run_main(params, workdir):
    """``trainers.baseline.main`` on ``params`` written to
    ``workdir/params.yml``; returns the trainer it ran."""
    os.makedirs(workdir, exist_ok=True)
    save_params(params, os.path.join(workdir, "params.yml"))
    ran = []

    class Kept(JointTrainer):
        def run(self):
            ran.append(self)
            super().run()

    orig, TB.JointTrainer = TB.JointTrainer, Kept
    try:
        TB.main(argparse.Namespace(params_path=workdir))
    finally:
        TB.JointTrainer = orig
    return ran[0]


def test_main_runs_resumes_and_checkpoints_cross(corpus, tmp_path,
                                                 jax_numpy_feats):
    """``main`` with ``device: cpu`` for 3 epochs (Adam, lr 1e-2) with a
    meta-test every epoch: every value logged is finite, the last
    epoch's mean loss is below the first's, the checkpoints are written;
    a run that dies entering epoch 3, resumed, ends with the
    unbroken run's weights, statistics, best test loss and step count,
    bit for bit; the JAX trainer restores the port's
    ``checkpoint_best.ckpt`` and the port the JAX trainer's checkpoint."""
    def params(out, **over):
        return tiny_train_params(corpus, str(tmp_path / out), "baseline",
                                 device="cpu", n_epochs=3, do_metatest=True,
                                 n_inner_test=1, prefetch=2,
                                 optim={"optimizer_type": "Adam",
                                        "lr": "1e-2"}, **over)

    full = _run_main(params("full"), str(tmp_path / "full_params"))
    logs = _logs(full)
    assert all(np.isfinite(v) for v in logs.values())
    tags = {tag for tag, _ in logs}
    assert {"train/loss", "train/mcd", "train/grad_norm", "test/loss",
            "test/mcd", "test/loss_spk00", "test/loss_spk01"} <= tags
    train = [logs[("train/loss", s)] for s in range(full.step_global)]
    # 3 steps an epoch: the last epoch's mean loss below the first's
    assert full.step_global == 9
    assert np.mean(train[-3:]) < np.mean(train[:3]), train
    ckpts = set(os.listdir(full.path_manager.checkpoints_path))
    assert {"checkpoint_best.ckpt", "checkpoint_0.ckpt",
            "auto_resume.ckpt"} <= ckpts

    class Preempted(JointTrainer):
        def _train(self, epoch):
            if epoch == 3:
                raise RuntimeError("simulated preemption")
            return super()._train(epoch)

    with pytest.raises(RuntimeError, match="preemption"):
        Preempted(**params("part")).run()
    resumed = JointTrainer(**params("part", resume=True))
    resumed.run()
    assert resumed.step_global == full.step_global
    assert resumed.best_test_loss == full.best_test_loss
    for k, v in full.train_state.params.items():
        assert torch.equal(resumed.train_state.params[k], v), k
    for k, v in full.train_state.model_state.items():
        assert torch.equal(resumed.train_state.model_state[k], v), k

    # checkpoint_best.ckpt across the packages
    best = os.path.join(full.path_manager.checkpoints_path,
                        "checkpoint_best.ckpt")
    jt = JaxJoint(**tiny_train_params(corpus, str(tmp_path / "jax"),
                                      "baseline"))
    jt.restore(best)
    raw = load_checkpoint(best)
    want = state_dict_from_jax(raw["params"], raw["model_state"], full.cfg)
    got = state_dict_from_jax(jax.device_get(jt.train_state.params),
                              jax.device_get(jt.train_state.model_state),
                              full.cfg)
    assert jt.train_state.step == int(raw["step"])
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    path = jt._save_checkpoint("from_jax.ckpt")
    back = JointTrainer(**params("back"))
    back.restore(path)
    for k, v in got.items():
        ours = (back.train_state.params.get(k)
                if k in back.train_state.params
                else back.train_state.model_state[k])
        assert torch.equal(ours, v.to(ours.dtype)), k


def test_grads_flattened_and_profiled_epoch(corpus, tmp_path):
    """``get_module_grads_flattened`` gives the JAX package's per-module
    vectors (the JAX params tree's leaf order) for the same gradients;
    with ``profile_dir`` the profiled epoch leaves its trace there, and
    the epoch's example plot is written."""
    from msa_tts_tpu.trainers.base import TrainerBase as JaxBase
    from msa_tts_tpu_torch.utils.convert import jax_from_state_dict

    t = JointTrainer(**tiny_train_params(
        corpus, str(tmp_path), "baseline", device="cpu", n_epochs=1,
        profile_dir=str(tmp_path / "trace"), profile_epoch=1,
        plot_examples=True))
    g = torch.Generator().manual_seed(0)
    grads = {k: torch.randn(v.shape, generator=g)
             for k, v in t.train_state.params.items()}
    tree = jax_from_state_dict({**grads, **t.model_state}, t.cfg)[0]
    want = JaxBase.get_module_grads_flattened(None, tree, 7)
    got = t.get_module_grads_flattened(grads, 7)
    assert sorted(got) == sorted(want) and "grad_decoder" in got
    for k, (vec, step) in want.items():
        assert got[k][1] == step == 7
        assert got[k][0].tobytes() == np.asarray(vec).tobytes(), k
    t.run()
    assert os.listdir(tmp_path / "trace")
    assert any(n.endswith(".png")
               for n in os.listdir(t.path_manager.examples_path))


@pytest.mark.parametrize("method,cls", [
    ("baseline", "msa_tts_tpu_torch.trainers.baseline.JointTrainer"),
    ("reptile", "msa_tts_tpu_torch.trainers.reptile.Reptile"),
    ("continual_er",
     "msa_tts_tpu_torch.trainers.continual_er.ExperienceReplayTrainer"),
    ("continual_erkd", "msa_tts_tpu_torch.trainers.continual_erkd."
     "ExperienceReplayKnowledgeDistillTrainer"),
    ("continual_er_reg", "msa_tts_tpu_torch.trainers.continual_er_reg."
     "ExperienceReplayRegTrainer"),
    ("continual_ewc", "msa_tts_tpu_torch.trainers.continual_ewc.EWCTrainer"),
    ("cumulative", "msa_tts_tpu_torch.trainers.cumulative.CumulativeTrainer"),
])
def test_trainers_default_to_cuda_and_refuse_parallel(corpus, tmp_path,
                                                      method, cls):
    """Every trainer of the port loads onto ``cuda`` unless ``device:
    cpu`` is asked for, and raises where there is no CUDA device, before
    it reads any data; a ``parallel`` block larger than the world (one
    process here) raises, a tp axis too, and tp with a task axis raises
    the JAX package's text."""
    import importlib

    mod, name = cls.rsplit(".", 1)
    trainer = getattr(importlib.import_module(mod), name)
    p = tiny_train_params(corpus, str(tmp_path), method,
                          regularization_method="buffer_replicate")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            trainer(**p)
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        trainer(**dict(p, parallel={"dp": 2}, device="cpu"))
    with pytest.raises(ValueError, match="mesh 1x1x2 needs 2 devices"):
        trainer(**dict(p, parallel={"dp": 1, "tp": 2}, device="cpu"))
    with pytest.raises(NotImplementedError,
                       match="tp composes with dp, not with the task axis"):
        trainer(**dict(p, parallel={"task": 2, "tp": 2}, device="cpu"))
