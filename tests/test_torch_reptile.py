"""Reptile in the port (``meta/reptile.py``, ``trainers/reptile.py``)
against the JAX package's on a tiny synthetic corpus (the tiny model of
``tests/torch_parity.py``, 2 speakers, 2 shots): one meta-step of 2
tasks, each 2 inner SGD steps and a query pass, in both modes
(``sequential``: a task after the other, each from the weights and
batch-norm state the previous one left; ``batched``: every task from the
same weights, the directions averaged), against the JAX trainer's
``_reptile_step_jit`` under JAX's dropout masks, from JAX's initial
weights, in float32 and (sequential) with ``compute_dtype: bfloat16``;
and the port's trainer through ``main`` on the CPU in both modes.

The outer step is SGD with lr 1 (the clip at 1 on), so the new weights
carry the clipped direction itself.  Tolerances, 4x the larger reading
of the two modes (sequential / batched): new weights 4.8e-7 absolute
(read 1.2e-7 / 6.0e-8; the step moved them by up to 4.8e-2 / 2.3e-2),
batch-norm statistics 7.0e-6 relative to each tensor's largest value
(read 1.8e-6 / 8.0e-7), the mean, per-task and inner losses 1.2e-6
relative (read 0 / 1.6e-7, 9.2e-8 / 2.1e-7, 2.8e-7 / 2.8e-7), the
gradient norm 3.7e-7 (read 9.3e-8 / 6.2e-8).  With ``compute_dtype:
bfloat16`` (sequential): weights 2.9e-3 (read 7.2e-4 where the step moved
them by up to 4.8e-2), statistics 0.18 (read 4.5e-2), losses 5.7e-3
(read 2.7e-4, 8.6e-4, 1.4e-3), gradient norm 2.6e-3 (read 6.5e-4):
bfloat16 keeps 8 bits, and XLA rounds fused chains once where PyTorch
rounds each operation."""

import argparse
import json
import os

import jax
import numpy as np
import pytest
import torch

from msa_tts_tpu.dataloaders.loader_meta import TaskBatch
from msa_tts_tpu.trainers.baseline import unpack_task_batch as jax_unpack
from msa_tts_tpu.trainers.reptile import Reptile as JaxReptile
from msa_tts_tpu_torch.config import save_params
from msa_tts_tpu_torch.dataloaders.loader_meta import unpack_task_batch
from msa_tts_tpu_torch.trainers import reptile as TR
from msa_tts_tpu_torch.trainers.reptile import Reptile
from msa_tts_tpu_torch.utils.convert import state_dict_from_jax
from torch_parity import (
    from_jax_masks,
    install_jax_init,
    one_torch_thread,  # noqa: F401  (an autouse fixture)
    port_guard,  # noqa: F401  (taken by pytestmark)
    tiny_corpus,
    tiny_train_params,
)

pytestmark = pytest.mark.usefixtures("port_guard")

TOL = {"float32": (4.8e-7, 7.0e-6, 1.2e-6, 3.7e-7),
       "bfloat16": (2.9e-3, 0.18, 5.7e-3, 2.6e-3)}
SEED = 3


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return tiny_corpus(str(tmp_path_factory.mktemp("reptile_corpus")))


@pytest.fixture
def jax_numpy_feats(monkeypatch):
    """Both packages on their numpy features (equal byte for byte)."""
    import msa_tts_tpu.native as native
    import msa_tts_tpu_torch.native as port_native

    for mod in (native, port_native):
        monkeypatch.setattr(mod, "extract_logmels_batch",
                            lambda *a, **k: None)


def _params(corpus, out, **over):
    return tiny_train_params(
        corpus, out, "reptile", meta_batch_size=2, n_inner_train=2,
        n_inner_test=1, train_seed=SEED,
        optim_outer={"optimizer_type": "SGD", "lr": "1.0"}, **over)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


@pytest.mark.parametrize("mode,dtype", [("sequential", "float32"),
                                        ("batched", "float32"),
                                        ("sequential", "bfloat16")])
def test_step_matches_jax(corpus, tmp_path, jax_numpy_feats, mode, dtype):
    """The first meta-step of epoch 1: new weights and batch-norm
    statistics, the mean, per-task and inner losses, the gradient
    norm."""
    W_ATOL, STAT_RTOL, LOSS_RTOL, NORM_RTOL = TOL[dtype]
    p = _params(corpus, str(tmp_path), reptile_mode=mode,
                compute_dtype=dtype)
    jt = JaxReptile(**p)
    pt = from_jax_masks(Reptile, jt.cfg, SEED)(**p, device="cpu")
    init = install_jax_init(pt, jt)
    speakers, sup, qry = next(jt.dataloader_metatrain.iter_stacked())
    assert isinstance(sup, TaskBatch)
    k_train = jax.random.split(jax.random.PRNGKey(SEED), 3)[1]
    js, jm = jt._reptile_step_jit(
        jt.train_state, jax_unpack(sup, pt.speaker_emb_type),
        jax_unpack(qry, pt.speaker_emb_type),
        jax.random.fold_in(k_train, 0))
    tsup = unpack_task_batch(sup, pt.speaker_emb_type, "cpu")
    tqry = unpack_task_batch(qry, pt.speaker_emb_type, "cpu")
    masks = pt._draw_masks("train", 1, 0, len(speakers),
                           pt.n_inner_train + 1, tsup)
    ps, pm = pt._reptile_step(pt.train_state, tsup, tqry, masks)
    ref = state_dict_from_jax(jax.device_get(js.params),
                              jax.device_get(js.model_state), pt.cfg)
    w = max(float((ps.params[k] - ref[k]).abs().max()) for k in ps.params)
    moved = max(float((ref[k] - init[k]).abs().max()) for k in ps.params)
    assert moved > 1e-3 and w <= W_ATOL, (w, moved)
    stat = max(float((ps.model_state[k] - ref[k]).abs().max()
                     / ref[k].abs().max())
               for k in ps.model_state if "running" in k)
    assert stat <= STAT_RTOL
    assert int(ps.step) == int(js.step) == (2 if mode == "sequential" else 1)
    assert _rel(pm.loss, jm.loss) <= LOSS_RTOL
    assert pm.task_losses.shape == (2,)
    assert _rel(pm.task_losses, jm.task_losses) <= LOSS_RTOL
    assert pm.inner_losses.shape == (2, 2)
    assert _rel(pm.inner_losses, jm.inner_losses) <= LOSS_RTOL
    assert _rel(pm.grad_norm, jm.grad_norm) <= NORM_RTOL


@pytest.mark.parametrize("mode", ["sequential", "batched"])
def test_trainer_main_runs(corpus, tmp_path, mode):
    """``main`` with ``device: cpu``: 2 epochs of one meta-batch of 2
    speakers (2 global steps each, one per speaker), a meta-test after
    epoch 2, every logged value finite, the checkpoint written."""
    p = _params(corpus, str(tmp_path / "out"), reptile_mode=mode,
                device="cpu", n_epochs=2, metatest_epoch_interval=2)
    save_params(p, str(tmp_path / "params.yml"))
    ran = []

    class Kept(Reptile):
        def run(self):
            ran.append(self)
            super().run()

    orig, TR.Reptile = TR.Reptile, Kept
    try:
        TR.main(argparse.Namespace(params_path=str(tmp_path)))
    finally:
        TR.Reptile = orig
    t = ran[0]
    assert t.step_global == 4
    assert t.train_state.step == (4 if mode == "sequential" else 2)
    logs = [json.loads(line) for line in open(t.logger.jsonl_path)]
    assert all(np.isfinite(d["value"]) for d in logs)
    tags = {d["tag"] for d in logs}
    assert {"train/loss", "train/loss_spk00", "test/loss_spk01",
            "test/mcd_spk00"} <= tags
    assert os.path.exists(os.path.join(t.path_manager.checkpoints_path,
                                       "checkpoint_0.ckpt"))
    assert all(torch.isfinite(v).all() for v in t.train_state.params.values())
