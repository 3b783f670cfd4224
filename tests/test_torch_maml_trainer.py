"""The port's MAML trainer (``msa_tts_tpu_torch/trainers/maml.py``)
against the JAX package's on the same tiny synthetic corpus and params
(the tiny model of ``tests/torch_parity.py``, 2 speakers, 2 shots, one
second-order inner step, a meta-test of one step): the port starts from
JAX's initial weights (``state_dict_from_jax``) and draws JAX's dropout
masks through its one seam (``_draw_masks``,
``torch_parity.jax_trainer_masks``); the JAX side computes its features
with its numpy path, which the port's equal byte for byte
(``tests/test_torch_meta_data.py``).

The outer optimizer here is SGD: Adam's first steps move every weight by
about lr·sign(g), so where a gradient is float noise (the convolution
biases that feed a batch norm have a true gradient of 0) the two sides
would move it differently by ~lr; SGD keeps the comparison about the
gradients.  Adam's state is held to optax's in
``tests/test_torch_meta_step.py`` and crosses checkpoints in
``tests/test_torch_maml_checkpoint.py``.

Tolerances, each set from a reading here and no looser than 4x it: in
float32 after 2 epochs, the checkpoint's weights 2.3e-7 absolute (read
6e-8; two steps moved them by up to 1.7e-2), its batch-norm statistics
5.9e-6 relative to each tensor's largest value (read 1.0e-6 and 1.5e-6
in two runs, on running means near 0), every logged loss, gradient norm
and MCD 2.1e-6 relative (read 5.4e-7); with ``compute_dtype:
bfloat16``, after one step, the weights 2.1e-3 (read 5.4e-4 where the
step moved them by up to 9.7e-3), the statistics 9e-2 relative (read
2.4e-2), losses 1.8e-3 relative (read 4.6e-4) and the gradient norm
1.7e-2 (read 4.3e-3): bfloat16 keeps 8 bits and XLA rounds fused
elementwise chains once where PyTorch rounds every operation."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from msa_tts_tpu.trainers.maml import MAML as JaxMAML
from msa_tts_tpu_torch.trainers.maml import MAML
from msa_tts_tpu_torch.utils.checkpoint import load_checkpoint
from msa_tts_tpu_torch.utils.convert import state_dict_from_jax
from torch_parity import (
    jax_trainer_masks,
    one_torch_thread,  # noqa: F401  (an autouse fixture)
    port_guard,  # noqa: F401  (taken by pytestmark)
    tiny_corpus,
    tiny_maml_params,
)

pytestmark = pytest.mark.usefixtures("port_guard")

W_ATOL, STAT_RTOL, LOG_RTOL = 2.3e-7, 5.9e-6, 2.1e-6
BF16_W_ATOL, BF16_STAT_RTOL = 2.1e-3, 9e-2
BF16_LOSS_RTOL, BF16_NORM_RTOL = 1.8e-3, 1.7e-2


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return tiny_corpus(str(tmp_path_factory.mktemp("maml_corpus")))


def _t(x):
    if isinstance(x, dict):
        return {k: _t(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_t(v) for v in x]
    return torch.as_tensor(np.asarray(x))


def port_trainer(jax_trainer, params):
    """The port's trainer on ``params``, started from the JAX trainer's
    initial weights, drawing the JAX trainer's masks."""
    jcfg = jax_trainer.cfg
    seed = int(params.get("train_seed", 1234))

    class FromJax(MAML):
        def _draw_masks(self, phase, epoch, itr_b, n_tasks, n_pass, batch):
            _, B, T_in = batch["inputs"].shape
            return _t(jax_trainer_masks(seed, jcfg, phase, epoch, itr_b,
                                        n_tasks, n_pass, B, T_in,
                                        batch["melspecs"].shape[-1]))

    t = FromJax(**params, device="cpu")
    sd = state_dict_from_jax(jax.device_get(jax_trainer.model_params),
                             jax.device_get(jax_trainer.model_state), t.cfg)
    p = {k: sd[k] for k in t.param_names}
    t.train_state = t.train_state._replace(
        params=p, model_state={k: sd[k] for k in t.model_state},
        opt_state=t.outer_tx.init(p))
    t.init_sd = sd
    return t


def _logs(trainer):
    out = {}
    for line in open(trainer.logger.jsonl_path):
        d = json.loads(line)
        out[(d["tag"], d["step"])] = d["value"]
    return out


def _ckpt_sd(trainer, name="checkpoint_0.ckpt"):
    raw = load_checkpoint(os.path.join(trainer.path_manager.checkpoints_path,
                                       name))
    return state_dict_from_jax(raw["params"], raw["model_state"],
                               trainer.cfg), raw


def _run_pair(corpus, tmp_path, monkeypatch, **over):
    # both packages on their numpy features (equal byte for byte)
    import msa_tts_tpu.native as native
    import msa_tts_tpu_torch.native as port_native

    for mod in (native, port_native):
        monkeypatch.setattr(mod, "extract_logmels_batch",
                            lambda *a, **k: None)
    jt = JaxMAML(**tiny_maml_params(corpus, str(tmp_path / "jax"), **over))
    pt = port_trainer(jt, tiny_maml_params(corpus, str(tmp_path / "port"),
                                         **over))
    jt.run()
    pt.run()
    return jt, pt


def test_two_epochs_match_jax(corpus, tmp_path, monkeypatch):
    """Two epochs of second-order outer steps and a meta-test: the
    checkpoint written after epoch 2 (weights, batch-norm statistics,
    step) and every logged value (train/loss, train/grad_norm,
    train/loss_{spk}, test/loss_{spk}, test/mcd_{spk})."""
    jt, pt = _run_pair(corpus, tmp_path, monkeypatch)
    ref, jraw = _ckpt_sd(jt)
    out, raw = _ckpt_sd(pt)
    assert int(raw["step"]) == int(jraw["step"]) == 2
    for k in pt.param_names:
        np.testing.assert_allclose(out[k].numpy(), ref[k].numpy(),
                                   atol=W_ATOL, rtol=0, err_msg=k)
    for k in pt.model_state:
        if "running" in k:
            err = float((out[k] - ref[k]).abs().max() / ref[k].abs().max())
            assert err <= STAT_RTOL, k
    moved = max(float((out[k] - pt.init_sd[k]).abs().max())
                for k in pt.param_names)
    assert moved > 1e-3                       # two outer steps moved them
    jl, tl = _logs(jt), _logs(pt)
    assert sorted(jl) == sorted(tl)
    tags = {tag for tag, _ in tl}
    assert {"train/loss", "train/grad_norm", "train/loss_spk00",
            "test/loss_spk01", "test/mcd_spk00"} <= tags
    for key, value in jl.items():
        assert np.isfinite(tl[key])
        assert tl[key] == pytest.approx(value, rel=LOG_RTOL), key


def test_bfloat16_step_matches_jax(corpus, tmp_path, monkeypatch):
    """One first-order outer step with ``compute_dtype: bfloat16``
    (parameters cast inside the differentiated graph, float32 master
    weights, loss and statistics): the weights and batch-norm statistics
    after it, its logged losses and gradient norm."""
    jt, pt = _run_pair(corpus, tmp_path, monkeypatch, n_epochs=1,
                       compute_dtype="bfloat16", track_higher_grads=False)
    ref, _ = _ckpt_sd(jt)
    out, _ = _ckpt_sd(pt)
    for k in pt.param_names:
        assert out[k].dtype == torch.float32
        np.testing.assert_allclose(out[k].numpy(), ref[k].numpy(),
                                   atol=BF16_W_ATOL, rtol=0, err_msg=k)
    for k in pt.model_state:
        if "running" in k:
            err = float((out[k] - ref[k]).abs().max() / ref[k].abs().max())
            assert err <= BF16_STAT_RTOL, k
    jl, tl = _logs(jt), _logs(pt)
    assert sorted(jl) == sorted(tl)
    for key, value in jl.items():
        rtol = BF16_NORM_RTOL if key[0] == "train/grad_norm" else (
            BF16_LOSS_RTOL)
        assert tl[key] == pytest.approx(value, rel=rtol), key
