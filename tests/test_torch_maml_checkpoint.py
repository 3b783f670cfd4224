"""The port's MAML trainer's checkpoints, resume and entry point on the
tiny experiment of ``tests/torch_parity.py`` (CPU):

- a run stopped by a preemption notice (mid-epoch and at an epoch's
  end) and resumed equals an unbroken run bit for bit;
- its ``.ckpt`` files load in the JAX package (``restore_like`` of its
  params, batch-norm state and optax Adam state) with the same values,
  a JAX trainer's checkpoint resumes in the port, and the trained
  checkpoint serves through the port's ``from_experiment`` the mel that
  the JAX package's ``from_experiment`` serves (5e-6 absolute on
  log-mels up to 2.3, read 1.3e-6 and 1.7e-6: float32 decodes summed in
  other orders);
- ``finetune`` from a ``.pt`` loads what fits; the entry point runs from
  a ``params.yml``; a ``parallel`` block larger than the world or with
  tp with a task axis, ``plot_examples`` without matplotlib and the default
  device without CUDA raise.
"""

import argparse
import os

import jax
import numpy as np
import optax
import pytest
import torch

from msa_tts_tpu.models import config_from_params as jax_cfp
from msa_tts_tpu.models import init_tacotron2nv
from msa_tts_tpu.optim import make_optimizer as jax_optimizer
from msa_tts_tpu.serving import AdaptiveTTS as JaxTTS
from msa_tts_tpu.utils import checkpoint as JC
from msa_tts_tpu_torch.config import save_params
from msa_tts_tpu_torch.serving import AdaptiveTTS
from msa_tts_tpu_torch.trainers import maml as TM
from msa_tts_tpu_torch.utils.convert import state_dict_from_jax
from msa_tts_tpu_torch.utils.preemption import PreemptionGuard
from torch_parity import (
    jax_serve_masks,
    one_torch_thread,  # noqa: F401  (an autouse fixture)
    port_guard,  # noqa: F401  (taken by pytestmark)
    tiny_corpus,
    tiny_maml_params,
)

pytestmark = pytest.mark.usefixtures("port_guard")

SERVE_ATOL = 5e-6
ADAM = {"optimizer_type": "Adam", "lr": "1e-3"}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return tiny_corpus(str(tmp_path_factory.mktemp("ckpt_corpus")))


def _params(corpus, out, **over):
    return tiny_maml_params(corpus, str(out), device="cpu", optim_outer=ADAM,
                            **over)


@pytest.fixture(scope="module")
def trained(corpus, tmp_path_factory):
    """Two epochs of the tiny experiment with the outer Adam."""
    t = TM.MAML(**_params(corpus, tmp_path_factory.mktemp("trained")))
    t.run()
    return t


def _equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("stop_after", [2, 3], ids=["epoch_end",
                                                    "mid_epoch"])
def test_preempted_run_resumes_bit_identical(corpus, tmp_path, stop_after):
    """One task a meta-batch (two first-order steps an epoch, a meta-test
    after epoch 2), three epochs; a preemption notice after step
    ``stop_after`` stops the run (after step 2, at the end of epoch 1,
    which is saved; after step 3, in the middle of epoch 2, whose start
    is the last state saved), and ``resume: true`` continues it,
    replaying the finished epochs' data draws."""
    over = dict(n_epochs=3, meta_batch_size=1, metatest_epoch_interval=2,
                track_higher_grads=False)
    full = TM.MAML(**_params(corpus, tmp_path / "full", **over))
    full.run()

    class Preempted(TM.MAML):
        def _heartbeat(self):
            if self.step_global + 1 == stop_after:
                PreemptionGuard.shared().request_stop()

    guard = PreemptionGuard.shared()
    try:
        cut = Preempted(**_params(corpus, tmp_path / "cut", **over))
        cut.run()
        assert cut.step_global == stop_after
    finally:
        guard.clear()
    res = TM.MAML(**_params(corpus, tmp_path / "cut", resume=True, **over))
    res.run()
    assert res.step_global == full.step_global == 6
    _equal(res.train_state.params, full.train_state.params)
    _equal(res.train_state.model_state, full.train_state.model_state)
    adam, ref = res.train_state.opt_state[0], full.train_state.opt_state[0]
    _equal(adam["mu"], ref["mu"])
    _equal(adam["nu"], ref["nu"])
    assert int(adam["count"]) == int(ref["count"]) == 6


@pytest.fixture(scope="module")
def jax_templates(trained):
    """The JAX package's trees for the tiny model: params and state (a
    jitted init), and optax's Adam state of them."""
    jcfg = jax_cfp(dict(trained.params["model"]))
    p, s = jax.jit(lambda k: init_tacotron2nv(k, jcfg))(
        jax.random.PRNGKey(1))
    return jcfg, p, s, jax_optimizer(dict(ADAM)).init(p)


@pytest.mark.parametrize("name", ["checkpoint_0.ckpt", "auto_resume.ckpt"])
def test_port_checkpoint_restores_in_jax(trained, jax_templates, name):
    """The JAX package's ``restore_like`` reads the port's checkpoint into
    its own trees (params, model_state, optax's Adam state) with the
    port's values, and the step."""
    path = os.path.join(trained.path_manager.checkpoints_path, name)
    raw = JC.load_checkpoint(path)
    jcfg, p, s, opt = jax_templates
    params = JC.restore_like(p, raw["params"])
    state = JC.restore_like(s, raw["model_state"])
    adam = JC.restore_like(opt, raw["opt_state"])
    assert int(raw["step"]) == 2
    ts = trained.train_state
    sd = state_dict_from_jax(jax.device_get(params), jax.device_get(state),
                             trained.cfg)
    _equal({k: sd[k] for k in ts.params}, ts.params)
    _equal({k: sd[k] for k in ts.model_state if "running" in k},
           {k: v for k, v in ts.model_state.items() if "running" in k})
    assert int(adam[0].count) == int(ts.opt_state[0]["count"]) == 2
    for m in ("mu", "nu"):
        msd = state_dict_from_jax(jax.device_get(getattr(adam[0], m)),
                                  jax.device_get(state), trained.cfg)
        _equal({k: msd[k] for k in ts.params}, ts.opt_state[0][m])
    if name == "auto_resume.ckpt":
        assert int(raw["resume_state"]["epoch"]) == 2


def test_jax_checkpoint_resumes_in_port(trained, jax_templates, tmp_path):
    """A JAX trainer's payload (its trees, an optax Adam state after one
    update, step 7) restored by the port's trainer: the same values, and
    the next step runs from them."""
    jcfg, p, s, opt = jax_templates
    tx = jax_optimizer(dict(ADAM))

    @jax.jit
    def update(p, opt):
        grads = jax.tree_util.tree_map(lambda x: x * 0.5 + 0.1, p)
        upd, opt = tx.update(grads, opt, p)
        return optax.apply_updates(p, upd), opt

    p, opt = update(p, opt)
    path = str(tmp_path / "jax.ckpt")
    JC.save_checkpoint(path, {"params": p, "model_state": s,
                              "opt_state": opt, "step": 7})
    t = TM.MAML(**_params(trained.params["dataset_metatrain"]["dataset_path"],
                          tmp_path / "port", n_epochs=1))
    t.restore(path)
    sd = state_dict_from_jax(jax.device_get(p), jax.device_get(s), t.cfg)
    _equal(t.train_state.params, {k: sd[k] for k in t.train_state.params})
    mu = state_dict_from_jax(jax.device_get(opt[0].mu), jax.device_get(s),
                             t.cfg)
    _equal(t.train_state.opt_state[0]["mu"],
           {k: mu[k] for k in t.train_state.params})
    assert int(t.train_state.opt_state[0]["count"]) == 1
    assert t.step_global == t.train_state.step == 7
    t.run()                          # an epoch's step from the JAX state
    assert t.train_state.step == 8
    assert int(t.train_state.opt_state[0]["count"]) == 2


def test_trained_checkpoint_serves_like_jax(trained):
    """The run's checkpoint served by both packages' ``from_experiment``
    on the same prenet masks: the same weights, the same mel.  Two steps
    do not teach the gate, so both gate biases are lowered by 1e4 after
    loading and every one of the 17 decoder steps is compared."""
    path = trained.path_manager.output_path
    jtts = JaxTTS.from_experiment(path)
    tts = AdaptiveTTS.from_experiment(path, device="cpu")
    for k, v in state_dict_from_jax(jax.device_get(jtts.model_params),
                                    jax.device_get(jtts.model_state),
                                    tts.cfg).items():
        assert torch.equal(tts.model.state_dict()[k], v), k
    gate = jtts.model_params["decoder"]["gate_layer"]
    jtts.model_params["decoder"]["gate_layer"] = dict(
        gate, bias=gate["bias"] - 1e4)
    with torch.no_grad():
        tts.model.decoder.gate_layer.linear_layer.bias.sub_(1e4)
    emb = np.random.default_rng(3).standard_normal(8).astype(np.float32)
    for text in ("hello there", "a longer sentence for the tiny model"):
        ref = np.asarray(jtts.synthesize(text, spk_emb=emb, vocoder="none"))
        mel = tts.synthesize(text, spk_emb=emb, vocoder="none",
                             pre_masks=jax_serve_masks(tts))
        assert mel.shape == ref.shape == (10, 34)
        np.testing.assert_allclose(mel, ref, atol=SERVE_ATOL, rtol=0)


@pytest.mark.parametrize("ext", [".pt", ".ckpt"])
def test_finetune_loads_what_fits(trained, tmp_path, ext):
    """``finetune`` from a reference ``.pt`` or a ``.ckpt``: every tensor
    of a matching shape loads, one of another shape keeps the trainer's
    initial value; the batch-norm statistics load."""
    from msa_tts_tpu_torch.utils.checkpoint import save_checkpoint
    from msa_tts_tpu_torch.utils.convert import jax_from_state_dict

    sd = {k: v.clone() for k, v in trained.train_state.params.items()}
    sd.update(trained.train_state.model_state)
    sd["decoder.gate_layer.linear_layer.bias"] = torch.zeros(3)
    path = str(tmp_path / f"ref{ext}")
    if ext == ".pt":
        torch.save(sd, path)
    else:
        params, state = jax_from_state_dict(sd, trained.cfg)
        save_checkpoint(path, {"params": params, "model_state": state})
    t = TM.MAML(**_params(trained.params["dataset_metatrain"]["dataset_path"],
                          tmp_path / "ft", finetune=True,
                          finetune_checkpoint_path=path))
    for k, v in t.train_state.params.items():
        if k == "decoder.gate_layer.linear_layer.bias":
            assert torch.equal(v, t.model_params[k])
            assert not torch.equal(v, trained.train_state.params[k])
        else:
            assert torch.equal(v, sd[k]), k
    for k, v in trained.train_state.model_state.items():
        if "running" in k:
            assert torch.equal(t.train_state.model_state[k], v), k


def test_entry_point_runs_from_params_yml(corpus, tmp_path):
    """``python -m msa_tts_tpu_torch.trainers.maml --params_path``: one
    first-order epoch from a params.yml that also carries the XLA-only
    keys, which are read and ignored."""
    p = _params(corpus, tmp_path / "out", n_epochs=1,
                track_higher_grads=False, compilation_cache=True,
                compilation_cache_dir="/nonexistent", maml_remat=True)
    save_params(p, str(tmp_path / "params.yml"))
    TM.main(argparse.Namespace(params_path=str(tmp_path)))
    ckpt = tmp_path / "out" / "maml" / "tiny" / "checkpoints"
    assert sorted(os.listdir(ckpt)) == ["auto_resume.ckpt",
                                       "checkpoint_0.ckpt"]


def test_what_raises(corpus, tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        TM.MAML(**_params(corpus, tmp_path / "a",
                          parallel={"dp": 2, "task": 1}))
    with pytest.raises(ValueError,
                       match="1 devices not divisible by task=1 x tp=2"):
        TM.MAML(**_params(corpus, tmp_path / "a", parallel={"tp": 2}))
    with pytest.raises(NotImplementedError,
                       match="tp composes with dp, not with the task axis"):
        TM.MAML(**_params(corpus, tmp_path / "a",
                          parallel={"task": 2, "tp": 2}))
    monkeypatch.setitem(__import__("sys").modules, "matplotlib", None)
    with pytest.raises(RuntimeError, match="plot_examples: false"):
        TM.MAML(**_params(corpus, tmp_path / "b", plot_examples=True))
    p = _params(corpus, tmp_path / "c")
    del p["device"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            TM.MAML(**p)
