"""The port's MAML outer step (``msa_tts_tpu_torch/meta/maml.py``) against
the JAX package's ``make_maml_step``, second order and first order,
with gradient clipping on and off:

- on JAX's quadratic (``0.5·||w - target||²``), where the meta-gradient
  has a closed form;
- on the tiny Tacotron of ``tests/torch_parity.py`` (K = 2 tasks, 2
  shots, 2 inner SGD steps, the outer Adam) with JAX's dropout masks
  (``torch_parity.jax_metatest_masks`` under each task's key): the new
  parameters, Adam's moments and count, the merged batch-norm
  statistics, the mean and per-task query losses, the inner losses and
  the gradient norm;
- ``merge_task_states`` and ``meta/grad_utils.py``, exactly.

Tolerances, float32 on both sides summed in other orders, set from a
reading at these shapes and no looser than 4x it: the quadratic 4e-7
absolute on values of order 1 (read 8.9e-8); after the Tacotron step,
the new weights 2.4e-7 (read 6e-8), Adam's first moment 3e-7 (read
7.8e-8 on values up to 0.1) and second 4e-9 (read 1.2e-9 on values up
to 1e-3), the merged batch-norm statistics 3e-6 relative to each
tensor's largest value (read 7.6e-7), losses 9e-7 relative (read
2.4e-7), the gradient norm 1e-6 relative (read 2.7e-7)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from msa_tts_tpu.meta import grad_utils as JG
from msa_tts_tpu.meta.maml import make_maml_step as jax_maml_step
from msa_tts_tpu.meta.maml import merge_task_states as jax_merge
from msa_tts_tpu.models import tacotron2nv_forward as jax_forward
from msa_tts_tpu.models.loss import tacotron2_loss as jax_loss
from msa_tts_tpu.optim import TrainState as JaxTrainState
from msa_tts_tpu.optim import make_optimizer as jax_optimizer
from msa_tts_tpu_torch import optim as TO
from msa_tts_tpu_torch.meta import grad_utils as TG
from msa_tts_tpu_torch.meta.maml import make_maml_step, merge_task_states
from msa_tts_tpu_torch.models.loss import tacotron2_loss
from msa_tts_tpu_torch.utils.convert import state_dict_from_jax
from torch_parity import (
    jax_and_port_models,
    jax_metatest_masks,
    model_dict,
    one_torch_thread,  # noqa: F401  (an autouse fixture)
    randn,
)

QUAD_ATOL = 4e-7
PARAM_ATOL, MU_ATOL, NU_ATOL = 2.4e-7, 3e-7, 4e-9
STAT_RTOL, LOSS_RTOL, NORM_RTOL = 3e-6, 9e-7, 1e-6
K, SHOTS, N_INNER = 2, 2, 2
KW = dict(n_frames_per_step=2, reduction="none", pos_weight=6.0)
INNER = {"optimizer_type": "SGD", "lr": 1e-2}
OUTER = {"optimizer_type": "Adam", "lr": 1e-3}
CASES = [(True, None), (True, 0.5), (False, None), (False, 0.5)]
IDS = ["second_order", "second_order_clip", "first_order",
       "first_order_clip"]


def _t(x):
    """numpy → torch (integers as int64), nested lists and dicts too."""
    if isinstance(x, dict):
        return {k: _t(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_t(v) for v in x]
    x = np.asarray(x)
    return torch.as_tensor(x.astype(np.int64) if x.dtype.kind == "i" else x)


# ------------------------------------------------------------ quadratic

def _quad_jax(params, model_state, batch, rng):
    return 0.5 * jnp.sum((params["w"] - batch["target"]) ** 2), model_state


def _quad_port(params, model_state, batch, masks):
    return 0.5 * ((params["w"] - batch["target"]) ** 2).sum(), model_state


@pytest.mark.parametrize("second_order,clip", CASES, ids=IDS)
def test_quadratic_step_matches_jax_and_closed_form(second_order, clip):
    """Three tasks, two SGD inner steps (lr 0.1), an outer SGD step of
    lr 1: the outer update is the mean task gradient, (1 - lr)^k (w_k -
    q) with second order, w_k - q without (w_k the adapted weight)."""
    lr, k = 0.1, 2
    w0 = np.array([1.0, -2.0, 0.5], np.float32)
    sup = np.array([[0.0, 0.0, 0.0], [1.0, 2.0, 0.0], [0.5, -1.0, 3.0]],
                   np.float32)
    qry = np.array([[0.5, 0.5, 0.0], [0.0, 1.0, 1.0], [2.0, 0.0, -1.0]],
                   np.float32)
    kw = dict(second_order=second_order, clip_thresh=clip)
    jstep = jax_maml_step(_quad_jax, optax.sgd(lr), optax.sgd(1.0), k,
                          remat=False, **kw)
    jstate = JaxTrainState(params={"w": jnp.asarray(w0)}, model_state={},
                           opt_state=optax.sgd(1.0).init({"w": w0}), step=0)
    jnew, jm = jstep(jstate, {"target": sup}, {"target": qry},
                     jax.random.PRNGKey(0))
    inner = TO.make_optimizer({"optimizer_type": "SGD", "lr": lr})
    outer = TO.make_optimizer({"optimizer_type": "SGD", "lr": 1.0})
    params = {"w": torch.as_tensor(w0)}
    state = TO.TrainState(params, {}, outer.init(params), 0)
    new, m = make_maml_step(_quad_port, inner, outer, k, **kw)(
        state, {"target": torch.as_tensor(sup)},
        {"target": torch.as_tensor(qry)}, [[{}] * (k + 1)] * 3)
    # the closed form
    c = (1 - lr) ** k
    adapted = sup + (w0 - sup) * c
    g = np.mean((c if second_order else 1.0) * (adapted - qry), axis=0)
    norm = np.sqrt(np.sum(g.astype(np.float64) ** 2))
    if clip is not None:
        g = g * min(1.0, clip / norm)
    np.testing.assert_allclose(new.params["w"].numpy(), w0 - g,
                               atol=QUAD_ATOL, rtol=0)
    np.testing.assert_allclose(new.params["w"].numpy(),
                               np.asarray(jnew.params["w"]), atol=QUAD_ATOL,
                               rtol=0)
    for a, b in ((m.loss, jm.loss), (m.task_losses, jm.task_losses),
                 (m.inner_losses, jm.inner_losses),
                 (m.grad_norm, jm.grad_norm)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=QUAD_ATOL,
                                   rtol=0)
    assert m.inner_losses.shape == (3, k) and new.step == 1
    assert float(m.grad_norm) == pytest.approx(norm, abs=QUAD_ATOL)


# -------------------------------------------------------- tiny Tacotron

def _episode(seed, T_in=9, T_mel=12):
    """K tasks of SHOTS padded utterances each, as the meta loader
    stacks them: ragged text and mel lengths, stop labels from the last
    valid frame on, one d-vector per task."""
    rng = np.random.default_rng(seed)
    il = np.zeros((K, SHOTS), np.int32)
    ml = np.zeros((K, SHOTS), np.int32)
    inputs = rng.integers(1, 50, (K, SHOTS, T_in)).astype(np.int32)
    mels = randn(seed + 1, K, SHOTS, 10, T_mel)
    stop = np.ones((K, SHOTS, T_mel), np.float32)
    spk = np.repeat(randn(seed + 2, K, 1, 8), SHOTS, axis=1)
    for k in range(K):
        il[k] = [T_in - k, T_in - 3 - k]
        ml[k] = [T_mel - 2 * k, T_mel - 5 - k]
        for b in range(SHOTS):
            inputs[k, b, il[k, b]:] = 0
            mels[k, b, :, ml[k, b]:] = 0.0
            stop[k, b, : ml[k, b] - 1] = 0.0
    return dict(inputs=inputs, input_lengths=il, melspecs=mels,
                melspec_lengths=ml, speaker_vecs=spk, stop_labels=stop)


@pytest.fixture(scope="module")
def tiny():
    return jax_and_port_models(model_dict(mask_padding=True))


def _jax_loss_fn(jcfg):
    def loss_fn(p, ms, b, rng):
        outs, new_ms = jax_forward(
            p, ms, jcfg, b["inputs"], b["input_lengths"], b["melspecs"],
            b["melspec_lengths"], b["speaker_vecs"], rng, train=True)
        return jax_loss(tuple(outs), (b["melspecs"], b["stop_labels"]),
                        b["melspec_lengths"], **KW), new_ms

    return loss_fn


def _port_loss_fn(model):
    def loss_fn(p, ms, b, m):
        outs, new_ms = torch.func.functional_call(
            model, {**p, **ms}, (b["inputs"], b["input_lengths"],
                                 b["melspecs"], b["melspec_lengths"],
                                 b["speaker_vecs"], m))
        return (tacotron2_loss(outs, (b["melspecs"], b["stop_labels"]),
                               b["melspec_lengths"], **KW),
                {**ms, **new_ms})

    return loss_fn


def _stat_err(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.fixture(scope="module")
def jax_steps(tiny):
    """JAX's step, jitted once per order; the clip threshold is an
    argument (1e30 stands for "off": the scale is then exactly 1, so the
    gradients and their norm are those of the unclipped branch)."""
    jcfg = tiny[0][0]
    jouter = jax_optimizer(dict(OUTER))

    def make(second_order):
        def step(state, sup, qry, key, clip):
            return jax_maml_step(_jax_loss_fn(jcfg), jax_optimizer(INNER),
                                 jouter, N_INNER, remat=False,
                                 second_order=second_order,
                                 clip_thresh=clip)(state, sup, qry, key)
        return jax.jit(step)

    return jouter, {so: make(so) for so in (True, False)}


@pytest.mark.parametrize("second_order,clip", CASES, ids=IDS)
def test_tacotron_step_matches_jax(tiny, jax_steps, second_order, clip):
    """One outer step (Adam) from the same weights, episodes and masks.
    Adam's first step moves a weight by about lr·sign(g): where |g| is
    float noise (the convolution biases that feed a batch norm have a
    true gradient of 0) the two sides move it differently, so the new
    weights are compared where |g| > 1e-6; Adam's moments, which carry
    the gradient itself, are compared everywhere."""
    (jcfg, jp, js), (cfg, model) = tiny
    jouter, jsteps = jax_steps
    sup, qry = _episode(0), _episode(10)
    key = jax.random.PRNGKey(7)
    jnew, jm = jax.device_get(jsteps[second_order](
        JaxTrainState(jp, js, jouter.init(jp), 0), sup, qry, key,
        1e30 if clip is None else clip))

    outer = TO.make_optimizer(dict(OUTER))
    params = {k: v.detach() for k, v in model.named_parameters()}
    buffers = dict(model.named_buffers())
    T_in, T_mel = sup["inputs"].shape[-1], sup["melspecs"].shape[-1]
    masks = _t([jax_metatest_masks(k, jcfg, N_INNER, SHOTS, T_in, T_mel)
                for k in jax.random.split(key, K)])
    step = make_maml_step(_port_loss_fn(model), TO.make_optimizer(INNER),
                          outer, N_INNER, second_order=second_order,
                          clip_thresh=clip)
    new, m = step(TO.TrainState(params, buffers, outer.init(params), 0),
                  _t(sup), _t(qry), masks)

    ref = state_dict_from_jax(jnew.params, jnew.model_state, cfg)
    adam, jadam = new.opt_state[0], jnew.opt_state[0]
    assert int(adam["count"]) == int(jadam.count) == 1
    jmu = state_dict_from_jax(jadam.mu, jnew.model_state, cfg)
    jnu = state_dict_from_jax(jadam.nu, jnew.model_state, cfg)
    n_cmp = 0
    for k, v in new.params.items():
        np.testing.assert_allclose(adam["mu"][k].numpy(), jmu[k].numpy(),
                                   atol=MU_ATOL, rtol=0, err_msg=k)
        np.testing.assert_allclose(adam["nu"][k].numpy(), jnu[k].numpy(),
                                   atol=NU_ATOL, rtol=0, err_msg=k)
        sel = jmu[k].abs() * 10 > 1e-6           # mu = (1 - b1)·g
        np.testing.assert_allclose(v[sel].numpy(), ref[k][sel].numpy(),
                                   atol=PARAM_ATOL, rtol=0, err_msg=k)
        n_cmp += int(sel.sum())
    assert n_cmp > 0.85 * sum(v.numel() for v in params.values())
    for k, v in new.model_state.items():
        if "running" in k:
            assert _stat_err(v, ref[k]) <= STAT_RTOL, k
            assert not torch.equal(v, buffers[k]), k    # merged, moved
    for a, b in ((m.loss, jm.loss), (m.task_losses, jm.task_losses),
                 (m.inner_losses, jm.inner_losses)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   rtol=LOSS_RTOL)
    assert float(m.grad_norm) == pytest.approx(float(jm.grad_norm),
                                               rel=NORM_RTOL)
    assert m.inner_losses.shape == (K, N_INNER)
    if clip is not None:
        assert float(m.grad_norm) > clip     # the clip acted


def test_first_and_second_order_differ(tiny):
    """The terms of second order count at this size: the two steps'
    updates part by far more than the limits above."""
    (jcfg, _, _), (cfg, model) = tiny
    sup, qry = _t(_episode(0)), _t(_episode(10))
    T_in, T_mel = sup["inputs"].shape[-1], sup["melspecs"].shape[-1]
    masks = _t([jax_metatest_masks(k, jcfg, N_INNER, SHOTS, T_in, T_mel)
                for k in jax.random.split(jax.random.PRNGKey(7), K)])
    outer = TO.make_optimizer({"optimizer_type": "SGD", "lr": 1.0})
    params = {k: v.detach() for k, v in model.named_parameters()}
    buffers = dict(model.named_buffers())
    new = {}
    for so in (True, False):
        step = make_maml_step(_port_loss_fn(model), TO.make_optimizer(INNER),
                              outer, N_INNER, second_order=so)
        new[so], _ = step(TO.TrainState(params, buffers, outer.init(params),
                                        0), sup, qry, masks)
    gap = max(float((new[True].params[k] - new[False].params[k]).abs().max())
              for k in params)
    assert gap > 100 * PARAM_ATOL


# ------------------------------------------------------------ utilities

def test_merge_task_states_matches_jax():
    """Float statistics averaged over the tasks (three here), integer
    buffers from task 0: equal to the JAX package's merge."""
    stacked = {"running_mean": randn(0, 3, 5), "running_var": randn(1, 3, 5),
               "count": np.array([4, 7, 9], np.int32)}
    like = {k: v[0] for k, v in stacked.items()}
    ref = jax.device_get(jax_merge(
        {k: jnp.asarray(v) for k, v in stacked.items()},
        {k: jnp.asarray(v) for k, v in like.items()}))
    out = merge_task_states(
        [{k: torch.as_tensor(v[i]) for k, v in stacked.items()}
         for i in range(3)], {k: torch.as_tensor(v) for k, v in like.items()})
    for k in stacked:
        assert out[k].numpy().dtype == np.asarray(ref[k]).dtype
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]))


def test_grad_utils_match_jax():
    gs = [{"a": randn(i, 4, 3), "b": randn(10 + i, 6)} for i in range(3)]
    tg = [{k: torch.as_tensor(v) for k, v in g.items()} for g in gs]
    jg = [{k: jnp.asarray(v) for k, v in g.items()} for g in gs]
    stacked = {k: np.stack([g[k] for g in gs]) for k in gs[0]}

    def same(out, ref):
        for k in ref:
            np.testing.assert_array_equal(np.asarray(out[k]),
                                          np.asarray(ref[k]))

    for w in (None, [1.0, 2.0, 5.0]):
        same(TG.mix_grads(tg, w), JG.mix_grads(jg, w))
        np.testing.assert_allclose(
            TG.mix_grads_stacked({k: torch.as_tensor(v)
                                  for k, v in stacked.items()}, w)["a"],
            JG.mix_grads_stacked({k: jnp.asarray(v)
                                  for k, v in stacked.items()}, w)["a"],
            rtol=1e-6)
    assert float(TG.global_norm(tg[0])) == float(JG.global_norm(jg[0]))
    same(TG.tree_sub(tg[0], tg[1]), JG.tree_sub(jg[0], jg[1]))
    same(TG.tree_add(tg[0], tg[1]), JG.tree_add(jg[0], jg[1]))
    same(TG.tree_scale(tg[0], 0.3), JG.tree_scale(jg[0], 0.3))


@pytest.mark.parametrize("second_order", [True, False],
                         ids=["second_order", "first_order"])
def test_step_with_a_frozen_encoder(second_order):
    """``freeze_encoder``: the loss does not reach the encoder, so its
    inner and outer gradients are zero (as under ``jax.grad``): the inner
    steps and the outer step leave it where it was and move the rest."""
    (jcfg, _, _), (cfg, model) = jax_and_port_models(
        model_dict(mask_padding=True, freeze_encoder=True))
    sup, qry = _t(_episode(0)), _t(_episode(10))
    T_in, T_mel = sup["inputs"].shape[-1], sup["melspecs"].shape[-1]
    masks = _t([jax_metatest_masks(k, jcfg, N_INNER, SHOTS, T_in, T_mel)
                for k in jax.random.split(jax.random.PRNGKey(7), K)])
    outer = TO.make_optimizer({"optimizer_type": "SGD", "lr": 1.0})
    params = {k: v.detach() for k, v in model.named_parameters()}
    step = make_maml_step(_port_loss_fn(model), TO.make_optimizer(INNER),
                          outer, N_INNER, second_order=second_order)
    new, m = step(TO.TrainState(params, dict(model.named_buffers()),
                                outer.init(params), 0), sup, qry, masks)
    for k, v in new.params.items():
        frozen = k.startswith(("encoder.", "embedding."))
        assert torch.equal(v, params[k]) == frozen, k
    assert torch.isfinite(m.loss)
