"""The port's ``parallel/`` on ``torch.distributed``: 4 gloo ranks on the
CPU, spawned once for the module (``msa_tts_tpu_torch.parallel.launch``;
what each rank runs is ``tests/torch_parallel_ranks.py::parallel_cases``),
lay out every (dp, task) mesh of worlds of 4, 2 and 1, and the tests
hold what they computed against the JAX package on its virtual 8-device
CPU mesh and against the port's unsharded steps.

  * meshes: shapes, coordinates, ``dp=None``, JAX's error texts, a tp
    axis;
  * layouts: a rank's rows of a batch and of an episode;
  * the 2-D MAML (second and first order) and batched Reptile steps on a
    quadratic loss against JAX's ``make_sharded_{maml,reptile}_step`` at
    (2, 2), (1, 4) and (4, 1) (rtol 1e-5, JAX's own) and against the
    port's unsharded steps at every shape (worlds 4, 2, 1), with the
    carried model state (JAX's ``test_sharded_steps_carry_model_state``);
  * a tiny-Tacotron joint step on 2 ranks (batch norms synced over them)
    against JAX's ``shard_batch`` step on a (2, 1) mesh under the same
    masks (2e-5, JAX's own), and EWC's squared gradient of the batch;
  * in this process: the sharded serving decode on ``["cpu", "cpu"]``,
    the divisibility fallback, ``DpShard`` and the tp combinations that
    raise.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parallel_ranks as R
from msa_tts_tpu_torch.parallel.launch import spawn
from torch_parity import (
    jax_and_port_models,
    jax_forward_masks,
    model_dict,
    one_torch_thread,  # noqa: F401  (an autouse fixture)
    port_guard,  # noqa: F401  (taken by pytestmark)
    torch_masks,
)

pytestmark = pytest.mark.usefixtures("port_guard")

RTOL = 1e-5          # the JAX package's sharded-step tests
JOINT_ATOL = 2e-5    # its sharded joint step's
B, T_IN, T_MEL = 8, 12, 16


def _np(x):
    return np.asarray(torch.as_tensor(x).detach().cpu())


@pytest.fixture(scope="module")
def tiny():
    mp = model_dict()
    (jcfg, jparams, jstate), (cfg, model) = jax_and_port_models(mp, seed=2)
    rng = np.random.default_rng(7)
    batch = {
        "inputs": rng.integers(1, cfg.n_symbols, (B, T_IN)),
        "input_lengths": np.array([12, 12, 11, 10, 9, 9, 8, 6]),
        "melspecs": rng.standard_normal(
            (B, cfg.n_mel_channels, T_MEL)).astype(np.float32),
        "melspec_lengths": np.array([16, 14, 16, 12, 16, 10, 16, 8]),
        "speaker_vecs": rng.standard_normal(
            (B, cfg.speaker_embedding_dim)).astype(np.float32),
        "stop_labels": np.zeros((B, T_MEL), np.float32),
    }
    for i, n in enumerate(batch["melspec_lengths"]):
        batch["stop_labels"][i, n - 1:] = 1.0
    key = jax.random.PRNGKey(0)
    masks = jax_forward_masks(key, jcfg, B, T_IN, T_MEL)
    return dict(mp=mp, jcfg=jcfg, jparams=jparams, jstate=jstate,
                sd=model.state_dict(), batch=batch, key=key, masks=masks)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, tiny):
    tmp = str(tmp_path_factory.mktemp("parallel"))
    rng = np.random.default_rng(0)
    inp = {
        "w0": [3.0, -1.0],
        "support": rng.standard_normal((R.K, R.S, 2)).astype(np.float32),
        "query": (np.random.default_rng(1).standard_normal((R.K, R.S, 2))
                  + 0.5).astype(np.float32),
        "model": tiny["mp"], "sd": tiny["sd"], "batch": tiny["batch"],
        "masks": torch_masks(tiny["masks"]),
    }
    torch.save(inp, os.path.join(tmp, "inputs.pt"))
    spawn(R.parallel_cases, 4, tmp, store=os.path.join(tmp, "store"))
    res = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
           for r in range(4)]
    return inp, res


# ------------------------------------------------------------ meshes

def test_mesh_shapes_errors_and_layouts(ranks):
    _, res = ranks
    for r, got in enumerate(res):
        assert got["mesh_none"] == ({"dp": 4, "task": 1}, (r, 0), 4)
        assert got["coords22"] == divmod(r, 2)
        assert got["err[('dp', 3), ('task', 2)]"] == (
            "ValueError", "mesh 3x2x1 needs 6 devices, have 4")
        assert got["err[('task', 3)]"] == (
            "ValueError", "4 devices not divisible by task=3 x tp=1")
        assert got["err[('dp', 3), ('tp', 2)]"] == (
            "ValueError", "mesh 3x1x2 needs 6 devices, have 4")
        assert got["mesh_tp"] == ({"dp": 2, "task": 1, "tp": 2},
                                  (r // 2, 0, r % 2))
        x = torch.arange(24.0).reshape(8, 3)
        # P(("dp", "task")): rank r holds block r; P(("task", "dp")):
        # the rank at (d, t) holds block t * dp + d
        assert torch.equal(got["batch_rows"], x[2 * r: 2 * r + 2])
        d, t = divmod(r, 2)
        b = t * 2 + d
        assert torch.equal(got["task_rows"], x[2 * b: 2 * b + 2])


# --------------------------------------------------- 2-D meta steps

def _jax_quad(params, model_state, batch, rng):
    del rng
    t = batch["target"]
    return 0.5 * jnp.sum((params["w"][None, :] - t) ** 2) / t.shape[0], \
        model_state


def _jax_stateful_quad(params, model_state, batch, rng):
    loss, _ = _jax_quad(params, model_state, batch, rng)
    return loss, {"running": 0.9 * model_state["running"]
                  + 0.1 * jnp.mean(batch["target"], axis=0)}


def _jax_sharded(kind, dp, task, inp, loss_fn=_jax_quad, ms0=None):
    from msa_tts_tpu.optim import TrainState
    from msa_tts_tpu.parallel import make_mesh, replicate_state
    from msa_tts_tpu.parallel.shard_meta import (
        make_sharded_maml_step,
        make_sharded_reptile_step,
        shard_task_batch_2d,
    )

    mesh = make_mesh(dp=dp, task=task)
    lr = 0.5 if kind == "reptile" and ms0 is None else 1.0
    if kind == "reptile":
        step = make_sharded_reptile_step(loss_fn, optax.sgd(0.1),
                                         optax.sgd(lr), R.N_INNER, mesh)
    else:
        step = make_sharded_maml_step(
            loss_fn, optax.sgd(0.1), optax.sgd(lr), R.N_INNER, mesh,
            second_order=kind == "maml2", remat=False)
    w0 = jnp.asarray(inp["w0"], jnp.float32)
    st = TrainState(params={"w": w0}, model_state=ms0 or {},
                    opt_state=optax.sgd(lr).init({"w": w0}), step=0)
    with mesh:
        sup = shard_task_batch_2d({"target": jnp.asarray(inp["support"])},
                                  mesh)
        qry = shard_task_batch_2d({"target": jnp.asarray(inp["query"])},
                                  mesh)
        return jax.jit(step)(replicate_state(st, mesh), sup, qry,
                             jax.random.PRNGKey(0))


def _members(res, dp, task, key):
    return [got[key] for got in res[: dp * task]]


@pytest.mark.parametrize("kind", R.KINDS)
@pytest.mark.parametrize("dp,task", [(2, 2), (1, 4), (4, 1)])
def test_sharded_meta_step_matches_jax(ranks, dp, task, kind):
    inp, res = ranks
    out, met = _jax_sharded(kind, dp, task, inp)
    for got in _members(res, dp, task, (dp, task, kind)):
        np.testing.assert_allclose(_np(got["w"]), np.asarray(out.params["w"]),
                                   rtol=RTOL)
        np.testing.assert_allclose(float(got["loss"]), float(met.loss),
                                   rtol=RTOL)
        np.testing.assert_allclose(_np(got["task_losses"]),
                                   np.asarray(met.task_losses), rtol=RTOL)
        np.testing.assert_allclose(_np(got["inner"]),
                                   np.asarray(met.inner_losses), rtol=RTOL)


@pytest.mark.parametrize("kind", R.KINDS)
@pytest.mark.parametrize("dp,task", R.SHAPES)
def test_sharded_meta_step_matches_unsharded(ranks, dp, task, kind):
    """Worlds of 4, 2 and 1 against the port's unsharded step; every rank
    of the mesh ends with the same weights."""
    inp, res = ranks
    lr = 0.5 if kind == "reptile" else 1.0
    state, _ = R.quad_state(inp["w0"], {}, lr)
    no_masks = [[None] * (R.N_INNER + 1)] * R.K
    ref, met = R.meta_step(kind, R.quad_loss, None, lr)(
        state, {"target": torch.as_tensor(inp["support"])},
        {"target": torch.as_tensor(inp["query"])}, no_masks)
    got = _members(res, dp, task, (dp, task, kind))
    for g in got:
        assert torch.equal(g["w"], got[0]["w"])
        np.testing.assert_allclose(_np(g["w"]), _np(ref.params["w"]),
                                   rtol=RTOL)
        np.testing.assert_allclose(_np(g["task_losses"]),
                                   _np(met.task_losses), rtol=RTOL)
        np.testing.assert_allclose(_np(g["inner"]), _np(met.inner_losses),
                                   rtol=RTOL)
        np.testing.assert_allclose(float(g["grad_norm"]),
                                   float(met.grad_norm), rtol=RTOL)


@pytest.mark.parametrize("kind", ["maml2", "reptile"])
@pytest.mark.parametrize("dp,task", [(2, 2), (4, 1), (1, 4)])
def test_sharded_steps_carry_model_state(ranks, dp, task, kind):
    """The merged running statistic moves and equals the unsharded
    step's and JAX's sharded step's."""
    inp, res = ranks
    state, _ = R.quad_state(inp["w0"], {"running": torch.zeros(2)}, 1.0)
    no_masks = [[None] * (R.N_INNER + 1)] * R.K
    ref, _ = R.meta_step(kind, R.stateful_quad_loss, None, 1.0)(
        state, {"target": torch.as_tensor(inp["support"])},
        {"target": torch.as_tensor(inp["query"])}, no_masks)
    jout, _ = _jax_sharded(kind, dp, task, inp, _jax_stateful_quad,
                           {"running": jnp.zeros(2)})
    ref_run = _np(ref.model_state["running"])
    assert not np.allclose(ref_run, 0.0)
    for run in _members(res, dp, task, (dp, task, "carry_" + kind)):
        assert not np.allclose(_np(run), 0.0)
        np.testing.assert_allclose(_np(run), ref_run, rtol=RTOL, atol=1e-7)
        np.testing.assert_allclose(
            _np(run), np.asarray(jout.model_state["running"]), rtol=RTOL,
            atol=1e-7)


# ------------------------------------------------- tiny Tacotron step

def _jax_loss_fn(jcfg):
    from msa_tts_tpu.models import tacotron2nv_forward
    from msa_tts_tpu.models.loss import tacotron2_loss

    def loss_fn(p, ms, batch, rng):
        outs, new_ms = tacotron2nv_forward(
            p, ms, jcfg, batch["inputs"], batch["input_lengths"],
            batch["melspecs"], batch["melspec_lengths"],
            batch["speaker_vecs"], rng, train=True)
        loss = tacotron2_loss(
            tuple(outs), (batch["melspecs"], batch["stop_labels"]),
            batch["melspec_lengths"],
            n_frames_per_step=jcfg.n_frames_per_step, reduction="none",
            pos_weight=1.0)
        return loss, new_ms

    return loss_fn


def _jax_on_mesh(tiny, fn):
    from msa_tts_tpu.parallel import make_mesh, replicate_state, shard_batch

    mesh = make_mesh(dp=2, task=1)
    batch = {k: jnp.asarray(v) for k, v in tiny["batch"].items()}
    with mesh:
        return jax.jit(fn)(replicate_state(tiny["jparams"], mesh),
                           replicate_state(tiny["jstate"], mesh),
                           shard_batch(batch, mesh), tiny["key"])


def _port_sd(tiny, params, state):
    from msa_tts_tpu_torch.models.tacotron2nv import config_from_params
    from msa_tts_tpu_torch.utils.convert import state_dict_from_jax

    return state_dict_from_jax(jax.device_get(params),
                               jax.device_get(state),
                               config_from_params(dict(tiny["mp"])))


def test_joint_step_matches_jax_sharded(ranks, tiny):
    """Rank r holds rows 4r..4r+3; the step's weights and batch-norm
    statistics on both ranks equal JAX's sharded SGD step's."""
    _, res = ranks
    loss_fn = _jax_loss_fn(tiny["jcfg"])

    def step(p, ms, batch, rng):
        (loss, new_ms), g = jax.value_and_grad(
            lambda q: loss_fn(q, ms, batch, rng), has_aux=True)(p)
        return jax.tree_util.tree_map(lambda a, b: a - 1e-2 * b, p, g), \
            new_ms, loss

    new_p, new_ms, loss = _jax_on_mesh(tiny, step)
    ref = _port_sd(tiny, new_p, new_ms)
    for r in (0, 1):
        rows, split = res[r]["joint_rows"]
        assert split and np.array_equal(
            _np(rows), tiny["batch"]["inputs"][4 * r: 4 * r + 4])
        got = res[r]["joint"]
        assert float(got["loss"]) == pytest.approx(float(loss), rel=1e-5)
        for k, v in got["params"].items():
            np.testing.assert_allclose(_np(v), _np(ref[k]), atol=JOINT_ATOL,
                                       err_msg=k)
        for k, v in got["stats"].items():
            np.testing.assert_allclose(_np(v), _np(ref[k]), atol=JOINT_ATOL,
                                       err_msg=k)
    for k in res[0]["joint"]["params"]:
        assert torch.equal(res[0]["joint"]["params"][k],
                           res[1]["joint"]["params"][k])


def test_ewc_grad_sq_matches_jax_sharded(ranks, tiny):
    """EWC's per-batch term: the square of the batch's gradient summed
    over the ranks (JAX's ``test_ewc_grad_sq_sharded_matches_single``)."""
    _, res = ranks
    loss_fn = _jax_loss_fn(tiny["jcfg"])

    def grad_sq(p, ms, batch, rng):
        g = jax.grad(lambda q: loss_fn(q, ms, batch, rng)[0])(p)
        return jax.tree_util.tree_map(lambda x: x * x, g)

    sq = _jax_on_mesh(tiny, grad_sq)
    ref = _port_sd(tiny, sq, tiny["jstate"])
    for r in (0, 1):
        for k, v in res[r]["grad_sq"].items():
            np.testing.assert_allclose(_np(v), _np(ref[k]), atol=2e-5,
                                       rtol=1e-4, err_msg=k)


# ------------------------------------------------------ in-process

def _tts(dp: int, mp: dict):
    from msa_tts_tpu_torch.models.tacotron2nv import (
        Tacotron2NV,
        config_from_params,
    )
    from msa_tts_tpu_torch.serving import AdaptiveTTS
    from torch_parity import TINY_AUDIO

    model = Tacotron2NV(config_from_params(dict(mp)),
                        generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        # rows stop at different steps
        model.decoder.gate_layer.linear_layer.bias.fill_(-0.5)
    return AdaptiveTTS({"model": mp, "audio_params": dict(TINY_AUDIO),
                        "parallel": {"dp": dp}}, model, device="cpu")


def test_sharded_serving_decode_matches_one_device():
    """``parallel: {dp: 2}`` on ``["cpu", "cpu"]``: three texts (one
    filler row), the prenet masks of the padded batch; lengths equal,
    mels within 2e-5 of the one-device decode."""
    from msa_tts_tpu_torch.models.cuda_decoder import prenet_masks
    from msa_tts_tpu_torch.parallel import make_mesh
    from msa_tts_tpu_torch.serving import decode_sharded

    mp = model_dict(mask_padding=True, num_speakers=1)
    one, two = _tts(1, mp), _tts(2, mp)
    assert two._mesh.shape == {"dp": 2, "task": 1}
    texts = ["hello world", "a much longer sentence than that", "hi"]
    seqs = [one._phonemes(t) for t in texts]
    inputs = np.zeros((4, max(map(len, seqs))), np.int64)
    in_len = np.zeros(4, np.int64)
    for i, s in enumerate(seqs):
        inputs[i, : len(s)], in_len[i] = s, len(s)
    inputs[3], in_len[3] = inputs[0], in_len[0]
    emb = np.random.default_rng(1).standard_normal((4, 8)).astype(
        np.float32)
    dcfg = one.cfg.decoder_config()
    pm = prenet_masks(dcfg, dcfg.max_decoder_steps, 4,
                      torch.Generator().manual_seed(3), device="cpu")
    m1, l1 = one._decode(one.model, inputs, in_len, emb, None, pm)
    m2, l2 = two._decode(two.model, inputs, in_len, emb, None, pm,
                         shard=True)
    assert len(set(l1.tolist())) > 1       # the rows stop apart
    np.testing.assert_array_equal(l1, l2)
    r = one.cfg.n_frames_per_step
    for i in range(4):
        n = int(l1[i]) * r
        np.testing.assert_allclose(_np(m2[i, :, :n]), _np(m1[i, :, :n]),
                                   atol=2e-5)
    mesh = make_mesh(dp=2, devices=["cpu", "cpu"])
    m3, l3 = decode_sharded(mesh, [two.model, two.model], two.cfg, inputs,
                            in_len, emb, pm)
    assert torch.equal(m3, m2) and torch.equal(l3.cpu(),
                                               torch.as_tensor(l2))
    # synthesize_batch pads 3 texts to 4 rows and drops the filler
    wavs = two.synthesize_batch(texts, spk_emb=emb[0])
    assert len(wavs) == 3 and all(np.isfinite(w).all() for w in wavs)


def test_put_batch_divisibility_uses_data_axes():
    """dp·task rows split (a batch of 6 over dp 2, task 1); 5 rows run
    whole, said once (JAX's ``test_put_batch_divisibility_uses_data_axes_
    not_mesh_size``)."""
    from msa_tts_tpu_torch.parallel.mesh import AxisGroup, Mesh
    from msa_tts_tpu_torch.trainers.base import TrainerBase

    g = AxisGroup(None, (0, 1), 0)
    mesh = Mesh(np.array([[0], [1]]), rank=0,
                groups={("dp",): g, ("task",): AxisGroup(None, (0,), 0),
                        ("dp", "task"): g})
    t = R.bare_trainer(TrainerBase, model_dict(), mesh)
    assert t._data_axes_size == 2
    six = {"inputs": torch.arange(12).reshape(6, 2)}
    rows, _, group = t._put_batch(six)
    assert group is g and torch.equal(rows["inputs"], six["inputs"][:3])
    five = {"inputs": torch.arange(10).reshape(5, 2)}
    rows, _, group = t._put_batch(five)
    assert group is None and rows is five and t._said_replicated


def test_tp_raises_at_every_site(tmp_path):
    """The combinations the JAX package rejects raise with its texts: tp
    with a task axis in a trainer, tp in a vocoder trainer (through
    ``DpShard``), tp with dp in serving; an explicit kernel decode under
    tp serving raises too; a tp mesh larger than the world raises."""
    from msa_tts_tpu_torch.parallel import make_mesh
    from msa_tts_tpu_torch.parallel.sharding import DpShard
    from msa_tts_tpu_torch.serving import AdaptiveTTS
    from msa_tts_tpu_torch.trainers.baseline import JointTrainer
    from msa_tts_tpu_torch.trainers.wavernn_train import WaveRNNTrainer

    with pytest.raises(ValueError, match="mesh 1x1x2 needs 2 devices"):
        make_mesh(dp=1, tp=2)
    with pytest.raises(NotImplementedError,
                       match="tp composes with dp, not with the task axis"):
        JointTrainer(parallel={"task": 2, "tp": 2}, device="cpu",
                     output_path=str(tmp_path))
    with pytest.raises(NotImplementedError, match="DpShard is dp/task"):
        WaveRNNTrainer(parallel={"dp": 1, "tp": 2}, device="cpu",
                       output_path=str(tmp_path))
    base = {"model": model_dict(), "audio_params": {"n_mels": 10}}
    with pytest.raises(NotImplementedError, match="not both"):
        AdaptiveTTS(dict(base, parallel={"dp": 2, "tp": 2}), None)
    with pytest.raises(NotImplementedError, match="single-device"):
        AdaptiveTTS(dict(base, parallel={"tp": 2}, decode_backend="cuda"),
                    _tts(1, model_dict()).model, device="cpu")
    # DpShard keeps the JAX package's text
    with pytest.raises(NotImplementedError, match="DpShard is dp/task"):
        DpShard.from_params({"parallel": {"dp": 1, "tp": 2}})
    assert DpShard.from_params({}) is None
