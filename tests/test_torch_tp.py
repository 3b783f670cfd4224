"""The port's tensor parallelism (``msa_tts_tpu_torch/parallel/tp.py``)
against the JAX package's: 4 gloo ranks on the CPU, spawned once for the
module (what they run is ``tests/torch_parallel_ranks.py::tp_cases``),
and in-process serving on ``["cpu"] * 4``.

  * the layout: ``tp_leaf_spec`` on JAX's cases and a sweep of shapes;
    the plan over the model's ``state_dict``, Adam's moments and the
    batch-norm state equal to JAX's ``tp_shardings`` leaf for leaf;
  * the ``(dp, task, tp)`` mesh's coordinates and groups, JAX's texts;
  * Megatron's four operators: a column- and a row-parallel product,
    their gradients and a second-order gradient, against the whole op;
  * a tp-4 forward against the port's whole forward and JAX's (1e-5);
  * a joint step at (dp 2, tp 2) against JAX's tp step on its
    ``make_mesh(dp=2, task=1, tp=2)`` (loss rel 1e-5, weights 2e-5, JAX's
    own limits), a clipped one where the clip binds (a norm that missed
    the other shards would not match), a second-order MAML step at tp 2,
    each rank holding only its shards;
  * ``{tp: 4, tp_min_dim: 4}`` serving against one device and against
    JAX's ``{tp: 4}`` (1e-4, JAX's limit), in float32 and in bfloat16
    (``tests/test_torch_bf16.py``'s limits); a voice adapted under tp
    against one adapted whole, and served under tp.
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
    TINY_AUDIO,
    jax_and_port_models,
    jax_forward_masks,
    model_dict,
    one_torch_thread,  # noqa: F401  (an autouse fixture)
    port_guard,  # noqa: F401  (taken by pytestmark)
    torch_masks,
)

pytestmark = pytest.mark.usefixtures("port_guard")

MIN_DIM = 32
RTOL, JOINT_ATOL = 1e-5, 2e-5      # the JAX package's tp step test
CLIP = 0.05
B, T_IN, T_MEL = 8, 12, 16


def _np(x):
    return np.asarray(torch.as_tensor(x).detach().cpu())


def tp_model() -> dict:
    """The tiny model at widths that split at ``MIN_DIM``."""
    return model_dict(symbols_embedding_dim=32, encoder_embedding_dim=32,
                      attention_rnn_dim=32, decoder_rnn_dim=32,
                      prenet_dim=32, postnet_embedding_dim=32,
                      ap={"attention_dim": 32,
                          "attention_location_n_filters": 32})


@pytest.fixture(scope="module")
def tiny():
    mp = tp_model()
    (jcfg, jparams, jstate), (cfg, model) = jax_and_port_models(mp, seed=4)
    rng = np.random.default_rng(5)
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
    key = jax.random.PRNGKey(1)
    masks = jax_forward_masks(key, jcfg, B, T_IN, T_MEL)
    return dict(mp=mp, cfg=cfg, jcfg=jcfg, jparams=jparams, jstate=jstate,
                model=model, sd=model.state_dict(), batch=batch, key=key,
                masks=masks)


def _meta_inputs(tiny):
    """Two tasks of two shots (rows 0-3 support, 4-7 query) and their
    masks: one inner step and the query pass each."""
    from msa_tts_tpu_torch.models.tacotron2nv import dropout_masks

    b = {k: torch.as_tensor(v) for k, v in tiny["batch"].items()}
    sup = {k: v[:4].reshape(2, 2, *v.shape[1:]) for k, v in b.items()}
    qry = {k: v[4:].reshape(2, 2, *v.shape[1:]) for k, v in b.items()}
    g = torch.Generator().manual_seed(9)
    masks = [[dropout_masks(tiny["cfg"], 2, T_IN, T_MEL, g, device="cpu")
              for _ in range(2)] for _ in range(2)]
    return sup, qry, masks


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, tiny):
    tmp = str(tmp_path_factory.mktemp("tp"))
    rng = np.random.default_rng(2)
    sup, qry, meta_masks = _meta_inputs(tiny)
    inp = {
        "min_dim": MIN_DIM, "clip": CLIP, "model": tiny["mp"],
        "sd": tiny["sd"], "batch": tiny["batch"],
        "masks": torch_masks(tiny["masks"]),
        "support": sup, "query": qry, "meta_masks": meta_masks,
        "ops": {"x": rng.standard_normal((3, 8)).astype(np.float32),
                "w": rng.standard_normal((12, 8)).astype(np.float32),
                "c": rng.standard_normal((3, 12)).astype(np.float32)},
    }
    torch.save(inp, os.path.join(tmp, "inputs.pt"))
    spawn(R.tp_cases, 4, tmp, store=os.path.join(tmp, "store"))
    res = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
           for r in range(4)]
    return inp, res


# ------------------------------------------------------------ layout

@pytest.mark.parametrize("shape,want", [
    ((128, 48), 0), ((256, 512), 1), ((48,), None), ((129, 256), 1),
    ((), None)])
def test_leaf_spec_matches_jax_cases(shape, want):
    """JAX's ``test_tp_leaf_spec_prefers_largest_divisible_axis``."""
    from msa_tts_tpu.parallel import tp_leaf_spec as jax_spec
    from msa_tts_tpu_torch.parallel.tp import tp_leaf_spec

    assert tp_leaf_spec(shape, 4) == want
    spec = tuple(jax_spec(shape, 4))
    assert (spec.index("tp") if "tp" in spec else None) == want


def test_leaf_spec_matches_jax_on_a_sweep():
    from msa_tts_tpu.parallel import tp_leaf_spec as jax_spec
    from msa_tts_tpu_torch.parallel.tp import tp_leaf_spec

    rng = np.random.default_rng(0)
    dims = [1, 2, 3, 4, 6, 8, 16, 31, 32, 48, 64, 96, 127, 128, 160, 256]
    for _ in range(400):
        shape = tuple(int(d) for d in rng.choice(dims, rng.integers(0, 4)))
        for tp in (2, 3, 4, 8):
            for md in (1, 4, 32, 128):
                spec = tuple(jax_spec(shape, tp, md))
                want = spec.index("tp") if "tp" in spec else None
                assert tp_leaf_spec(shape, tp, md) == want, (shape, tp, md)


def test_plan_matches_jax_leaf_for_leaf(tiny):
    """Params, Adam's moments and the batch-norm state: each tensor's
    split axis equals the one JAX's ``tp_shardings`` gives its leaf
    (through ``utils/convert.py``'s key mapping: each JAX leaf filled
    with its axis code), and the plan splits a column-parallel weight,
    a row-parallel one, an LSTM gate block and an embedding."""
    from msa_tts_tpu.parallel import make_mesh as jax_mesh
    from msa_tts_tpu.parallel import tp_shardings as jax_plan
    from msa_tts_tpu_torch.optim import make_optimizer
    from msa_tts_tpu_torch.parallel.mesh import Mesh
    from msa_tts_tpu_torch.parallel.tp import tp_shardings
    from msa_tts_tpu_torch.utils.convert import state_dict_from_jax

    jm = jax_mesh(dp=2, task=1, tp=2)
    tree = (tiny["jparams"], tiny["jstate"])

    def code(x, sh):
        spec = tuple(sh.spec) + (None,) * (x.ndim - len(sh.spec))
        return np.full(x.shape, spec.index("tp") if "tp" in spec else -1,
                       np.float32)

    coded = jax.tree_util.tree_map(code, tree,
                                   jax_plan(tree, jm, min_dim=MIN_DIM))
    want = state_dict_from_jax(*coded, tiny["cfg"])
    mesh = Mesh(np.arange(4).reshape(2, 1, 2))
    sd = tiny["sd"]
    plan = tp_shardings(sd, mesh, MIN_DIM)
    assert set(plan) == set(want)
    for k, ax in plan.items():
        assert tuple(want[k].shape) == tuple(sd[k].shape), k
        if k.endswith("num_batches_tracked"):    # the port's own scalar
            assert ax is None
            continue
        assert int(want[k].reshape(-1)[0]) == (-1 if ax is None else ax), k
    names = [k for k, _ in tiny["model"].named_parameters()]
    adam = make_optimizer({"optimizer_type": "Adam", "lr": 1e-3}).init(
        {k: sd[k] for k in names})
    moments = tp_shardings(adam, mesh, MIN_DIM)
    for m in ("mu", "nu"):
        assert moments[0][m] == {k: plan[k] for k in names}
    assert moments[0]["count"] is None
    assert plan["decoder.attention_rnn.weight_ih"] == 0          # LSTM gates
    assert plan["decoder.prenet.layers.0.linear_layer.weight"] == 0
    assert plan["decoder.linear_projection.linear_layer.weight"] == 1  # row
    assert plan["embedding.weight"] is not None
    assert plan["encoder.convolutions.0.1.running_mean"] == 0


# ------------------------------------------------------------ meshes

def test_mesh_coordinates_groups_and_errors(ranks):
    _, res = ranks
    for r, got in enumerate(res):
        shape, coords, axes, data, everyone = got["mesh212"]
        assert shape == {"dp": 2, "task": 1, "tp": 2}
        assert coords == (r // 2, 0, r % 2)
        assert axes == {"dp": (r % 2, r % 2 + 2), "task": (r,),
                        "tp": (r - r % 2, r - r % 2 + 1)}
        assert data == (r % 2, r % 2 + 2) and everyone == (0, 1, 2, 3)
        shape, coords, axes, data, everyone = got["mesh114"]
        assert shape == {"dp": 1, "task": 1, "tp": 4}
        assert coords == (0, 0, r) and axes["tp"] == (0, 1, 2, 3)
        assert data == (r,) and everyone == (0, 1, 2, 3)
        assert got["err[('dp', 2), ('tp', 4)]"] == (
            "mesh 2x1x4 needs 8 devices, have 4")
        assert got["err[('task', 3), ('tp', 2)]"] == (
            "4 devices not divisible by task=3 x tp=2")


# --------------------------------------------------------- operators

@pytest.mark.parametrize("kind", ["col", "row"])
def test_operators_match_the_whole_product(ranks, kind):
    inp, res = ranks
    x = torch.as_tensor(inp["ops"]["x"]).requires_grad_()
    w = torch.as_tensor(inp["ops"]["w"]).requires_grad_()
    c = torch.as_tensor(inp["ops"]["c"])
    y = x @ w.T
    loss = (y * c).sum() + (y ** 3).sum() * 0.1
    gx, gw = torch.autograd.grad(loss, [x, w], create_graph=True)
    (g2,) = torch.autograd.grad((gx ** 2).sum(), [w])
    axis = 0 if kind == "col" else 1
    for r, got in enumerate(res):
        o = got["ops"][kind]
        np.testing.assert_allclose(_np(o["y"]), _np(y), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_np(o["gx"]), _np(gx), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(_np(o["gw"]), _np(gw.chunk(4, axis)[r]),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_np(o["g2"]), _np(g2.chunk(4, axis)[r]),
                                   rtol=1e-5, atol=1e-4)


# ----------------------------------------------------------- forward

def test_tp_forward_matches_whole_and_jax(ranks, tiny):
    from msa_tts_tpu.models import tacotron2nv_forward as jax_forward
    from msa_tts_tpu_torch.models.tacotron2nv import tacotron2nv_forward

    inp, res = ranks
    b = {k: torch.as_tensor(v) for k, v in tiny["batch"].items()}
    with torch.no_grad():
        outs, _ = tacotron2nv_forward(
            tiny["model"], tiny["cfg"], b["inputs"], b["input_lengths"],
            b["melspecs"], b["melspec_lengths"], b["speaker_vecs"],
            inp["masks"])
    jb = {k: jnp.asarray(v) for k, v in tiny["batch"].items()}
    jouts, _ = jax_forward(
        tiny["jparams"], tiny["jstate"], tiny["jcfg"], jb["inputs"],
        jb["input_lengths"], jb["melspecs"], jb["melspec_lengths"],
        jb["speaker_vecs"], tiny["key"], train=True)
    for got in res:
        np.testing.assert_allclose(_np(got["forward"]), _np(outs[1]),
                                   atol=1e-5)
        np.testing.assert_allclose(_np(got["forward"]),
                                   np.asarray(jouts[1]), atol=1e-5)


# ------------------------------------------------------------- steps

def _jax_tp_step(tiny):
    """JAX's SGD joint step on its (dp 2, task 1, tp 2) mesh, the
    weights in the tp layout at ``MIN_DIM`` (JAX's
    ``test_tp_sharded_joint_step_matches_single``)."""
    from msa_tts_tpu.models import tacotron2nv_forward
    from msa_tts_tpu.models.loss import tacotron2_loss
    from msa_tts_tpu.parallel import make_mesh, shard_batch, shard_tree_tp

    jcfg = tiny["jcfg"]

    def step(p, ms, batch, rng):
        def lf(q):
            outs, new_ms = tacotron2nv_forward(
                q, ms, jcfg, batch["inputs"], batch["input_lengths"],
                batch["melspecs"], batch["melspec_lengths"],
                batch["speaker_vecs"], rng, train=True)
            loss = tacotron2_loss(
                tuple(outs), (batch["melspecs"], batch["stop_labels"]),
                batch["melspec_lengths"],
                n_frames_per_step=jcfg.n_frames_per_step, reduction="none",
                pos_weight=1.0)
            return loss, new_ms

        (loss, new_ms), g = jax.value_and_grad(lf, has_aux=True)(p)
        upd, _ = optax.sgd(1e-2).update(g, optax.sgd(1e-2).init(p), p)
        return optax.apply_updates(p, upd), new_ms, loss

    mesh = make_mesh(dp=2, task=1, tp=2)
    batch = {k: jnp.asarray(v) for k, v in tiny["batch"].items()}
    with mesh:
        p, s = shard_tree_tp((tiny["jparams"], tiny["jstate"]), mesh,
                             min_dim=MIN_DIM)
        return jax.jit(step)(p, s, shard_batch(batch, mesh), tiny["key"])


def test_joint_step_matches_jax_tp_step(ranks, tiny):
    from msa_tts_tpu_torch.utils.convert import state_dict_from_jax

    _, res = ranks
    new_p, new_ms, loss = _jax_tp_step(tiny)
    ref = state_dict_from_jax(jax.device_get(new_p), jax.device_get(new_ms),
                              tiny["cfg"])
    full = sum(v.numel() for k, v in tiny["sd"].items()
               if k in res[0]["joint"]["params"])
    for got in res:
        j = got["joint"]
        assert float(j["loss"]) == pytest.approx(float(loss), rel=RTOL)
        for k, v in {**j["params"], **j["stats"]}.items():
            np.testing.assert_allclose(_np(v), _np(ref[k]), atol=JOINT_ATOL,
                                       err_msg=k)
        assert j["held"] < 0.75 * full           # only this rank's shards
    for k in res[0]["joint"]["params"]:
        assert torch.equal(res[0]["joint"]["params"][k],
                           res[3]["joint"]["params"][k]), k


def test_clipped_step_counts_every_shard(ranks, tiny):
    """The clip binds (the norm is above it), so each weight's update
    depends on the global norm: a norm over this rank's shards alone
    would scale every update wrongly."""
    from msa_tts_tpu_torch.trainers.continual_ewc import EWCTrainer

    inp, res = ranks
    t = R.tp_step_trainer(EWCTrainer, tiny["mp"], tiny["sd"], None, MIN_DIM,
                          clip_grad_norm=True, grad_clip_thresh=CLIP)
    b = {k: torch.as_tensor(v) for k, v in tiny["batch"].items()}
    ref, met, _ = t._grad_step(t.train_state, b, inp["masks"])
    assert float(met["grad_norm"]) > 10 * CLIP
    for got in res:
        c = got["clipped"]
        assert float(c["grad_norm"]) == pytest.approx(
            float(met["grad_norm"]), rel=RTOL)
        for k, v in c["params"].items():
            np.testing.assert_allclose(_np(v), _np(ref.params[k]),
                                       atol=JOINT_ATOL, err_msg=k)


def test_second_order_maml_step_matches_whole(ranks, tiny):
    from msa_tts_tpu_torch.trainers.metatrainer import MetaTrainer

    inp, res = ranks
    t = R.tp_step_trainer(MetaTrainer, tiny["mp"], tiny["sd"], None,
                          MIN_DIM)
    ref, met = R.maml_tp_step(t)(t.train_state, inp["support"],
                                 inp["query"], inp["meta_masks"])
    for got in res[:2]:
        m = got["maml"]
        assert float(m["loss"]) == pytest.approx(float(met.loss), rel=RTOL)
        assert float(m["grad_norm"]) == pytest.approx(float(met.grad_norm),
                                                      rel=1e-4)
        for k, v in m["params"].items():
            np.testing.assert_allclose(_np(v), _np(ref.params[k]),
                                       atol=3e-5, err_msg=k)
    assert "maml" not in res[2] and "maml" not in res[3]


# ----------------------------------------------------------- serving

AP2 = dict(sample_rate=22050, n_fft=512, win_length=512, hop_length=128,
           f_min=0.0, f_max=8000.0, n_mels=20, griffinlim_iters=4)
MODEL2 = model_dict(
    mask_padding=False, n_mel_channels=20, num_speakers=1,
    speaker_embedding_dim=6, attention_rnn_dim=20, decoder_rnn_dim=20,
    p_prenet_dropout=0.0, max_decoder_steps=16,
    decoder_no_early_stopping=True)


def test_tp_serving_matches_one_device_and_jax():
    """JAX's ``test_tp_sharded_synthesis_matches_single_device`` on the
    port: ``{tp: 4, tp_min_dim: 4}`` over ``["cpu"] * 4``, no prenet
    dropout; equal shapes, mels within 1e-4 of the one-device decode and
    of JAX's tp decode."""
    from msa_tts_tpu.serving import AdaptiveTTS as JaxTTS
    from msa_tts_tpu_torch.serving import AdaptiveTTS

    (_, p0, s0), (_, model) = jax_and_port_models(MODEL2, seed=0)
    emb = np.random.RandomState(0).randn(6).astype(np.float32)
    base = {"model": dict(MODEL2), "audio_params": dict(AP2)}
    texts = ["hello there", "hi", "one more line"]
    kw = dict(spk_emb=emb, vocoder="none", text_pad_multiple=8)
    par = {"tp": 4, "tp_min_dim": 4}
    one = AdaptiveTTS(dict(base), model, device="cpu")
    tp = AdaptiveTTS(dict(base, parallel=par), model, device="cpu")
    assert tp.decode_backend == "torch"
    assert sum(a is not None for a in tp._tp_plan.values()) > 10
    assert all(p.is_meta for p in tp.model.parameters())
    ref = one.synthesize_batch(list(texts), **kw)
    out = tp.synthesize_batch(list(texts), **kw)
    jtp = JaxTTS(dict(base, parallel=par), p0, s0)
    jout = jtp.synthesize_batch(list(texts), rng=jax.random.PRNGKey(7), **kw)
    assert len(out) == len(ref) == len(jout) == 3
    for a, b, c in zip(out, ref, jout):
        assert a.shape == b.shape == np.asarray(c).shape
        np.testing.assert_allclose(a, b, atol=1e-4)
        np.testing.assert_allclose(a, np.asarray(c), atol=1e-4)
    one_row = tp.synthesize("hello there", vocoder="none", spk_emb=emb)
    assert np.isfinite(one_row).all()
    chunks = list(tp.synthesize_stream("hello there", vocoder="none",
                                       spk_emb=emb))
    np.testing.assert_allclose(np.concatenate(chunks, axis=-1),
                               one.synthesize("hello there", vocoder="none",
                                              spk_emb=emb), atol=1e-4)


# bfloat16: tests/test_torch_bf16.py's limits for two decodes that round
# at other places (the encoder's BiLSTM runs as the masked scan under tp,
# row-parallel partials round before their sum; JAX's decode carries its
# whole step in bfloat16); measured 1.5e-2 / 1.7e-3 against one device
# and 1.6e-2 / 2.6e-3 against JAX, at a mean |log-mel| of 0.61
BF16_STEP0, BF16_MAX, BF16_MEAN = 2e-2, 4e-2, 1e-2


def test_tp_serving_bf16_matches_one_device_and_jax():
    """``infer_dtype: bfloat16`` under ``{tp: 4, tp_min_dim: 4}`` (the
    float32 shards cast, as the one-device model is) against the
    one-device bfloat16 decode and JAX's bfloat16 ``{tp: 4}`` decode, the
    gate off so that every step is compared; the float32 master weights
    stay float32, and the stream equals the whole request."""
    import copy

    from msa_tts_tpu.serving import AdaptiveTTS as JaxTTS
    from msa_tts_tpu_torch.serving import AdaptiveTTS
    from msa_tts_tpu_torch.utils.convert import jax_from_state_dict

    (_, _, _), (cfg, model) = jax_and_port_models(MODEL2, seed=0)
    with torch.no_grad():
        model.decoder.gate_layer.linear_layer.bias.fill_(-1e4)
    p0, s0 = jax_from_state_dict(model.state_dict(), cfg)
    emb = np.random.RandomState(0).randn(6).astype(np.float32)
    base = {"model": dict(MODEL2), "audio_params": dict(AP2),
            "infer_dtype": "bfloat16"}
    texts = ["hello there", "hi", "one more line"]
    kw = dict(spk_emb=emb, vocoder="none", text_pad_multiple=8)
    par = {"tp": 4, "tp_min_dim": 4}
    one = AdaptiveTTS(dict(base), copy.deepcopy(model), device="cpu")
    tp = AdaptiveTTS(dict(base, parallel=par), copy.deepcopy(model),
                     device="cpu")
    assert tp.model.decoder.attention_rnn.weight_ih.dtype == torch.bfloat16
    assert all(s.dtype == torch.float32
               for s in tp._master["decoder.attention_rnn.weight_ih"])
    ref = one.synthesize_batch(list(texts), **kw)
    out = tp.synthesize_batch(list(texts), **kw)
    jout = JaxTTS(dict(base, parallel=par), p0, s0).synthesize_batch(
        list(texts), rng=jax.random.PRNGKey(7), **kw)
    r = MODEL2["n_frames_per_step"]
    for a, b, c in zip(out, ref, jout):
        c = np.asarray(c)
        assert a.shape == b.shape == c.shape
        assert a.shape[1] == MODEL2["max_decoder_steps"] * r
        assert np.isfinite(a).all() and float(np.abs(b).mean()) > 0.2
        for other in (b, c):
            d = np.abs(a - other)
            assert float(d[:, :r].max()) <= BF16_STEP0
            assert float(d.max()) <= BF16_MAX
            assert float(d.mean()) <= BF16_MEAN
    chunks = list(tp.synthesize_stream("hello there", vocoder="none",
                                       spk_emb=emb))
    np.testing.assert_allclose(
        np.concatenate(chunks, axis=-1),
        tp.synthesize("hello there", vocoder="none", spk_emb=emb),
        atol=1e-5)


def test_voice_adapted_and_served_under_tp(tmp_path):
    """``adapt`` under tp (the inner steps on the shards) against the
    whole model's adapt on the same masks, and the voice served under tp
    against the whole voice on one device."""
    from msa_tts_tpu_torch.models.tacotron2nv import (
        Tacotron2NV,
        config_from_params,
        dropout_masks,
    )
    from msa_tts_tpu_torch.ops.audio import save_wav
    from msa_tts_tpu_torch.serving import AdaptiveTTS

    mp = model_dict(mask_padding=True, num_speakers=1, max_decoder_steps=12)
    model = Tacotron2NV(config_from_params(dict(mp)),
                        generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        model.decoder.gate_layer.linear_layer.bias.fill_(-3.0)
    base = {"model": mp, "audio_params": dict(TINY_AUDIO), "n_inner_test": 2,
            "optim_inner": {"optimizer_type": "SGD", "lr": 0.05}}
    one = AdaptiveTTS(dict(base), model, device="cpu")
    tp = AdaptiveTTS(dict(base, parallel={"tp": 4, "tp_min_dim": 4}), model,
                     device="cpu")
    rng = np.random.default_rng(0)
    wavs = []
    for i, n in enumerate((9000, 12000)):
        t = np.arange(n) / 22050
        w = 0.4 * np.sin(2 * np.pi * (150 + 60 * i) * t) + 0.05 * (
            rng.standard_normal(n))
        wavs.append(str(tmp_path / f"c{i}.wav"))
        save_wav(wavs[-1], w.astype(np.float32), 22050)
    phones = ["hello there", "a longer line of text"]
    emb = rng.standard_normal(8).astype(np.float32)
    b = one.adapt_batch(wavs, phones, emb)
    g = torch.Generator().manual_seed(4)
    masks = [dropout_masks(one.cfg, *b["inputs"].shape,
                           b["melspecs"].shape[-1], g, device="cpu")
             for _ in range(3)]
    v1 = one.adapt(wavs, phones, emb, masks=masks)
    v4 = tp.adapt(wavs, phones, emb, masks=masks)
    assert v4.support_loss == pytest.approx(v1.support_loss, rel=1e-5)
    moved = 0.0
    for k, v in v1.state_dict.items():
        np.testing.assert_allclose(_np(v4.state_dict[k]), _np(v), atol=1e-5,
                                   err_msg=k)
        moved = max(moved, float((v - model.state_dict()[k]).abs().max()))
    assert moved > 1e-4
    a = one.synthesize("hello", v1, vocoder="none")
    c = tp.synthesize("hello", v4, vocoder="none")
    assert a.shape == c.shape
    np.testing.assert_allclose(c, a, atol=1e-4)
    # the adapted-voice multiplexer resolves to its plain engine under tp
    from msa_tts_tpu_torch.stream_mux import StreamMultiplexer

    mux = StreamMultiplexer(tp, n_slots=2, t_cap=16, segment_steps=4,
                            per_slot_params=True)
    try:
        assert mux.backend == "torch"
        got = np.concatenate(list(mux.stream("hello", voice=v4,
                                             vocoder="none")), axis=-1)
    finally:
        mux.close()
    np.testing.assert_allclose(got, a, atol=1e-4)
