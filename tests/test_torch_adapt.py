"""The port's few-shot adaptation path against the JAX package on the same
weights, clips and dropout masks (the JAX package draws its masks with
``jax.random``; ``torch_parity.jax_metatest_masks`` draws the same masks
for the port):

- the teacher-forced training forward (outputs and new batch-norm
  state), the loss for each reduction, one step's gradients, and the
  second-order meta-gradient through the inner steps;
- the optimizer for every option against the optax chain, gradient
  clipping, ``collate``, the log-mel frontends and silence trimming;
- ``AdaptiveTTS.adapt`` end to end (adapted ``state_dict``, batch-norm
  statistics, ``support_loss``) and the adapted voice served;
- voice files and ``.ckpt`` checkpoints crossing between the packages,
  the msgpack codec against ``flax.serialization``, ``server.main
  --voices_dir``, and ``infer_dtype: bfloat16`` adapting on float32
  master weights.

Tolerances, float32 on both sides summed in other orders, each set from
a reading at these shapes and no looser than 4x it: forward mels, gates
and alignments 1e-6 (read 2.4e-7), the postnet mel 9e-6 (read 2.4e-6 on
values up to 6.6), new batch-norm statistics 4e-7 (read 1.2e-7), the
loss 4e-7 relative (read 1e-7), gradients 1.8e-6 (read 4.6e-7 on values
up to 0.76), adapted weights and statistics after 2 steps 9e-7 (read
2.4e-7), the query loss 1.2e-6 relative (read 2.9e-7), the served
adapted mel 3e-6 (read 7.7e-7), the second-order meta-gradient 2e-6
(read 5.4e-7 on values up to 1.1).  The optimizer, clipping, collate and
the log-mel frontends read 0 and are held exactly.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from msa_tts_tpu.dataloaders.collate import collate as jax_collate
from msa_tts_tpu.dataloaders.dataset import Item as JaxItem
from msa_tts_tpu.models import config_from_params as jax_cfp
from msa_tts_tpu.models import init_tacotron2nv
from msa_tts_tpu.models import tacotron2nv_forward as jax_forward
from msa_tts_tpu.models.loss import tacotron2_loss as jax_loss
from msa_tts_tpu.models.pallas_decoder import _prenet_masks
from msa_tts_tpu.ops import audio as JA
from msa_tts_tpu.optim import clip_by_global_norm as jax_clip
from msa_tts_tpu.optim import make_optimizer as jax_optimizer
from msa_tts_tpu.serving import AdaptiveTTS as JaxTTS
from msa_tts_tpu.utils import checkpoint as JC
from msa_tts_tpu.utils.g2p import N_SYMBOLS
from msa_tts_tpu.utils.torch_import import save_torch_checkpoint
from msa_tts_tpu_torch import optim as TO
from msa_tts_tpu_torch.dataloaders.collate import collate
from msa_tts_tpu_torch.dataloaders.dataset import Item
from msa_tts_tpu_torch.models.loss import tacotron2_loss
from msa_tts_tpu_torch.models.tacotron2nv import tacotron2nv_forward
from msa_tts_tpu_torch.ops import audio as TA
from msa_tts_tpu_torch.serving import AdaptiveTTS
from msa_tts_tpu_torch.utils import checkpoint as TC
from msa_tts_tpu_torch.utils.convert import (
    jax_from_state_dict,
    state_dict_from_jax,
)
from torch_parity import (
    jax_and_port_models,
    jax_forward_masks,
    jax_metatest_masks,
    model_dict,
    randn,
)

AP = dict(sample_rate=22050, n_fft=512, win_length=512, hop_length=128,
          f_min=0.0, f_max=8000.0, n_mels=10, griffinlim_iters=4)
N_INNER = 2
TEXTS = ["hello there", "a somewhat longer clip of text", "hi"]
FWD_ATOL, POST_ATOL, BN_ATOL = 1e-6, 9e-6, 4e-7
LOSS_RTOL, GRAD_ATOL = 4e-7, 1.8e-6
ADAPT_ATOL, QLOSS_RTOL, SERVE_ATOL = 9e-7, 1.2e-6, 3e-6
META_INNER, META_GRAD_ATOL = 2, 2e-6


def _t(x):
    """numpy → torch (integers as int64), nested lists and dicts too."""
    if isinstance(x, dict):
        return {k: _t(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_t(v) for v in x]
    x = np.asarray(x)
    return torch.as_tensor(x.astype(np.int64) if x.dtype.kind == "i" else x)


def _batch(seed=0, B=3, T_in=9, T_mel=12):
    """A padded training batch: ragged text and mel lengths, stop labels
    from the last valid frame on."""
    rng = np.random.default_rng(seed)
    il = np.array([T_in, T_in - 2, T_in - 4][:B], np.int32)
    inputs = rng.integers(1, 50, (B, T_in)).astype(np.int32)
    for b in range(B):
        inputs[b, il[b]:] = 0
    ml = np.array([T_mel, T_mel - 3, T_mel - 6][:B], np.int32)
    mels = randn(seed + 1, B, 10, T_mel)
    stop = np.ones((B, T_mel), np.float32)
    for b in range(B):
        mels[b, :, ml[b]:] = 0.0
        stop[b, : ml[b] - 1] = 0.0
    return inputs, il, mels, ml, randn(seed + 2, B, 8), stop


def _forward_both(mp, key=jax.random.PRNGKey(5)):
    (jcfg, jp, js), (cfg, model) = jax_and_port_models(mp)
    inputs, il, mels, ml, spk, stop = _batch()
    masks = jax_forward_masks(key, jcfg, *inputs.shape, mels.shape[-1])
    ref = jax_forward(jp, js, jcfg, inputs, il, mels, ml, spk, key,
                      train=True)
    out = tacotron2nv_forward(model, cfg, *map(_t, (inputs, il, mels, ml,
                                                    spk)), _t(masks))
    return (jcfg, jp, js, ref), (cfg, model, out), (inputs, il, mels, ml,
                                                    spk, stop, masks, key)


@pytest.mark.parametrize("over", [
    {"mask_padding": True},
    {"mask_padding": False, "ap": {"attention_type": "LSA"}},
], ids=["forward_attention", "lsa"])
def test_train_forward_matches_jax(over):
    """Training mode: batch statistics, dropout from the JAX-drawn masks
    (encoder, prenet, attention and decoder h, postnet), padded frames
    masked; the new running statistics under their state_dict names."""
    (jcfg, _, _, (ref, ref_state)), (cfg, model, (out, state)), _ = (
        _forward_both(model_dict(**over)))
    for i, (a, b) in enumerate(zip(out, ref)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=POST_ATOL if i == 1 else FWD_ATOL,
                                   rtol=0)
    sd = state_dict_from_jax(
        jax.device_get(init_tacotron2nv(jax.random.PRNGKey(0), jcfg)[0]),
        jax.device_get(ref_state), cfg)
    assert len(state) == 2 * (cfg.encoder_n_convolutions
                              + cfg.postnet_n_convolutions)
    for k, v in state.items():
        np.testing.assert_allclose(v.detach().numpy(), sd[k].numpy(),
                                   atol=BN_ATOL, rtol=0)
    # the model's own buffers are read, never written
    assert torch.equal(model.postnet.convolutions[0][1].running_var,
                       torch.ones_like(state["postnet.convolutions.0.1."
                                             "running_var"]))


@pytest.mark.parametrize("reduction", ["none", "mean", "sum"])
def test_loss_matches_jax(reduction):
    inputs, il, mels, ml, spk, stop = _batch()
    rng = np.random.default_rng(3)
    outs = [mels + 0.1 * randn(4, *mels.shape),
            mels + 0.1 * randn(5, *mels.shape),
            rng.standard_normal(stop.shape).astype(np.float32) * 3, None]
    kw = dict(n_frames_per_step=2, reduction=reduction, pos_weight=6.0)
    ref = float(jax_loss(tuple(outs), (mels, stop), ml, **kw))
    out = float(tacotron2_loss([_t(o) if o is not None else None
                                for o in outs], (_t(mels), _t(stop)),
                               _t(ml), **kw))
    assert out == pytest.approx(ref, rel=LOSS_RTOL)
    with pytest.raises(ValueError, match="reduction"):
        tacotron2_loss([_t(o) if o is not None else None for o in outs],
                       (_t(mels), _t(stop)), _t(ml), reduction="max")


@pytest.mark.parametrize("freeze", [None, "freeze_encoder"])
def test_one_step_gradients_match_jax(freeze):
    """The gradients of one inner step's loss (reduction none, pos_weight
    6) with respect to every parameter; a frozen encoder gets none."""
    mp = model_dict(mask_padding=True, **({freeze: True} if freeze else {}))
    (jcfg, jp, js, _), (cfg, model, _), (inputs, il, mels, ml, spk, stop,
                                         masks, key) = _forward_both(mp)
    kw = dict(n_frames_per_step=2, reduction="none", pos_weight=6.0)

    def jloss(p):
        outs, _ = jax_forward(p, js, jcfg, inputs, il, mels, ml, spk, key,
                              train=True)
        return jax_loss(tuple(outs), (mels, stop), ml, **kw)

    jgrads = jax.device_get(jax.grad(jloss)(jp))
    outs, _ = tacotron2nv_forward(model, cfg, *map(_t, (inputs, il, mels,
                                                        ml, spk)), _t(masks))
    loss = tacotron2_loss(outs, (_t(mels), _t(stop)), _t(ml), **kw)
    names = [k for k, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()),
                                allow_unused=True)
    ref = state_dict_from_jax(jgrads, jax.device_get(js), cfg)
    for name, g in zip(names, grads):
        g = torch.zeros_like(ref[name]) if g is None else g
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(),
                                   atol=GRAD_ATOL, rtol=0, err_msg=name)
        if freeze and name.startswith(("encoder.", "embedding.")):
            assert not g.any(), name
    assert float(torch.cat([g.flatten() for g in grads
                            if g is not None]).abs().max()) > 1e-3


def test_second_order_meta_gradient_matches_jax():
    """make_metatest_fn(create_graph=True): the query loss's gradient
    with respect to the initial parameters, through the inner SGD steps
    and their gradients, against jax.grad through the JAX package's
    make_metatest_fn on the same masks."""
    from msa_tts_tpu.meta.maml import make_metatest_fn as jax_metatest
    from msa_tts_tpu_torch.meta.maml import make_metatest_fn

    (jcfg, jp, js), (cfg, model) = jax_and_port_models(
        model_dict(mask_padding=True))
    inputs, il, mels, ml, spk, stop = _batch()
    batch = dict(inputs=inputs, input_lengths=il, melspecs=mels,
                 melspec_lengths=ml, speaker_vecs=spk, stop_labels=stop)
    kw = dict(n_frames_per_step=2, reduction="none", pos_weight=6.0)
    opt = {"optimizer_type": "SGD", "lr": 1e-2}
    key = jax.random.PRNGKey(11)

    def jloss(p, ms, b, rng):
        outs, new_ms = jax_forward(
            p, ms, jcfg, b["inputs"], b["input_lengths"], b["melspecs"],
            b["melspec_lengths"], b["speaker_vecs"], rng, train=True)
        return jax_loss(tuple(outs), (b["melspecs"], b["stop_labels"]),
                        b["melspec_lengths"], **kw), new_ms

    jmeta = jax_metatest(jloss, jax_optimizer(opt), META_INNER, remat=False)
    jq, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmeta(p, js, batch, batch, key)[0]))(jp)

    def loss(p, ms, b, m):
        outs, new_ms = torch.func.functional_call(
            model, {**p, **ms}, (b["inputs"], b["input_lengths"],
                                 b["melspecs"], b["melspec_lengths"],
                                 b["speaker_vecs"], m))
        return (tacotron2_loss(outs, (b["melspecs"], b["stop_labels"]),
                               b["melspec_lengths"], **kw),
                {**ms, **new_ms})

    params = dict(model.named_parameters())
    tb = _t(batch)
    masks = _t(jax_metatest_masks(key, jcfg, META_INNER, *inputs.shape,
                                  mels.shape[-1]))
    q, _, _, _ = make_metatest_fn(loss, TO.make_optimizer(opt), META_INNER,
                                  create_graph=True)(
        params, dict(model.named_buffers()), tb, tb, masks)
    assert float(q.detach()) == pytest.approx(float(jq), rel=QLOSS_RTOL)
    grads = torch.autograd.grad(q, list(params.values()), allow_unused=True)
    ref = state_dict_from_jax(jax.device_get(jgrads), jax.device_get(js),
                              cfg)
    for name, g in zip(params, grads):
        g = torch.zeros_like(ref[name]) if g is None else g
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(),
                                   atol=META_GRAD_ATOL, rtol=0,
                                   err_msg=name)
    # the terms of second order count: the first-order gradient (the
    # query loss's at the adapted parameters) is another
    _, adapted, ms, _ = make_metatest_fn(loss, TO.make_optimizer(opt),
                                         META_INNER)(
        params, dict(model.named_buffers()), tb, tb, masks)
    first = torch.autograd.grad(loss(adapted, ms, tb, masks[-1])[0],
                                list(adapted.values()), allow_unused=True)
    gap = max(float((a - b).abs().max()) for a, b in zip(grads, first)
              if a is not None and b is not None)
    assert gap > 100 * META_GRAD_ATOL


OPTIMIZERS = {
    "sgd": {"optimizer_type": "SGD", "lr": 1e-2},
    "sgd_momentum_wd": {"optimizer_type": "SGD", "lr": "1e-2",
                        "momentum": 0.9, "weight_decay": 1e-3},
    "sgd_nesterov": {"optimizer_type": "SGD", "lr": 1e-2, "momentum": 0.5,
                     "nesterov": True},
    "adam": {"optimizer_type": "Adam", "lr": 1e-3},
    "adam_wd": {"optimizer_type": "Adam", "lr": "1e-3",
                "weight_decay": "1e-2", "betas": "(0.8, 0.99)"},
    "adamw": {"optimizer_type": "AdamW", "lr": 1e-3, "weight_decay": 1e-2},
    "amsgrad": {"optimizer_name": "Adam",
                "optim_params": {"lr": 1e-3, "amsgrad": True}},
    "rmsprop": {"optimizer_type": "RMSprop", "lr": 1e-3},
    "rmsprop_centered": {"optimizer_type": "RMSprop", "lr": 1e-3,
                         "centered": True, "momentum": 0.9,
                         "weight_decay": 1e-3, "alpha": 0.9},
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_matches_optax(name):
    """Three updates from the same gradients: the parameters after each
    equal the optax chain's (optax's arithmetic: RMSprop's eps inside the
    square root, Adam's decay before the scaling, AdamW's after)."""
    cfg = OPTIMIZERS[name]
    params = {"a": randn(0, 5, 4), "b": randn(1, 7)}
    jtx, ttx = jax_optimizer(dict(cfg)), TO.make_optimizer(dict(cfg))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.as_tensor(v) for k, v in params.items()}
    js, ts = jtx.init(jp), ttx.init(tp)
    for step in range(3):
        g = {k: randn(10 + 2 * step + i, *v.shape)
             for i, (k, v) in enumerate(params.items())}
        upd, js = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                             jp)
        jp = optax.apply_updates(jp, upd)
        upd, ts = ttx.update({k: torch.as_tensor(v) for k, v in g.items()},
                             ts, tp)
        tp = TO.apply_updates(tp, upd)
        for k in params:
            np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    assert not np.allclose(tp["a"].numpy(), params["a"])


def test_optimizer_rejects_what_it_does_not_take():
    for cfg in ({"optimizer_type": "Adam", "foreach": True},
                {"optimizer_type": "Lion"},
                {"optimizer_type": "SGD", "nesterov": True}):
        with pytest.raises(ValueError):
            TO.make_optimizer(cfg)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    g = {"a": randn(0, 3, 4), "b": randn(1, 5)}
    jc, jn = jax_clip({k: jnp.asarray(v) for k, v in g.items()}, max_norm)
    tc, tn = TO.clip_by_global_norm({k: torch.as_tensor(v)
                                     for k, v in g.items()}, max_norm)
    assert float(tn) == float(jn)
    for k in g:
        np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]))


def test_collate_matches_jax():
    """Sorted by text length (longest first), text padded to a multiple
    of 16 (or none, or a fixed width), mels to one of 32 (or none, or a
    fixed width) then the reduction factor, speaker ids, stop labels:
    byte for byte."""
    rng = np.random.default_rng(0)
    specs = [(7, 40), (19, 33), (3, 61), (12, 8)]
    fields = [dict(phonemes=rng.integers(1, 90, n).astype(np.int32),
                   mel=rng.standard_normal((10, m)).astype(np.float32),
                   spk_emb=rng.standard_normal(8).astype(np.float32))
              for n, m in specs]
    for kw in (dict(reduction_factor=2, text_pad_multiple=16,
                    mel_pad_multiple=32),
               dict(reduction_factor=3),
               dict(reduction_factor=2, text_pad_to=32, mel_pad_to=80)):
        ref = jax_collate([JaxItem(item_id=f"u{i}", speaker="s",
                                   speaker_id=i, duration=1.0, **f)
                           for i, f in enumerate(fields)], **kw)
        out = collate([Item(speaker_id=i, **f)
                       for i, f in enumerate(fields)], **kw)
        assert ref.item_ids == ("u1", "u3", "u0", "u2")
        assert out._fields == tuple(n for n in ref._fields
                                    if n != "item_ids")
        for name in out._fields:
            a, b = getattr(out, name), getattr(ref, name)
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert a.tobytes() == b.tobytes(), name


def _wav(seed=0, n=9000):
    """Seeded voiced harmonics and noise between two quiet margins."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 22050
    w = (0.4 * np.sin(2 * np.pi * 180 * t) + 0.2 * np.sin(2 * np.pi * 540 * t)
         + 0.05 * rng.standard_normal(n))
    w[:1500] *= 1e-3
    w[-1200:] *= 1e-3
    return w.astype(np.float32)


AP2 = dict(sample_rate=22050, n_fft=512, win_size=400, hop_size=128,
           fmin=0.0, fmax=8000.0, n_mels=10)


@pytest.mark.parametrize("frontend", ["ap", "ap2", "trim"])
def test_features_match_jax(frontend):
    """The log-mel frontends and the silence trim against the JAX
    package's numpy path on a seeded wav: equal."""
    wav = _wav()
    if frontend == "trim":
        bounds = TA.trim_margin_silence_slice(wav)
        assert bounds == JA.trim_margin_silence_slice(wav)
        assert 0 < bounds[0] and bounds[1] < len(wav)
        np.testing.assert_array_equal(TA.trim_margin_silence(wav),
                                      JA.trim_margin_silence(wav))
        return
    if frontend == "ap":
        ref = JA.melspec_ap(wav, AP, xp=np)[2]
        out = TA.melspec_ap(wav, AP)
    else:
        ref = JA.melspec_ap2(wav[None], AP2, xp=np)[2]
        out = TA.melspec_ap2(wav[None], AP2)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    np.testing.assert_array_equal(out, ref)


# ------------------------------------------------------------ end to end

@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """params.yml (tiny model, the shipped criterion, SGD inner steps,
    silence trimming), checkpoints/checkpoint_0.pt written by the JAX
    package, three clips and their phonemizations."""
    path = tmp_path_factory.mktemp("adapt_exp")
    mp = model_dict(max_decoder_steps=24, mask_padding=True)
    params = {"model": mp, "audio_params": dict(AP),
              "criterion": {"reduction": "none", "pos_weight": 6.0},
              "optim_inner": {"optimizer_type": "SGD", "lr": 1e-2},
              "n_inner_test": N_INNER,
              "dataset_train": {"trim_margin_silence": True}}
    with open(path / "params.yml", "w") as f:
        yaml.safe_dump(params, f)
    cfg = jax_cfp(dict(mp, n_symbols=N_SYMBOLS, num_speakers=1))
    p, s = init_tacotron2nv(jax.random.PRNGKey(3), cfg)
    # a lower gate bias: the served adapted voice decodes 24 steps
    p["decoder"]["gate_layer"]["bias"] = (
        p["decoder"]["gate_layer"]["bias"] - 3.0)
    os.makedirs(path / "checkpoints")
    save_torch_checkpoint(str(path / "checkpoints" / "checkpoint_0.pt"),
                          p, s, cfg)
    wavs = []
    for i, n in enumerate((7000, 11000, 6000)):
        wavs.append(str(path / f"clip{i}.wav"))
        TA.save_wav(wavs[-1], _wav(i, n), AP["sample_rate"])
    from msa_tts_tpu_torch.utils.g2p import Grapheme2Phoneme

    g2p = Grapheme2Phoneme(backend="fallback")
    return {"path": str(path), "wavs": wavs, "p": p, "s": s, "cfg": cfg,
            "phonemes": [g2p.text_to_phone(t) for t in TEXTS],
            "emb": randn(9, 8)}


@pytest.fixture(scope="module")
def adapted(experiment):
    """JAX's adapt under one key and the port's under the masks that key
    gives, from the same experiment."""
    e = experiment
    jtts = JaxTTS.from_experiment(e["path"])
    tts = AdaptiveTTS.from_experiment(e["path"], device="cpu")
    key = jax.random.PRNGKey(7)
    jv = jtts.adapt(e["wavs"], e["phonemes"], e["emb"], rng=key)
    batch = tts.adapt_batch(e["wavs"], e["phonemes"], e["emb"])
    B, T_in = batch["inputs"].shape
    masks = jax_metatest_masks(key, jtts.cfg, N_INNER, B, T_in,
                               batch["melspecs"].shape[-1])
    v = tts.adapt(e["wavs"], e["phonemes"], e["emb"], masks=masks)
    return jtts, tts, jv, v, masks


def _jax_voice_sd(tts, jv):
    return state_dict_from_jax(jax.device_get(jv.params),
                               jax.device_get(jv.model_state), tts.cfg)


def _pre_masks(tts):
    dcfg = tts.cfg.decoder_config()
    key = jax.random.fold_in(jax.random.PRNGKey(0), 2)
    return np.array(_prenet_masks(dcfg, key, dcfg.max_decoder_steps, 1))


def test_adapt_matches_jax(adapted):
    """The adapted weights and batch-norm statistics, the query loss, and
    the adapted voice served (same mel and mel_lengths) as JAX's."""
    jtts, tts, jv, v, _ = adapted
    ref = _jax_voice_sd(tts, jv)
    assert set(v.state_dict) == set(ref)
    moved = 0.0
    for k, a in v.state_dict.items():
        assert a.dtype == ref[k].dtype, k
        np.testing.assert_allclose(a.numpy(), ref[k].numpy(),
                                   atol=ADAPT_ATOL, rtol=0, err_msg=k)
        if a.is_floating_point():
            moved = max(moved, float((a - tts._master[k]).abs().max()))
    assert moved > 1e-2                      # the steps did adapt
    assert v.support_loss == pytest.approx(jv.support_loss, rel=QLOSS_RTOL)
    np.testing.assert_array_equal(v.spk_emb, jv.spk_emb)
    for text in TEXTS[:2]:
        ref_mel = np.asarray(jtts.synthesize(text, jv, vocoder="none"))
        mel = tts.synthesize(text, v, vocoder="none",
                             pre_masks=_pre_masks(tts))
        assert mel.shape == ref_mel.shape
        np.testing.assert_allclose(mel, ref_mel, atol=SERVE_ATOL, rtol=0)


def test_adapt_draws_its_masks_from_a_seed(adapted, experiment):
    """Without injected masks a seed draws them: the same seed gives the
    same voice.  Masks for another number of passes, or clips without
    their phonemizations, raise."""
    _, tts, _, _, _ = adapted
    e = experiment
    a, b = (tts.adapt(e["wavs"], e["phonemes"], e["emb"], seed=3)
            for _ in range(2))
    for k in a.state_dict:
        assert torch.equal(a.state_dict[k], b.state_dict[k]), k
    with pytest.raises(ValueError, match="masks"):
        tts.adapt(e["wavs"], e["phonemes"], e["emb"], masks=[{}])
    with pytest.raises(ValueError, match="phonemizations"):
        tts.adapt(e["wavs"], e["phonemes"][:1], e["emb"])


def test_voice_files_cross_load(adapted, tmp_path):
    """A voice written by either package loads in the other with the same
    weights, d-vector and loss, and serves the same mel bit for bit."""
    jtts, tts, jv, v, _ = adapted
    jtts.save_voice(jv, str(tmp_path / "jax.voice"))
    tts.save_voice(v, str(tmp_path / "port.voice"))
    from_jax = tts.load_voice(str(tmp_path / "jax.voice"))
    ref = _jax_voice_sd(tts, jv)
    for k in ref:
        assert torch.equal(from_jax.state_dict[k], ref[k]), k
    assert from_jax.support_loss == np.float32(jv.support_loss)
    np.testing.assert_array_equal(from_jax.spk_emb, jv.spk_emb)

    from_port = jtts.load_voice(str(tmp_path / "port.voice"))
    params, state = jax_from_state_dict(v.state_dict, tts.cfg)
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           jax.device_get(from_port.params), params)
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           jax.device_get(from_port.model_state), state)
    assert from_port.support_loss == np.float32(v.support_loss)

    again = tts.load_voice(str(tmp_path / "port.voice"))
    pm = _pre_masks(tts)
    np.testing.assert_array_equal(
        tts.synthesize(TEXTS[0], again, vocoder="none", pre_masks=pm),
        tts.synthesize(TEXTS[0], v, vocoder="none", pre_masks=pm))


def _optax_state():
    """A trainer's optimizer state after one update (a small tree: the
    layout, not the size, is what the codec must carry)."""
    p = {"w": jnp.ones((2, 3)), "layers": [{"b": jnp.zeros(4)}]}
    tx = optax.chain(optax.add_decayed_weights(1e-3), optax.scale_by_adam())
    state = tx.init(p)
    _, state = tx.update(jax.tree_util.tree_map(jnp.ones_like, p), state, p)
    return state


def test_codec_round_trips_flax(experiment):
    """The hand-written codec writes flax.serialization's bytes for a
    trainer payload (parameters, an optax state, numpy and Python
    scalars), and each side reads what the other wrote."""
    from flax import serialization

    p = jax.device_get(experiment["p"])
    payload = {"params": p, "model_state": jax.device_get(experiment["s"]),
               "opt_state": jax.device_get(_optax_state()),
               "step": 12, "lr": 1e-3, "tag": "maml", "done": False,
               "nothing": None, "loss": np.float32(2.5)}
    flax_bytes = serialization.msgpack_serialize(
        serialization.to_state_dict(payload))
    tree = serialization.to_state_dict(payload)
    assert TC.serialize_payload(tree) == flax_bytes
    mine = TC.deserialize_payload(flax_bytes)
    theirs = serialization.msgpack_restore(flax_bytes)
    assert (jax.tree_util.tree_structure(mine)
            == jax.tree_util.tree_structure(theirs))
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(a, b)
        if b is not None else None, mine, theirs)
    back = serialization.msgpack_restore(TC.serialize_payload(mine))
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(a, b)
        if b is not None else None, back, theirs)
    # bfloat16 arrays load widened to float32
    bf = TC.deserialize_payload(serialization.msgpack_serialize(
        {"x": np.asarray(jnp.arange(5, dtype=jnp.bfloat16) / 3)}))["x"]
    assert bf.dtype == np.float32
    np.testing.assert_array_equal(
        bf, np.asarray(jnp.arange(5, dtype=jnp.bfloat16) / 3, np.float32))
    with pytest.raises(ValueError):
        TC.deserialize_payload(flax_bytes[:-3])


def test_ckpt_checkpoint_serves_like_pt(experiment, tmp_path):
    """A trainer's .ckpt (params, model_state, optimizer state, step) from
    the JAX package's save_checkpoint serves the mel the .pt of the same
    weights serves."""
    e = experiment
    os.makedirs(tmp_path / "checkpoints")
    with open(os.path.join(e["path"], "params.yml")) as f, \
            open(tmp_path / "params.yml", "w") as g:
        g.write(f.read())
    JC.save_checkpoint(str(tmp_path / "checkpoints" / "checkpoint_3.ckpt"),
                       {"params": e["p"], "model_state": e["s"],
                        "opt_state": _optax_state(), "step": 30})
    ckpt = AdaptiveTTS.from_experiment(str(tmp_path), "3", device="cpu")
    pt = AdaptiveTTS.from_experiment(e["path"], device="cpu")
    for k, v in pt.model.state_dict().items():
        assert torch.equal(ckpt.model.state_dict()[k], v), k
    pm = _pre_masks(pt)
    np.testing.assert_array_equal(
        ckpt.synthesize(TEXTS[0], spk_emb=e["emb"], vocoder="none",
                        pre_masks=pm),
        pt.synthesize(TEXTS[0], spk_emb=e["emb"], vocoder="none",
                      pre_masks=pm))


def test_server_main_registers_voices_dir(adapted, experiment, tmp_path,
                                          monkeypatch):
    """server.main --voices_dir registers every *.voice file under its
    stem name (and nothing else in the directory)."""
    from msa_tts_tpu_torch import server as S

    jtts, tts, jv, v, _ = adapted
    tts.save_voice(v, str(tmp_path / "alice.voice"))
    jtts.save_voice(jv, str(tmp_path / "bob.voice"))
    (tmp_path / "notes.txt").write_text("not a voice")
    seen = {}

    def stop(self):
        seen.update(self._voices)

    def interrupt(_):
        raise KeyboardInterrupt

    monkeypatch.setattr(S.TTSServer, "start", lambda self: 0)
    monkeypatch.setattr(S.TTSServer, "stop", stop)
    monkeypatch.setattr(S.time, "sleep", interrupt)
    S.main(["--experiment_path", experiment["path"], "--device", "cpu",
            "--voices_dir", str(tmp_path)])
    assert sorted(seen) == ["alice", "bob"]
    for k, t in v.state_dict.items():
        assert torch.equal(seen["alice"].state_dict[k], t), k


def test_bfloat16_serving_adapts_on_float32_master(adapted, experiment):
    """With infer_dtype: bfloat16 the port adapts from float32 weights:
    the same masks give the float32 run's parameters exactly, the
    serving model's tensors do not change, and the voice serves from a
    bfloat16 copy of the float32 adapted weights."""
    _, tts, _, v, masks = adapted
    e = experiment
    tts16 = AdaptiveTTS.from_experiment(e["path"], device="cpu",
                                        infer_dtype="bfloat16")
    before = {k: t.clone() for k, t in tts16.model.state_dict().items()}
    assert before["decoder.attention_rnn.weight_ih"].dtype == torch.bfloat16
    v16 = tts16.adapt(e["wavs"], e["phonemes"], e["emb"], masks=masks)
    for k, t in v.state_dict.items():
        assert v16.state_dict[k].dtype == t.dtype, k
        assert torch.equal(v16.state_dict[k], t), k
    assert v16.support_loss == v.support_loss
    for k, t in tts16.model.state_dict().items():
        assert torch.equal(t, before[k]), k
    served = tts16._voice_model(v16)
    w = served.decoder.attention_rnn.weight_ih
    assert w.dtype == torch.bfloat16
    assert torch.equal(w, v.state_dict["decoder.attention_rnn.weight_ih"]
                       .to(torch.bfloat16))
    mel = tts16.synthesize(TEXTS[0], v16, vocoder="none",
                           pre_masks=_pre_masks(tts16))
    assert mel.dtype == np.float32 and np.isfinite(mel).all()
