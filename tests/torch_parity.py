"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py):
a tiny model config, and the JAX-initialised weights loaded into the
port's modules through ``state_dict_from_jax``."""

from __future__ import annotations

import contextlib

import jax
import numpy as np
import pytest

BASE_AP = {
    "attention_type": "ForwardAttention",
    "attention_dim": 16,
    "attention_location_n_filters": 8,
    "attention_location_kernel_size": 15,
    "windowing": False,
    "norm": "softmax",
    "forward_attn": True,
    "trans_agent": True,
    "forward_attn_mask": False,
}

TINY_MODEL = {
    "mask_padding": False, "n_mel_channels": 10,
    "n_frames_per_step": 2, "n_symbols": 200,
    "symbols_embedding_dim": 16, "encoder_n_convolutions": 2,
    "encoder_embedding_dim": 16, "encoder_kernel_size": 5,
    "speaker_emb_type": "static", "num_speakers": 3,
    "speaker_embedding_dim": 8, "speaker_embedding_dim_lin": 6,
    "attention_rnn_dim": 20, "decoder_rnn_dim": 28, "prenet_dim": 12,
    "max_decoder_steps": 17, "gate_threshold": 0.5,
    "p_attention_dropout": 0.1, "p_decoder_dropout": 0.1,
    "postnet_embedding_dim": 16, "postnet_kernel_size": 5,
    "postnet_n_convolutions": 2,
    "attention_params": dict(BASE_AP),
}


def model_dict(**over) -> dict:
    ap = dict(BASE_AP, **over.pop("ap", {}))
    return dict(TINY_MODEL, attention_params=ap, **over)


def jax_and_port_models(mp: dict, seed: int = 0):
    """JAX ``(cfg, params, state)`` initialised from ``seed`` and the
    port's ``(cfg, Tacotron2NV)`` holding the same weights."""
    from msa_tts_tpu.models import config_from_params as jax_cfp
    from msa_tts_tpu.models import init_tacotron2nv
    from msa_tts_tpu_torch.models.tacotron2nv import (
        Tacotron2NV,
        config_from_params,
    )
    from msa_tts_tpu_torch.utils.convert import state_dict_from_jax

    jcfg = jax_cfp(dict(mp))
    params, state = init_tacotron2nv(jax.random.PRNGKey(seed), jcfg)
    cfg = config_from_params(dict(mp))
    model = Tacotron2NV(cfg)
    model.load_state_dict(
        state_dict_from_jax(jax.device_get(params), jax.device_get(state),
                            cfg),
        strict=True,
    )
    return (jcfg, params, state), (cfg, model.eval())


def randn(seed: int, *shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32
    )


# ------------------------------------------------------------- vocoders

HIFIGAN_H = dict(resblock="1", upsample_rates=[8, 4, 4],
                 upsample_kernel_sizes=[16, 8, 8],
                 upsample_initial_channel=16,
                 resblock_kernel_sizes=[3, 5],
                 resblock_dilation_sizes=[[1, 3], [1, 2]])


def vocoder_pairs(n_mels: int, hop: int = 128, mode: str = "MOL",
                  seed: int = 0):
    """Tiny WaveRNN and HiFi-GAN vocoders for a serving config of
    ``n_mels`` and ``hop`` (128 = 4·4·8 = 8·4·4), each as the JAX
    package's object and the port's with the same weights:
    ``{"wavernn": (jax, port), "hifigan": (jax, port)}``.  The WaveRNNs
    keep f32 sample-loop weights, so that the two sides differ by
    summation order only."""
    from msa_tts_tpu.vocoders import hifigan as JH
    from msa_tts_tpu.vocoders import wavernn as JW
    from msa_tts_tpu_torch.utils.convert import (
        hifigan_state_dict_from_jax,
        wavernn_state_dict_from_jax,
    )
    from msa_tts_tpu_torch.vocoders import hifigan as TH
    from msa_tts_tpu_torch.vocoders import wavernn as TW

    assert hop == 128
    kw = dict(mode=mode, rnn_dims=32, fc_dims=32, res_out_dims=16,
              compute_dims=16, n_mels=n_mels, res_blocks=2, hop_length=hop,
              pad=2, upsample_factors=(4, 4, 8))
    jcfg, tcfg = JW.WaveRNNConfig(**kw), TW.WaveRNNConfig(**kw)
    params, state = JW.init_wavernn(jax.random.PRNGKey(seed), jcfg)
    model = TW.WaveRNNModel(tcfg)
    model.load_state_dict(wavernn_state_dict_from_jax(
        jax.device_get(params), jax.device_get(state), tcfg), strict=True)
    jw = JW.WaveRNN(params=params, state=state, cfg=jcfg, gen_dtype=None,
                    gen_backend="xla")
    tw = TW.WaveRNN(model, tcfg, gen_dtype=None)

    hp = JH.init_generator(jax.random.PRNGKey(seed + 1), HIFIGAN_H,
                           n_mels=n_mels)
    rng = np.random.default_rng(seed)
    hp = jax.tree_util.tree_map(       # unit-order weights, not N(0, 0.01)
        lambda x: jax.numpy.asarray(
            (np.asarray(x) * 20 + rng.normal(0, 0.05, x.shape))
            .astype(np.float32)), hp)
    gen = TH.Generator(HIFIGAN_H, n_mels)
    gen.load_state_dict(hifigan_state_dict_from_jax(
        jax.device_get(hp), HIFIGAN_H), strict=True)
    return {"wavernn": (jw, tw),
            "hifigan": (JH.HiFiGAN.from_params(hp, HIFIGAN_H),
                        TH.HiFiGAN.from_params(gen, HIFIGAN_H))}


def jax_wavernn_noise(jvoc, rng, n_utts: int, n_frames_padded: int,
                      target: int = 2_750, overlap: int = 550):
    """The sampling noise ``WaveRNN.generate_batch(mels, rng=rng)`` of
    the JAX package draws for ``n_utts`` mels padded to
    ``n_frames_padded`` frames: one ``(noise1, noise2)`` numpy pair per
    utterance, for the port's ``noises=`` / ``voc_noise=``."""
    from msa_tts_tpu.vocoders import wavernn as JW

    cfg = jvoc.cfg
    _, n_pad = JW._fold_counts(n_frames_padded * cfg.hop_length, target,
                               overlap)
    out = []
    for key in jax.random.split(rng, n_utts):
        n1, n2 = JW._generation_noise(cfg, key, target + 2 * overlap, n_pad)
        out.append((np.array(n1), np.array(n2)))
    return out


# ------------------------------------------------------------ adaptation

def jax_forward_masks(rng, jcfg, B: int, T_in: int, T_mel: int) -> dict:
    """The raw 0/1 dropout masks the JAX package's training
    ``tacotron2nv_forward(..., rng, train=True)`` draws from ``rng``, in
    the port's layout (``models.tacotron2nv.dropout_masks``): the
    encoder under ``fold_in(rng, 1)`` split per convolution; the decoder
    under ``fold_in(rng, 2)`` split into the prenet's key (``fold_in``
    per layer over (T_dec, B, P)) and the scan's (split per step, each
    step's split into the attention's and the decoder's mask); the
    postnet under ``fold_in(rng, 3)`` split per layer."""
    from jax import random as R

    def draw(key, rate, shape):
        return np.asarray(R.bernoulli(key, 1.0 - rate, shape), np.float32)

    T_dec = T_mel // jcfg.n_frames_per_step
    E, M = jcfg.encoder_embedding_dim, jcfg.postnet_embedding_dim
    n_post = jcfg.postnet_n_convolutions
    enc_keys = R.split(R.fold_in(rng, 1), jcfg.encoder_n_convolutions)
    k_pre, k_scan = R.split(R.fold_in(rng, 2))
    steps = [R.split(k) for k in R.split(k_scan, T_dec)]
    post_keys = R.split(R.fold_in(rng, 3), n_post)
    return {
        "encoder": [draw(k, 0.5, (B, E, T_in)) for k in enc_keys],
        "prenet": np.stack([draw(R.fold_in(k_pre, i), jcfg.p_prenet_dropout,
                                 (T_dec, B, jcfg.prenet_dim))
                            for i in range(2)], axis=1),
        "attention": np.stack([draw(k1, jcfg.p_attention_dropout,
                                    (B, jcfg.attention_rnn_dim))
                               for k1, _ in steps]),
        "decoder": np.stack([draw(k2, jcfg.p_decoder_dropout,
                                  (B, jcfg.decoder_rnn_dim))
                             for _, k2 in steps]),
        "postnet": [draw(k, 0.5, (B, jcfg.n_mel_channels if i == n_post - 1
                                  else M, T_mel))
                    for i, k in enumerate(post_keys)],
    }


def jax_metatest_masks(rng, jcfg, n_inner: int, B: int, T_in: int,
                       T_mel: int) -> list:
    """Every pass's masks of the JAX package's ``make_metatest_fn`` under
    ``rng``: ``split(rng)`` into the adaptation's key (split ``n_inner``
    ways, one per step) and the query pass's."""
    k_adapt, k_query = jax.random.split(rng)
    keys = list(jax.random.split(k_adapt, n_inner)) + [k_query]
    return [jax_forward_masks(k, jcfg, B, T_in, T_mel) for k in keys]


# ------------------------------------------------------- meta-training

def jax_trainer_masks(train_seed: int, jcfg, phase: str, epoch: int,
                      itr_b: int, n_tasks: int, n_pass: int, B: int,
                      T_in: int, T_mel: int) -> list:
    """Every dropout mask the JAX package's MAML trainer draws for one
    meta-batch, ``[task][pass]``, for the port trainer's ``_draw_masks``:
    ``split(rng, 3)`` per epoch into ``(rng, k_train, k_meta)`` from
    ``PRNGKey(train_seed)``; a step's key ``fold_in(k_train, itr_b)``
    (meta-test: ``k_meta``) split per task, each task's passes as
    :func:`jax_metatest_masks` draws them; a meta-test task's last pass
    is the forward its MCD is read from, under the task's key itself."""
    rng = jax.random.PRNGKey(train_seed)
    for _ in range(epoch):
        rng, k_train, k_meta = jax.random.split(rng, 3)
    base = k_train if phase == "train" else k_meta
    keys = jax.random.split(jax.random.fold_in(base, itr_b), n_tasks)
    if phase == "train":
        return [jax_metatest_masks(k, jcfg, n_pass - 1, B, T_in, T_mel)
                for k in keys]
    return [jax_metatest_masks(k, jcfg, n_pass - 2, B, T_in, T_mel)
            + [jax_forward_masks(k, jcfg, B, T_in, T_mel)] for k in keys]


def jax_serve_masks(tts) -> np.ndarray:
    """The prenet masks the JAX package's ``synthesize`` draws under its
    default key, for the port's ``synthesize(..., pre_masks=...)``."""
    from msa_tts_tpu.models.pallas_decoder import _prenet_masks

    dcfg = tts.cfg.decoder_config()
    key = jax.random.fold_in(jax.random.PRNGKey(0), 2)
    return np.array(_prenet_masks(dcfg, key, dcfg.max_decoder_steps, 1))


TINY_AUDIO = {"n_fft": 1024, "win_length": 1024, "hop_length": 256,
              "n_mels": 10, "sample_rate": 22050, "f_min": 0.0,
              "f_max": 8000.0, "n_mfcc": 13, "griffinlim_iters": 4}


def tiny_corpus(root: str, n_speakers: int = 2) -> str:
    """A synthetic corpus for the tiny model (8-dim d-vectors, 5 clips of
    0.25-0.4 s per speaker); returns ``root``."""
    from msa_tts_tpu_torch.dataloaders.synthetic import make_synthetic_corpus

    make_synthetic_corpus(root, n_speakers=n_speakers,
                          utterances_per_speaker=5, min_dur=0.25,
                          max_dur=0.4, spk_emb_dim=8, seed=4)
    return root


def tiny_maml_params(root: str, out: str, **over) -> dict:
    """The tiny MAML experiment on :func:`tiny_corpus`: the model of
    :data:`TINY_MODEL` (mask_padding on), 2 tasks a meta-batch (one step
    an epoch with 2 speakers), 2 shots, one second-order inner step, a
    meta-test of one step after epoch 2, SGD outer steps, the clip on."""
    from msa_tts_tpu_torch.dataloaders.synthetic import synthetic_params

    p = synthetic_params(root, n_speakers=2, batch_size=2,
                         model_overrides=model_dict(mask_padding=True))
    p.update(
        method="maml", experiment_name="tiny", output_path=out,
        audio_params=dict(TINY_AUDIO), n_epochs=2, meta_batch_size=2,
        n_inner_train=1, n_inner_test=1, track_higher_grads=True,
        metatest_epoch_interval=2, ckpt_save_epoch_interval=1,
        use_tensorboard=False, plot_examples=False, train_seed=3,
        optim_outer={"optimizer_type": "SGD", "lr": "1e-2"},
        grad_clip_thresh=5.0, maml_remat=False,
    )
    p.update(over)
    return p


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side of a module on one CPU thread (restored after):
    the tiny model's ops are too small to share, and test workers running
    side by side otherwise oversubscribe the cores."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def fresh_port_guard():
    """Around a test that builds a port trainer: the port's process-wide
    preemption guard cleared before, and after it the guard's signal
    handlers uninstalled and ``PreemptionGuard._shared`` reset to None.
    Every port trainer installs that guard on SIGTERM and it stays set
    once a notice arrives (as in production); left installed, another
    package's guard in the same test process chains its own SIGTERMs
    into it, which sets the flag that stops the next port trainer at
    its first step, and a second such notice escalates and kills the
    process."""
    from msa_tts_tpu_torch.utils.preemption import PreemptionGuard

    if PreemptionGuard._shared is not None:
        PreemptionGuard._shared.clear()
    try:
        yield
    finally:
        with PreemptionGuard._shared_lock:
            if PreemptionGuard._shared is not None:
                PreemptionGuard._shared.uninstall()
            PreemptionGuard._shared = None


@pytest.fixture
def port_guard():
    """:func:`fresh_port_guard` around one test; trainer test files take
    it with ``pytestmark = pytest.mark.usefixtures("port_guard")``."""
    with fresh_port_guard():
        yield


# ------------------------------------------- joint and continual training

def jax_joint_keys(train_seed: int, epoch: int):
    """The JAX joint trainer's keys of ``epoch``: ``split(rng, 4)`` per
    epoch from ``PRNGKey(train_seed)``, skipped epochs too, into ``(rng,
    k_train, k_test, k_meta)``; returns ``(k_train, k_test, k_meta)``."""
    rng = jax.random.PRNGKey(train_seed)
    for _ in range(epoch):
        rng, k_train, k_test, k_meta = jax.random.split(rng, 4)
    return k_train, k_test, k_meta


def jax_task_keys(train_seed: int, num_initial: int, spk_itr: int):
    """The keys a JAX continual stream gives task ``spk_itr``: from
    ``PRNGKey(train_seed)``, ``rng, k = split(rng)`` for the initial
    phase (task 0 with ``num_initial`` > 0: returns ``(k, None)``), then
    ``rng, k1, k2 = split(rng, 3)`` per stream task from ``num_initial``
    on: ``(k1, k2)``, k1 the task's train and test steps', k2 its
    cumulative test's."""
    rng = jax.random.PRNGKey(train_seed)
    if num_initial > 0:
        rng, k = jax.random.split(rng)
        if spk_itr == 0:
            return k, None
    for _ in range(num_initial, spk_itr + 1):
        rng, k1, k2 = jax.random.split(rng, 3)
    return k1, k2


def jax_step_key(train_seed: int, phase: str, key: tuple,
                 num_initial: int = 0):
    """The JAX key of the pass the port's trainers name ``(phase, key)``
    at their mask seam (``TrainerBase._draw_step_masks``): the joint
    trainer's ``"train"`` / ``"test"`` (epoch, step) → ``fold_in(k_train
    / k_test, step)``; a continual task's ``"task"`` (task, global step)
    → ``fold_in(k1, step)``, ``"task_test"`` (task, step) →
    ``fold_in(k1, step)``, ``"cumulative"`` (task, step) → ``fold_in(k2,
    step)``; EWC's ``"fisher"`` (task, step) → ``fold_in(PRNGKey(task),
    step)``; ER-KD's ``"kd"`` (kd_seed,) → ``PRNGKey(kd_seed)``."""
    R = jax.random
    if phase in ("train", "test"):
        k_train, k_test, _ = jax_joint_keys(train_seed, key[0])
        return R.fold_in(k_train if phase == "train" else k_test, key[1])
    if phase in ("task", "task_test", "cumulative"):
        k1, k2 = jax_task_keys(train_seed, num_initial, key[0])
        return R.fold_in(k2 if phase == "cumulative" else k1, key[1])
    if phase == "fisher":
        return R.fold_in(R.PRNGKey(key[0]), key[1])
    if phase == "kd":
        return R.PRNGKey(key[0])
    raise ValueError(phase)


def torch_masks(tree):
    """A tree of numpy masks as CPU tensors."""
    import torch

    if isinstance(tree, dict):
        return {k: torch_masks(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [torch_masks(v) for v in tree]
    return torch.as_tensor(np.asarray(tree))


def from_jax_masks(cls, jcfg, train_seed: int, num_initial: int = 0):
    """A subclass of the port trainer ``cls`` whose mask seams draw the
    JAX package's masks: ``_draw_step_masks`` by :func:`jax_step_key`;
    ``_draw_masks`` (meta-batches) as the JAX MAML / Reptile trainers
    (``"train"`` / ``"test"``, :func:`jax_trainer_masks`) or the joint
    trainer's meta-test (``"metatest"``: ``split(fold_in(k_meta, itr_b),
    K)``, each task's inner steps and query pass) draw them."""

    class FromJax(cls):
        def _draw_step_masks(self, phase, key, batch):
            B, T_in = batch["inputs"].shape
            return torch_masks(jax_forward_masks(
                jax_step_key(train_seed, phase, key, num_initial), jcfg, B,
                T_in, batch["melspecs"].shape[-1]))

        def _draw_masks(self, phase, epoch, itr_b, n_tasks, n_pass, batch):
            _, B, T_in = batch["inputs"].shape
            T_mel = batch["melspecs"].shape[-1]
            if phase != "metatest":
                return torch_masks(jax_trainer_masks(
                    train_seed, jcfg, phase, epoch, itr_b, n_tasks, n_pass,
                    B, T_in, T_mel))
            k_meta = jax_joint_keys(train_seed, epoch)[2]
            keys = jax.random.split(jax.random.fold_in(k_meta, itr_b),
                                    n_tasks)
            return torch_masks([jax_metatest_masks(k, jcfg, n_pass - 1, B,
                                                   T_in, T_mel)
                                for k in keys])

    FromJax.__name__ = cls.__name__
    return FromJax


def install_jax_init(port_trainer, jax_trainer):
    """Start ``port_trainer`` from ``jax_trainer``'s initial weights and
    batch-norm state (read before the JAX trainer runs: it donates its
    train state), with a fresh optimizer state; returns the state dict."""
    from msa_tts_tpu_torch.utils.convert import state_dict_from_jax

    t = port_trainer
    sd = state_dict_from_jax(jax.device_get(jax_trainer.train_state.params),
                             jax.device_get(
                                 jax_trainer.train_state.model_state),
                             t.cfg)
    p = {k: sd[k] for k in t.param_names}
    tx = getattr(t, "outer_tx", None) or t.tx
    t.train_state = t.train_state._replace(
        params=p, model_state={k: sd[k] for k in t.model_state},
        opt_state=tx.init(p))
    return sd


def tiny_train_params(root: str, out: str, method: str, n_speakers: int = 2,
                      **over) -> dict:
    """The tiny model of :data:`TINY_MODEL` (mask_padding on) on
    :func:`tiny_corpus` for the joint, Reptile and continual trainers:
    batches of 2, Adam of the synthetic params, no plots or TensorBoard,
    every step logged, then ``over``."""
    from msa_tts_tpu_torch.dataloaders.synthetic import synthetic_params

    p = synthetic_params(root, n_speakers=n_speakers, batch_size=2,
                         model_overrides=model_dict(mask_padding=True))
    p.update(method=method, experiment_name="tiny", output_path=out,
             audio_params=dict(TINY_AUDIO), use_tensorboard=False,
             plot_examples=False, tb_log_interval=1, train_seed=3)
    p.update(over)
    return p
