"""The port's WaveRNN trainer (``msa_tts_tpu_torch/trainers/
wavernn_train.py``) against the JAX package's on a tiny synthetic corpus
(the widths of ``tests/test_wavernn_train.py``: rnn/fc 32, 2 res blocks,
upsample (4, 8, 8) for hop 256; batches of 2 windows of 512 samples),
from the JAX trainer's initial weights, in MOL and GAUSS:

- the batches ``_sample_batch`` draws, byte for byte (both packages'
  host feature libraries and resamplers compute the same bits);
- one step from the same state on the same batch: the loss within 1e-5
  relative, Adam's moments after it (``mu`` = 0.1·g, so the gradient
  itself; ``nu`` = 0.001·g²) within 1e-5 of each tensor's largest
  |value|, the step count equal;
- ``run()``: every logged ``train/nll`` (3 steps MOL, 2 GAUSS) within
  1e-5 relative (Adam's first step is lr·sign(g), so a weight whose
  gradient is float noise may move the other way; the moments above
  are held instead of raw weights);
- ``wavernn_<step>.ckpt``: the port's restores in the JAX package with
  its ``restore_like`` bit for bit, the JAX package's restores in the
  port bit for bit, and the trained checkpoint generates what the JAX
  package's ``WaveRNN`` generates from it with the same noise (the plain
  loop, f32 weights): 1e-4 absolute, as ``tests/test_torch_vocoders.py``
  holds generated waveforms."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msa_tts_tpu.trainers.wavernn_train import WaveRNNTrainer as JaxTrainer
from msa_tts_tpu.utils import checkpoint as JC
from msa_tts_tpu.vocoders import wavernn as JW
from msa_tts_tpu_torch.dataloaders.synthetic import synthetic_params
from msa_tts_tpu_torch.trainers.wavernn_train import WaveRNNTrainer
from msa_tts_tpu_torch.utils.checkpoint import load_checkpoint
from msa_tts_tpu_torch.utils.convert import (
    wavernn_jax_from_state_dict,
    wavernn_state_dict_from_jax,
)
from msa_tts_tpu_torch.vocoders import wavernn as TW
from torch_parity import TINY_AUDIO, one_torch_thread, port_guard, tiny_corpus  # noqa

pytestmark = pytest.mark.usefixtures("port_guard")

RTOL = 1e-5
WAV_ATOL = 1e-4
STEPS = {"MOL": 3, "GAUSS": 2}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return tiny_corpus(str(tmp_path_factory.mktemp("wavernn_corpus")))


def vocoder_params(root: str, out: str, **over) -> dict:
    p = synthetic_params(root, n_speakers=2, batch_size=2)
    p.update(method="wavernn", experiment_name="tiny", output_path=out,
             audio_params=dict(TINY_AUDIO), use_tensorboard=False,
             voc_mode="MOL", rnn_dims=32, fc_dims=32, compute_dims=16,
             res_out_dims=16, res_blocks=2, pad=2,
             upsample_factors=(4, 8, 8), seq_len=512, batch_size=2,
             n_steps=3, lr=1e-3, train_seed=5, tb_log_interval=1,
             print_interval=100, ckpt_save_step_interval=1000)
    p.update(over)
    return p


def install_jax_init(pt, jt):
    """Start the port's trainer from the JAX trainer's weights (read
    before it runs: its step donates them) with a fresh Adam."""
    sd = wavernn_state_dict_from_jax(jax.device_get(jt.model_params),
                                     jax.device_get(jt.model_state), pt.cfg)
    pt.model_params = {k: sd[k] for k in pt.model_params}
    pt.model_state = {k: sd[k] for k in pt.model_state}
    pt.opt_state = pt.tx.init(pt.model_params)


def _close(ours, ref):
    scale = max(float(np.abs(ref).max()), 1e-30)
    assert ours.shape == ref.shape
    assert float(np.abs(ours - ref).max()) <= RTOL * scale


def _logged(path):
    return [json.loads(line)["value"] for line in open(path)]


def _leaves(tree):
    return jax.tree_util.tree_leaves(jax.device_get(tree))


@pytest.mark.parametrize("mode", ["MOL", "GAUSS"])
def test_trainer_matches_jax(corpus, tmp_path, mode):
    p = vocoder_params(corpus, str(tmp_path), voc_mode=mode,
                       n_steps=STEPS[mode])
    jt = JaxTrainer(**dict(p, output_path=str(tmp_path / "jax")))
    pt = WaveRNNTrainer(**dict(p, output_path=str(tmp_path / "port")),
                        device="cpu")
    install_jax_init(pt, jt)

    # ---- the batches, byte for byte
    rj, rp = np.random.default_rng(1), np.random.default_rng(1)
    for _ in range(3):
        jm, jw = jt._sample_batch(rj, 2)
        tm, tw = pt._sample_batch(rp, 2)
        assert tm.numpy().tobytes() == np.asarray(jm).tobytes()
        assert tw.numpy().tobytes() == np.asarray(jw).tobytes()
        assert tm.shape == (2, 10, 512 // 256 + 4) and tw.shape == (2, 513)

    # ---- one step from the same state (copies: the JAX step donates)
    copy = lambda t: jax.tree_util.tree_map(jnp.array, t)  # noqa: E731
    j_params, j_opt, j_loss = jt._step_jit(copy(jt.model_params),
                                           copy(jt.opt_state), jm, jw)
    before = {k: v.clone() for k, v in pt.model_params.items()}
    t_params, t_opt, t_loss = pt._step(pt.model_params, pt.opt_state, tm, tw)
    assert abs(float(t_loss) - float(j_loss)) <= RTOL * abs(float(j_loss))
    adam, j_adam = t_opt[0], j_opt[0]
    assert int(adam["count"]) == int(j_adam.count) == 1
    for name in ("mu", "nu"):
        ours = _leaves(wavernn_jax_from_state_dict(adam[name], pt.cfg)[0])
        ref = _leaves(getattr(j_adam, name))
        assert len(ours) == len(ref)
        for a, b in zip(ours, ref):
            _close(a, b)
    # the step leaves its inputs as they were, and moves every weight
    assert all(torch.equal(before[k], v) for k, v in pt.model_params.items())
    assert all(not torch.equal(t_params[k], v)
               for k, v in pt.model_params.items() if k.endswith("_l0"))

    # ---- the runs: every step's logged loss
    j_final, t_final = jt.run(), pt.run()
    jl, tl = _logged(jt.logger.jsonl_path), _logged(pt.logger.jsonl_path)
    assert len(jl) == len(tl) == STEPS[mode]
    for a, b in zip(tl, jl):
        assert abs(a - b) <= RTOL * abs(b), (tl, jl)
    assert abs(t_final - j_final) <= RTOL * abs(j_final)

    # ---- checkpoints, each read by the other package
    name = f"wavernn_{STEPS[mode]}.ckpt"
    port_ckpt = os.path.join(pt.path_manager.checkpoints_path, name)
    jax_ckpt = os.path.join(jt.path_manager.checkpoints_path, name)
    raw = load_checkpoint(port_ckpt)
    restored = {k: JC.restore_like(jax.device_get(getattr(jt, attr)), raw[k])
                for k, attr in (("params", "model_params"),
                                ("model_state", "model_state"),
                                ("opt_state", "opt_state"))}
    assert int(raw["step"]) == STEPS[mode]
    sd = wavernn_state_dict_from_jax(restored["params"],
                                     restored["model_state"], pt.cfg)
    for k, v in pt.model_params.items():
        assert torch.equal(sd[k], v), k
    mu = wavernn_jax_from_state_dict(pt.opt_state[0]["mu"], pt.cfg)[0]
    for a, b in zip(_leaves(restored["opt_state"][0].mu), _leaves(mu)):
        assert np.array_equal(a, b)
    assert int(restored["opt_state"][0].count) == STEPS[mode]

    back = WaveRNNTrainer(**dict(p, output_path=str(tmp_path / "back")),
                          device="cpu")
    back.restore(jax_ckpt)
    ref = wavernn_state_dict_from_jax(jax.device_get(jt.model_params),
                                      jax.device_get(jt.model_state), pt.cfg)
    for k, v in back.model_params.items():
        assert torch.equal(v, ref[k]), k
    j_mu = wavernn_state_dict_from_jax(
        jax.device_get(jt.opt_state[0].mu), jax.device_get(jt.model_state),
        pt.cfg)
    for k, v in back.opt_state[0]["mu"].items():
        assert torch.equal(v, j_mu[k]), k
    assert back.step_global == STEPS[mode]
    assert int(back.opt_state[0]["count"]) == STEPS[mode]


def test_trained_checkpoint_generates_as_jax(corpus, tmp_path):
    """The port's trained ``.ckpt`` through both packages' ``WaveRNN``
    (the plain sample loop, f32 weights) with the same noise."""
    p = vocoder_params(corpus, str(tmp_path), n_steps=2)
    pt = WaveRNNTrainer(**p, device="cpu")
    pt.run()
    raw = load_checkpoint(os.path.join(pt.path_manager.checkpoints_path,
                                       "wavernn_2.ckpt"))
    jcfg = JW.config_from_params(**p)
    j_params, j_state = JW.init_wavernn(jax.random.PRNGKey(0), jcfg)
    j_params = JC.restore_like(jax.device_get(j_params), raw["params"])
    j_state = JC.restore_like(jax.device_get(j_state), raw["model_state"])
    jv = JW.WaveRNN(params=j_params, state=j_state, cfg=jcfg, gen_dtype=None,
                    gen_backend="xla")
    model = TW.WaveRNNModel(pt.cfg)
    model.load_state_dict(wavernn_state_dict_from_jax(
        raw["params"], raw["model_state"], pt.cfg), strict=True)
    tv = TW.WaveRNN(model, pt.cfg, gen_dtype=None)
    mel = pt.dataset.items[0].mel[None, :, :6]
    target, overlap = 256, 64
    key = jax.random.PRNGKey(4)
    want = jv.generate(mel, target=target, overlap=overlap, rng=key,
                       verbose=False)
    _, n_pad = JW._fold_counts(6 * jcfg.hop_length, target, overlap)
    n1, n2 = JW._generation_noise(jcfg, key, target + 2 * overlap, n_pad)
    got = tv.generate(mel, target=target, overlap=overlap,
                      noise=(np.array(n1), np.array(n2)), verbose=False)
    assert len(got) == len(want) == 5 * jcfg.hop_length
    assert np.abs(got).max() > 0
    np.testing.assert_allclose(got, want, atol=WAV_ATOL, rtol=0)
