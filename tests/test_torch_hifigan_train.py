"""The port's HiFi-GAN trainer (``msa_tts_tpu_torch/trainers/
hifigan_train.py``) against the JAX package's on a tiny synthetic corpus:
the tiny generator of ``tests/torch_parity.py`` (``HIFIGAN_H``, hop 128)
against the full-width discriminators (their widths are fixed), segments
of 1024 samples, batches of 2, from the JAX trainer's initial weights:

- the batches ``_sample_batch`` draws (segments and their host "ap2"
  log-mels), byte for byte;
- one step (the discriminators' update, then the generator's against
  the updated discriminators) from the same state on the same batch:
  ``loss_d``, ``loss_g`` and ``loss_mel`` within 1e-5 relative; both
  Adams' moments after it, which hold each gradient: ``mu`` = 0.2·g and
  the square root of ``nu`` = 0.01·g², each within 1e-5 of the tensor's
  largest |value| (the generator's N(0, 0.01) weights leave its inner
  layers gradients of 1e-11 to 1e-7, held to that relative bound too);
- ``hifigan_<step>.ckpt``: the port's restores in the JAX package with
  its ``restore_like`` bit for bit (generator, discriminators, both
  optimizer states, the step), and the JAX package's in the port."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msa_tts_tpu.trainers.hifigan_train import HiFiGANTrainer as JaxTrainer
from msa_tts_tpu.utils import checkpoint as JC
from msa_tts_tpu_torch.dataloaders.synthetic import synthetic_params
from msa_tts_tpu_torch.trainers.hifigan_train import HiFiGANTrainer
from msa_tts_tpu_torch.utils.checkpoint import load_checkpoint
from msa_tts_tpu_torch.utils.convert import (
    state_dict_to_tree,
    tree_to_state_dict,
)
from torch_parity import HIFIGAN_H, one_torch_thread, port_guard, tiny_corpus  # noqa

pytestmark = pytest.mark.usefixtures("port_guard")

RTOL = 1e-5
AP2 = {"n_fft": 512, "hop_size": 128, "win_size": 512, "n_mels": 10,
       "sample_rate": 22050, "fmin": 0.0, "fmax": 8000.0, "center": False}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return tiny_corpus(str(tmp_path_factory.mktemp("hifigan_corpus")))


def hifigan_params(root: str, out: str, **over) -> dict:
    p = synthetic_params(root, n_speakers=2, batch_size=2)
    p.update(method="hifigan", experiment_name="tiny", output_path=out,
             audio_processor="ap2", audio_params=dict(AP2),
             hifigan=dict(HIFIGAN_H), segment_size=1024, batch_size=2,
             n_steps=1, lr=2e-4, train_seed=3, use_tensorboard=False,
             tb_log_interval=1, print_interval=100,
             ckpt_save_step_interval=1000)
    p.update(over)
    return p


def _close(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(ours - ref).max())
    assert err <= RTOL * scale, (err, scale)


def _leaves(tree):
    return jax.tree_util.tree_leaves(jax.device_get(tree))


@pytest.fixture(scope="module")
def pair(corpus, tmp_path_factory):
    """The JAX trainer and the port's from its initial weights."""
    out = tmp_path_factory.mktemp("hifigan_out")
    p = hifigan_params(corpus, str(out))
    jt = JaxTrainer(**dict(p, output_path=str(out / "jax")))
    pt = HiFiGANTrainer(**dict(p, output_path=str(out / "port")),
                        device="cpu")
    pt.gen_params = tree_to_state_dict(jax.device_get(jt.gen_params))
    pt.disc_params = tree_to_state_dict(jax.device_get(jt.disc_params))
    pt.opt_g, pt.opt_d = (pt.tx_g.init(pt.gen_params),
                          pt.tx_d.init(pt.disc_params))
    return p, jt, pt


def test_batches_and_one_step_match_jax(pair):
    p, jt, pt = pair
    rj, rp = np.random.default_rng(2), np.random.default_rng(2)
    for _ in range(2):
        jm, jw = jt._sample_batch(rj, 2)
        tm, tw = pt._sample_batch(rp, 2)
        assert tm.numpy().tobytes() == np.asarray(jm).tobytes()
        assert tw.numpy().tobytes() == np.asarray(jw).tobytes()
    assert tm.shape == (2, 10, 8) and tw.shape == (2, 1024)

    copy = lambda t: jax.tree_util.tree_map(jnp.array, t)  # noqa: E731
    j_out = jt._step_jit(copy(jt.gen_params), copy(jt.disc_params),
                         copy(jt.opt_g), copy(jt.opt_d), jm, jw)
    t_out = pt._step(pt.gen_params, pt.disc_params, pt.opt_g, pt.opt_d,
                     tm, tw)
    for k in ("loss_d", "loss_g", "loss_mel"):
        a, b = float(t_out[4][k]), float(j_out[4][k])
        assert abs(a - b) <= RTOL * abs(b), (k, a, b)
    assert float(t_out[4]["loss_mel"]) > 0
    for t_opt, j_opt in ((t_out[2], j_out[2]), (t_out[3], j_out[3])):
        assert len(t_opt) == len(j_opt) == 3          # adam, decay, lr
        assert int(t_opt[0]["count"]) == int(j_opt[0].count) == 1
        for name, f in (("mu", np.asarray), ("nu", np.sqrt)):
            ours = _leaves(state_dict_to_tree(t_opt[0][name]))
            ref = _leaves(getattr(j_opt[0], name))
            assert len(ours) == len(ref) > 0
            for a, b in zip(ours, ref):
                _close(f(a), f(b))
    # the updated weights: every tensor moved
    for t_new, old in ((t_out[0], pt.gen_params), (t_out[1],
                                                   pt.disc_params)):
        assert all(not torch.equal(t_new[k], v) for k, v in old.items())


def test_checkpoints_read_by_the_other_package(pair, tmp_path):
    p, jt, pt = pair
    templates = {"generator": jax.device_get(jt.gen_params),
                 "discriminators": jax.device_get(jt.disc_params),
                 "opt_g": jax.device_get(jt.opt_g),
                 "opt_d": jax.device_get(jt.opt_d)}
    final = pt.run()
    assert np.isfinite(list(final.values())).all()
    raw = load_checkpoint(os.path.join(pt.path_manager.checkpoints_path,
                                       "hifigan_1.ckpt"))
    assert int(raw["step"]) == 1
    for key, ours in (("generator", pt.gen_params),
                      ("discriminators", pt.disc_params)):
        restored = tree_to_state_dict(
            JC.restore_like(templates[key], raw[key]))
        assert restored.keys() == ours.keys()
        assert all(torch.equal(restored[k], v) for k, v in ours.items())
    for key, ours in (("opt_g", pt.opt_g), ("opt_d", pt.opt_d)):
        restored = JC.restore_like(templates[key], raw[key])
        assert int(restored[0].count) == 1
        for name in ("mu", "nu"):
            sd = tree_to_state_dict(getattr(restored[0], name))
            assert all(torch.equal(sd[k], v)
                       for k, v in ours[0][name].items())

    jt.run()
    back = HiFiGANTrainer(**dict(p, output_path=str(tmp_path / "back")),
                          device="cpu")
    back.restore(os.path.join(jt.path_manager.checkpoints_path,
                              "hifigan_1.ckpt"))
    assert back.step_global == 1
    for ours, ref in ((back.gen_params, jt.gen_params),
                      (back.disc_params, jt.disc_params),
                      (back.opt_d[0]["nu"], jt.opt_d[0].nu)):
        ref = tree_to_state_dict(jax.device_get(ref))
        assert all(torch.equal(v, ref[k]) for k, v in ours.items())
