"""Every port trainer with ``parallel: {dp, task}`` over 2 gloo ranks on
the CPU against the same run at world 1 (the JAX package's
``tests/test_trainer_parallel.py``, at the tiny widths of
``tests/torch_parity.py``): the joint trainer (batches of 4 and a ragged
tail of 1, which runs whole on both ranks), MAML (``task: 2``), Reptile
batched and sequential, the ER stream, WaveRNN and HiFi-GAN.  One spawn
runs them all (``tests/torch_parallel_ranks.py::trainer_cases``); the
world-1 runs are this process's.  Also: a world-2 joint checkpoint
resumed at world 1 equals the unbroken world-1 run; only rank 0 writes
files; a SIGTERM to rank 1 stops both ranks at the same step.

Tensor parallelism on the same 2 ranks (``parallel: {tp: 2}``, the
trainers' smallest split axis set to 8 in the ranks so that the tiny
widths split): the joint trainer,
second-order MAML (its meta-test runs on both tp ranks) and EWC against
world 1; a tp-2 checkpoint resumed at world 1, a world-1 checkpoint
resumed at tp 2; ``{task: 2, tp: 2}`` raises the JAX package's text.

Limits: weights and batch-norm statistics within 3e-5 absolute (the
JAX package's limit); the ranks' weights equal bit for bit.
"""

import os

import numpy as np
import pytest
import torch

import torch_parallel_ranks as R
from msa_tts_tpu_torch.parallel.launch import spawn
from torch_parity import (
    HIFIGAN_H,
    TINY_AUDIO,
    one_torch_thread,  # noqa: F401  (an autouse fixture)
    port_guard,  # noqa: F401  (taken by pytestmark)
    tiny_corpus,
    tiny_maml_params,
    tiny_train_params,
)

pytestmark = pytest.mark.usefixtures("port_guard")

ATOL = 3e-5
T = "msa_tts_tpu_torch.trainers."
SGD = {"optimizer_type": "SGD", "lr": "1e-2"}


def _cases(root: str, root3: str, out: str) -> dict:
    from msa_tts_tpu_torch.dataloaders.synthetic import synthetic_params

    joint = tiny_train_params(root, out + "/joint", "baseline", n_epochs=2,
                              optim=SGD)
    joint["dataset_train"]["batch_size"] = 4
    reptile = dict(meta_batch_size=2, n_inner_train=2, n_inner_test=1,
                   n_epochs=1, optim_outer={"optimizer_type": "SGD",
                                            "lr": "1.0"})
    voc = synthetic_params(root, n_speakers=2, batch_size=2)
    voc.update(experiment_name="tiny", use_tensorboard=False,
               tb_log_interval=1, print_interval=100,
               ckpt_save_step_interval=1000)
    return {
        "joint": (T + "baseline:JointTrainer", joint),
        "maml": (T + "maml:MAML", tiny_maml_params(
            root, out + "/maml", metatest_epoch_interval=1)),
        "reptile_batched": (T + "reptile:Reptile", tiny_train_params(
            root, out + "/rb", "reptile", reptile_mode="batched",
            **reptile)),
        "reptile_sequential": (T + "reptile:Reptile", tiny_train_params(
            root, out + "/rs", "reptile", reptile_mode="sequential",
            **reptile)),
        "ewc": (T + "continual_ewc:EWCTrainer", tiny_train_params(
            root3, out + "/ewc", "continual_ewc", n_speakers=3,
            speaker_seed=11, num_initial_speakers=0, n_max_epochs=1,
            test_interval=1, early_stopping=False, buffer_sample_size=2,
            buffer_batch_size=2, ewc_importance=1000.0, optim=SGD)),
        "er": (T + "continual_er:ExperienceReplayTrainer",
               tiny_train_params(
                   root3, out + "/er", "continual_er", n_speakers=3,
                   speaker_seed=11, num_initial_speakers=0, n_max_epochs=1,
                   test_interval=1, early_stopping=False,
                   buffer_sample_size=2, buffer_batch_size=2, optim=SGD)),
        "wavernn": (T + "wavernn_train:WaveRNNTrainer", dict(
            voc, method="wavernn", output_path=out + "/wavernn",
            audio_params=dict(TINY_AUDIO), voc_mode="MOL", rnn_dims=32,
            fc_dims=32, compute_dims=16, res_out_dims=16, res_blocks=2,
            pad=2, upsample_factors=(4, 8, 8), seq_len=512, n_steps=3,
            lr=1e-3, train_seed=5)),
        "hifigan": (T + "hifigan_train:HiFiGANTrainer", dict(
            voc, method="hifigan", output_path=out + "/hifigan",
            audio_processor="ap2", audio_params={
                "n_fft": 512, "hop_size": 128, "win_size": 512,
                "n_mels": 10, "sample_rate": 22050, "fmin": 0.0,
                "fmax": 8000.0, "center": False},
            hifigan=dict(HIFIGAN_H), segment_size=1024, n_steps=2,
            lr=2e-4, train_seed=3)),
    }


_PARALLEL = {"maml": {"task": 2}}
TP = {"tp": 2}
# the tp ranks lay the tiny widths out at this smallest split axis (the
# trainers fix 128; torch_parallel_ranks.trainer_cases sets it)
TP_MIN_DIM = 8
# the tp runs and the world-1 run each is held to
_TP_REF = {"joint_tp": "joint", "maml_tp": "maml", "ewc_tp": "ewc"}


def _run(cls: str, params: dict):
    t = R._load_class(cls)(**params)
    t.run()
    return t


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("trainer_parallel"))
    root = tiny_corpus(os.path.join(tmp, "corpus"))
    root3 = tiny_corpus(os.path.join(tmp, "corpus3"), n_speakers=3)
    one = _cases(root, root3, os.path.join(tmp, "w1"))
    two = {name: (cls, dict(p, output_path=p["output_path"].replace(
                                "/w1/", "/w2/"),
                            parallel=_PARALLEL.get(name, {"dp": 2}),
                            device="cpu"))
           for name, (cls, p) in one.items() if name != "ewc"}
    for name, ref in _TP_REF.items():
        cls, p = one[ref]
        two[name] = (cls, dict(p, output_path=p["output_path"].replace(
            "/w1/", f"/w2/{name}_"), parallel=TP, device="cpu"))
    # a world-2 joint run of one epoch, resumed below at world 1; a tp-2
    # one likewise; a world-1 one that the ranks resume at tp 2
    two["joint_half"] = (two["joint"][0],
                         dict(two["joint"][1], n_epochs=1,
                              output_path=os.path.join(tmp, "w2/half")))
    two["joint_tp_half"] = (two["joint"][0],
                            dict(two["joint_tp"][1], n_epochs=1,
                                 output_path=os.path.join(tmp, "w2/tphalf")))
    torch.save({"w1_half": dict(one["joint"][1], n_epochs=1, device="cpu",
                                output_path=os.path.join(tmp, "w1/half")),
                "tp": TP, "tp_min_dim": TP_MIN_DIM},
               os.path.join(tmp, "resume_at_tp.pt"))
    torch.save(two, os.path.join(tmp, "cases.pt"))
    # the ranks run while this process takes the world-1 runs
    wait = spawn(R.trainer_cases, 2, tmp, store=os.path.join(tmp, "store"),
                 join=False)
    ref = {name: _run(cls, dict(p, device="cpu"))
           for name, (cls, p) in one.items()}
    wait()
    res = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
           for r in range(2)]
    resumed = _run(two["joint"][0], dict(
        one["joint"][1], device="cpu", resume=True,
        output_path=two["joint_half"][1]["output_path"]))
    resumed_tp = _run(two["joint"][0], dict(
        one["joint"][1], device="cpu", resume=True,
        output_path=two["joint_tp_half"][1]["output_path"]))
    return dict(tmp=tmp, res=res, ref=ref, resumed=resumed,
                resumed_tp=resumed_tp, two=two)


def _close(got: dict, ref: dict, what: str):
    assert set(got) == set(ref), what
    for k, v in ref.items():
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(v),
                                   atol=ATOL, err_msg=f"{what}: {k}")


@pytest.mark.parametrize("name", ["joint", "maml", "reptile_batched",
                                  "reptile_sequential", "er", "wavernn",
                                  "hifigan", "joint_tp", "maml_tp",
                                  "ewc_tp"])
def test_world2_matches_world1(runs, name):
    (w0, step0), (w1, step1) = runs["res"][0][name], runs["res"][1][name]
    ref = runs["ref"][_TP_REF.get(name, name)]
    assert step0 == step1 == ref.step_global
    for k in w0:
        assert torch.equal(w0[k], w1[k]), k
    _close(w0, R.trained_weights(ref), name)


def test_world2_checkpoint_resumes_at_world1(runs):
    t = runs["resumed"]
    ref = runs["ref"]["joint"]
    assert t.step_global == ref.step_global
    _close(R.trained_weights(t), R.trained_weights(ref), "resumed")


def test_tp_checkpoints_resume_across_tp(runs):
    """A tp-2 run's checkpoint resumed at world 1, and a world-1 run's at
    tp 2, each equal the unbroken world-1 run."""
    ref = R.trained_weights(runs["ref"]["joint"])
    t = runs["resumed_tp"]
    assert t.step_global == runs["ref"]["joint"].step_global
    _close(R.trained_weights(t), ref, "tp 2 -> world 1")
    for r in (0, 1):
        w, step = runs["res"][r]["resumed_at_tp"]
        assert step == runs["ref"]["joint"].step_global
        _close(w, ref, "world 1 -> tp 2")


def test_tp_with_task_raises(tmp_path):
    from msa_tts_tpu_torch.trainers.maml import MAML

    with pytest.raises(NotImplementedError,
                       match="tp composes with dp, not with the task axis"):
        MAML(**tiny_maml_params(str(tmp_path), str(tmp_path / "o"),
                                parallel={"task": 2, "tp": 2}, device="cpu"))


def test_only_rank0_writes(runs):
    assert runs["res"][1]["writes"] == []
    root = os.path.join(runs["tmp"], "w2", "joint")
    names = {f for _, _, fs in os.walk(root) for f in fs}
    assert "auto_resume.ckpt" in names and "params.yml" in names


def test_sigterm_to_one_rank_stops_both(runs):
    s0, s1 = runs["res"][0]["sigterm"], runs["res"][1]["sigterm"]
    assert s0 == s1 == 2 < runs["ref"]["joint"].step_global
