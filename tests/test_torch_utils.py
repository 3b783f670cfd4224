"""The port's small utilities against the JAX package's: the padding
helpers of ``ops/masking.py``, the profiling hooks of
``utils/profiling.py`` (``torch.profiler`` in place of ``jax.profiler``;
its span recorder is held in ``test_torch_profiling.py``),
``utils/limit_threads.py``, the inference plots of ``utils/plot.py`` and
the one Tacotron checkpoint loader ``utils/checkpoint.py::
load_model_checkpoint``."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from msa_tts_tpu.ops import masking as JM
from msa_tts_tpu_torch.ops import masking as TM
from msa_tts_tpu_torch.utils import profiling as TP

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("shape,axis,arg", [
    ((3, 5), -1, 4), ((3, 5), 0, 2), ((7,), 0, 7), ((2, 3, 4), 1, 16)])
def test_padding_matches_jax(shape, axis, arg):
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape) + 1
    out = TM.pad_to_multiple(x, arg, axis=axis, value=-1.0)
    ref = JM.pad_to_multiple(x, arg, axis=axis, value=-1.0)
    np.testing.assert_array_equal(out, ref)
    assert out.shape[axis] % arg == 0
    target = x.shape[axis] + 3
    np.testing.assert_array_equal(TM.pad_axis_to(x, target, axis),
                                  JM.pad_axis_to(x, target, axis))
    assert TM.pad_axis_to(x, x.shape[axis], axis) is x
    with pytest.raises(ValueError, match="exceeds"):
        TM.pad_axis_to(x, x.shape[axis] - 1, axis)


def test_profiling_hooks(tmp_path):
    """``trace`` writes a trace into its directory with an ``annotate``d
    region in it."""
    with TP.trace(str(tmp_path / "t"), device="cpu") as prof:
        with TP.annotate("the_region"):
            torch.ones(8).add_(1)
    assert os.listdir(tmp_path / "t")
    assert any(e.key == "the_region" for e in prof.key_averages())


def test_limit_threads_sets_what_is_unset():
    code = ("import os; os.environ.pop('OMP_NUM_THREADS', None); "
            "os.environ['MKL_NUM_THREADS'] = '2'; "
            "import msa_tts_tpu_torch.utils.limit_threads; "
            "print(os.environ['OMP_NUM_THREADS'], "
            "os.environ['MKL_NUM_THREADS'])")
    env = dict(os.environ, MSA_NUM_THREADS="3", PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.stdout.split() == ["3", "2"], out.stderr[-2000:]


def test_inference_plots_written(tmp_path):
    pytest.importorskip("matplotlib")
    from msa_tts_tpu_torch.utils.plot import plot_attention, plot_spectrogram

    plot_attention(np.random.default_rng(0).random((6, 4)),
                   str(tmp_path / "a"))
    plot_spectrogram(np.zeros((10, 8)), str(tmp_path / "m.png"))
    assert sorted(os.listdir(tmp_path)) == ["a.png", "m.png"]


def test_load_model_checkpoint(tmp_path):
    """``<stem>.ckpt`` first, else ``<stem>.pt``; a name may carry either
    suffix (the continual CLI's); neither raises with both names."""
    from msa_tts_tpu.models import config_from_params as jax_cfp
    from msa_tts_tpu.models import init_tacotron2nv
    from msa_tts_tpu.utils import checkpoint as JC
    from msa_tts_tpu_torch.models.tacotron2nv import config_from_params
    from msa_tts_tpu_torch.utils.checkpoint import load_model_checkpoint
    from msa_tts_tpu_torch.utils.convert import state_dict_from_jax
    from torch_parity import model_dict

    mp = model_dict()
    jcfg, cfg = jax_cfp(dict(mp)), config_from_params(dict(mp))
    p, s = jax.device_get(init_tacotron2nv(jax.random.PRNGKey(1), jcfg))
    JC.save_checkpoint(str(tmp_path / "a.ckpt"),
                       {"params": p, "model_state": s})
    ref = state_dict_from_jax(p, s, cfg)
    pt = {k: v + 1.0 if v.is_floating_point() else v for k, v in ref.items()}
    torch.save(pt, str(tmp_path / "a.pt"))
    torch.save(pt, str(tmp_path / "b.pt"))
    for name, want, path in (("a", ref, "a.ckpt"), ("a.ckpt", ref, "a.ckpt"),
                             ("a.pt", pt, "a.pt"), ("b", pt, "b.pt")):
        sd, got = load_model_checkpoint(str(tmp_path / name), cfg)
        assert got == str(tmp_path / path)
        assert sd.keys() == want.keys()
        assert all(torch.equal(sd[k], want[k]) for k in want)
    with pytest.raises(FileNotFoundError, match=r"c\.ckpt or .*c\.pt"):
        load_model_checkpoint(str(tmp_path / "c"), cfg)
