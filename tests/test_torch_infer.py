"""The port's inference CLI (``msa_tts_tpu_torch/infer.py``) against the JAX
package's (``msa_tts_tpu/infer.py``) on one tiny experiment: a
``checkpoint_0.ckpt`` written by the JAX package's own checkpoint writer
from seeded ``init_tacotron2nv`` weights, which both packages read, on the
synthetic corpus, two speakers of 2 shots, 2 inner SGD steps, Griffin-Lim,
the loss landscapes on (3 x 3 points over a distance of 1, as the JAX
package's own landscape test shrinks them).

The JAX package draws its noise from keys; the port takes the same draws
injected: the adaptation's dropout masks (``fold_in(PRNGKey(adapt_seed),
itr_b)``), the prenet masks (``fold_in(PRNGKey(infer_seed), 2)``), the
landscapes' loss masks (``PRNGKey(1)``) and directions (``split(
PRNGKey(0))`` through ``tree_rand_like``).

The gate's stop step flips where ``sigmoid(gate)`` is near the
threshold, so the checkpoint's gate bias is -30 and the test checks the
margin: ``sigmoid(gate)`` stays below 1e-6 at every step of the port's
decodes (read from its decoder's gate outputs), far from the threshold
0.5, so every decode runs its 17 steps on both sides and the lengths are
compared exactly.

Tolerances, float32 on both sides summed in other orders:
``test_torch_adapt.py``'s for the adapted weights and batch-norm
statistics after 2 steps (9e-7) and the query loss (1.2e-6 relative);
the plain decoder's (``test_torch_model.py``, 5e-5) for the mels and
alignments; the landscape surfaces and interpolation curves 2e-6
relative (read 3.4e-7; the mels read 4.8e-7, the adapted weights
2.4e-7).
"""

import glob
import os
import sys

import jax
import numpy as np
import pytest
import torch

from msa_tts_tpu import infer as JI
from msa_tts_tpu.analysis.landscapes import tree_rand_like
from msa_tts_tpu.models import config_from_params as jax_cfp
from msa_tts_tpu.models import init_tacotron2nv
from msa_tts_tpu.models.pallas_decoder import _prenet_masks
from msa_tts_tpu.utils import checkpoint as JC
from msa_tts_tpu_torch import infer as TI
from msa_tts_tpu_torch.models import tacotron2nv as TT
from msa_tts_tpu_torch.utils.convert import state_dict_from_jax
from msa_tts_tpu_torch.utils.g2p import N_SYMBOLS
from torch_parity import (
    jax_forward_masks,
    jax_metatest_masks,
    one_torch_thread,  # noqa: F401  (an autouse fixture)
    tiny_corpus,
    tiny_maml_params,
    torch_masks,
)

ADAPT_ATOL, QLOSS_RTOL = 9e-7, 1.2e-6
MEL_ATOL = 5e-5
SURFACE_RTOL = 2e-6
LANDSCAPE = dict(distance=1.0, steps=3)
ADAPT_SEED, INFER_SEED = 4, 2
GATE_BIAS, GATE_MARGIN = -30.0, 1e-6


def _model(params: dict) -> dict:
    """The model section as both CLIs complete it."""
    mp = dict(params["model"], n_symbols=N_SYMBOLS, num_speakers=1,
              n_mel_channels=params["audio_params"]["n_mels"])
    for k in ("freeze_charemb", "freeze_encoder", "freeze_decoder"):
        mp[k] = params.get(k, False)
    return mp


def write_jax_checkpoint(params: dict, name: str, seed: int = 0,
                         gate_bias: float = GATE_BIAS,
                         gate_scale: float = 1.0):
    """``<output>/checkpoints/<name>.ckpt`` from seeded JAX weights, the
    gate layer's weight scaled by ``gate_scale`` and its bias set to
    ``gate_bias``, written by the JAX package's checkpoint writer;
    returns the JAX config."""
    jcfg = jax_cfp(_model(params))
    p, s = jax.device_get(init_tacotron2nv(jax.random.PRNGKey(seed), jcfg))
    gate = p["decoder"]["gate_layer"]
    gate["weight"] = np.asarray(gate["weight"]) * np.float32(gate_scale)
    gate["bias"] = np.full_like(gate["bias"], gate_bias)
    d = os.path.join(params["output_path"], params["method"],
                     params["experiment_name"], "checkpoints")
    os.makedirs(d, exist_ok=True)
    JC.save_checkpoint(os.path.join(d, f"{name}.ckpt"),
                       {"params": p, "model_state": s})
    return jcfg


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return tiny_corpus(str(tmp_path_factory.mktemp("infer_corpus")))


def _params(corpus, out, **over):
    p = tiny_maml_params(corpus, str(out), n_inner_test=2, batch_size=2)
    p.update(checkpoint_id=0, speaker="spk00,spk01",
             input_text="hello there", vocoder="griffinlim",
             spk_emb_path=os.path.join(corpus, "spk_emb.pkl"),
             adapt_seed=ADAPT_SEED, infer_seed=INFER_SEED,
             plot_loss_landscapes=True, device="cpu")
    p.update(over)
    return p


class _Seen:
    """What one side's run computed, captured at its functions."""

    def __init__(self):
        self.adapt, self.mels, self.planes, self.lines = [], [], [], []
        self.gates = []


def _jax_run(params):
    seen = _Seen()
    inf = JI.Inference(**params)
    meta = inf._metatest

    def metatest(*a):
        out = meta(*a)
        seen.adapt.append(jax.device_get(out))
        return out

    gen = inf.generate_melspec

    def generate(*a):
        out = gen(*a)
        seen.mels.append(out)
        return out

    inf._metatest, inf.generate_melspec = metatest, generate
    plane, line = JI.random_plane, JI.linear_interpolation

    def random_plane(f, p, **kw):
        seen.planes.append(plane(f, p, **dict(kw, **LANDSCAPE)))
        return seen.planes[-1]

    def linear_interpolation(*a):
        seen.lines.append(line(*a))
        return seen.lines[-1]

    JI.random_plane, JI.linear_interpolation = random_plane, \
        linear_interpolation
    try:
        inf.make_inference()
    finally:
        JI.random_plane, JI.linear_interpolation = plane, line
    return inf, seen


class FromJax(TI.Inference):
    """The port's CLI drawing the JAX package's noise."""

    jcfg = None

    def _adapt_masks(self, itr_b, batch):
        B, T_in = batch["inputs"].shape
        key = jax.random.fold_in(jax.random.PRNGKey(ADAPT_SEED), itr_b)
        return torch_masks(jax_metatest_masks(
            key, self.jcfg, self.params["n_inner_test"], B, T_in,
            batch["melspecs"].shape[-1]))

    def _prenet_masks(self, B):
        dcfg = self.jcfg.decoder_config()
        key = jax.random.fold_in(jax.random.PRNGKey(INFER_SEED), 2)
        return torch.as_tensor(np.array(_prenet_masks(
            dcfg, key, dcfg.max_decoder_steps, B)))

    def _landscape_masks(self, batch):
        B, T_in = batch["inputs"].shape
        return torch_masks(jax_forward_masks(
            jax.random.PRNGKey(1), self.jcfg, B, T_in,
            batch["melspecs"].shape[-1]))


def _port_run(params, jcfg, jax_params_template, jax_state):
    seen = _Seen()
    FromJax.jcfg = jcfg
    inf = FromJax(**params)
    meta = inf._metatest

    def metatest(*a):
        out = meta(*a)
        seen.adapt.append(out)
        return out

    gen = inf.generate_melspec

    def generate(*a):
        out = gen(*a)
        seen.mels.append(out)
        return out

    inf._metatest, inf.generate_melspec = metatest, generate
    plane, line = TI.random_plane, TI.linear_interpolation

    def random_plane(f, p, **kw):
        # JAX's random_plane draws split(PRNGKey(0)) through
        # tree_rand_like on its params tree; the same draws, renamed
        k1, k2 = jax.random.split(jax.random.PRNGKey(0))
        dirs = tuple(
            {k: v for k, v in state_dict_from_jax(
                jax.device_get(tree_rand_like(k, jax_params_template)),
                jax_state, inf.cfg).items() if k in p}
            for k in (k1, k2))
        seen.planes.append(plane(f, p, directions=dirs,
                                 **dict(kw, **LANDSCAPE)))
        return seen.planes[-1]

    def linear_interpolation(*a):
        seen.lines.append(line(*a))
        return seen.lines[-1]

    dec = TT.decoder_infer

    def decoder_infer(*a, **k):
        out = dec(*a, **k)
        seen.gates.append(out[1])
        return out

    TI.random_plane, TI.linear_interpolation = random_plane, \
        linear_interpolation
    TT.decoder_infer = decoder_infer
    try:
        inf.make_inference()
    finally:
        TI.random_plane, TI.linear_interpolation = plane, line
        TT.decoder_infer = dec
    return inf, seen


@pytest.fixture(scope="module")
def runs(corpus, tmp_path_factory):
    """The JAX CLI and the port's on the same checkpoint file."""
    base = tmp_path_factory.mktemp("infer_runs")
    jp = _params(corpus, base / "jax")
    tp = _params(corpus, base / "port")
    jcfg = write_jax_checkpoint(jp, "checkpoint_0")
    write_jax_checkpoint(tp, "checkpoint_0")
    p0, s0 = init_tacotron2nv(jax.random.PRNGKey(0), jcfg)
    jax_inf, jax_seen = _jax_run(dict(jp))
    port_inf, port_seen = _port_run(dict(tp), jcfg, p0,
                                    jax.device_get(s0))
    return (jax_inf, jax_seen), (port_inf, port_seen)


def test_adapted_weights_match_jax(runs):
    """Both speakers' adapted weights and batch-norm statistics, their
    query losses and inner losses."""
    (jinf, js), (tinf, ts) = runs
    assert len(js.adapt) == len(ts.adapt) == 2
    for (jq, jad, jms, jil), (tq, tad, tms, til) in zip(js.adapt, ts.adapt):
        ref = state_dict_from_jax(jad, jms, tinf.cfg)
        moved = 0.0
        for k, v in {**tad, **tms}.items():
            if v.is_floating_point():
                np.testing.assert_allclose(v.detach().numpy(),
                                           ref[k].numpy(), atol=ADAPT_ATOL,
                                           rtol=0, err_msg=k)
            if k in tinf.model_params:
                moved = max(moved, float(
                    (v.detach() - tinf.model_params[k]).abs().max()))
        assert moved > 1e-4          # the inner steps did move the weights
        assert float(tq) == pytest.approx(float(jq), rel=QLOSS_RTOL)
        np.testing.assert_allclose(til.detach().numpy(), np.asarray(jil),
                                   rtol=QLOSS_RTOL)


def test_each_speakers_mel_matches_jax(runs):
    """Each speaker's mel and alignments from the adapted weights, the
    lengths exactly (every decode its 17 steps, the gate far below its
    threshold)."""
    (jinf, js), (tinf, ts) = runs
    assert len(js.mels) == len(ts.mels) == len(ts.gates) == 2
    # the margin from the gate threshold that makes the stop step safe
    # to compare
    assert max(float(torch.sigmoid(g).max()) for g in ts.gates) < GATE_MARGIN
    for (jm, ja), (tm, ta) in zip(js.mels, ts.mels):
        assert tm.shape == jm.shape == (10, 34)
        assert ta.shape == ja.shape
        np.testing.assert_allclose(tm, jm, atol=MEL_ATOL, rtol=0)
        np.testing.assert_allclose(ta, ja, atol=MEL_ATOL, rtol=0)
    # the two speakers' voices differ
    assert np.abs(ts.mels[0][0] - ts.mels[1][0]).max() > 1e-3


def test_landscapes_match_jax(runs):
    """Each speaker's loss surface on the same directions, and the two
    interpolation curves, on the same fixed masks."""
    (_, js), (_, ts) = runs
    assert len(js.planes) == len(ts.planes) == 2
    for a, b in zip(ts.planes, js.planes):
        assert a.shape == b.shape == (3, 3)
        assert np.isfinite(a).all() and np.ptp(a) > 0
        np.testing.assert_allclose(a, b, rtol=SURFACE_RTOL)
    assert len(js.lines) == len(ts.lines) == 2
    for a, b in zip(ts.lines, js.lines):
        assert a.shape == b.shape == (32,)
        np.testing.assert_allclose(a, b, rtol=SURFACE_RTOL)


def test_files_written_under_the_same_names(runs):
    """The wav, npy and png files, named as the JAX CLI names them."""
    (jinf, _), (tinf, _) = runs

    def names(inf):
        return sorted(os.path.basename(f) for f in glob.glob(
            os.path.join(inf.path_manager.inference_path, "*")))

    assert names(tinf) == names(jinf)
    assert {n.rsplit(".", 1)[1] for n in names(tinf)} == {"wav", "npy",
                                                          "png"}
    assert len(names(tinf)) == 2 * 4 + 2 + 1
    for spk in ("spk00", "spk01"):
        mel = np.load(glob.glob(os.path.join(
            tinf.path_manager.inference_path, f"{spk}_*.npy"))[0])
        assert mel.shape == (10, 34)
    assert sorted(t["speaker"] for t in tinf.timings) == ["spk00", "spk01"]
    assert all(t["adapt_s"] > 0 and t["decode_s"] > 0 and t["vocode_s"] > 0
               for t in tinf.timings)


def test_main_runs_from_params_yml(corpus, tmp_path, monkeypatch):
    """``main`` from ``--params_path`` with ``--key value`` overrides, on
    the CPU asked for by ``--device cpu``; without it the default is the
    GPU, which raises here."""
    from msa_tts_tpu_torch.config import save_params

    p = _params(corpus, tmp_path / "out", plot_loss_landscapes=False)
    for k in ("device", "speaker", "checkpoint_id", "n_inner_test"):
        p.pop(k)
    write_jax_checkpoint(p, "checkpoint_7")
    save_params(p, str(tmp_path / "params.yml"))
    argv = ["prog", "--params_path", str(tmp_path), "--checkpoint_id", "7",
            "--speaker", "spk01", "--n_inner_test", "1"]
    monkeypatch.setattr(sys, "argv", argv + ["--device", "cpu"])
    inf = TI.main(TI.get_cmd_params())
    assert inf.params["n_inner_test"] == 1
    assert [t["speaker"] for t in inf.timings] == ["spk01"]
    assert glob.glob(os.path.join(inf.path_manager.inference_path,
                                  "spk01_hello_ther_ckpt7.wav"))
    if not torch.cuda.is_available():
        monkeypatch.setattr(sys, "argv", argv)
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            TI.main(TI.get_cmd_params())


def test_cli_values_yaml_coerced(monkeypatch):
    """``--key value`` parses as the JAX CLI's does
    (``tests/test_infer.py::test_cli_values_yaml_coerced``), both CLIs."""
    from msa_tts_tpu.infer_cumulative import get_cmd_params as jax_gc2
    from msa_tts_tpu_torch import infer_cumulative as TIC

    argv = ["prog", "--infer_seed", "1", "--speaker_seed", "0",
            "--plot_loss_landscapes", "false", "--n_inner_test", "5",
            "--speaker", "A,B", "--input_text", "hello there",
            "--lr", "1e-3", "--device", "cpu", "--note", "null"]
    monkeypatch.setattr(sys, "argv", argv)
    out, ref = TI.get_cmd_params(), JI.get_cmd_params()
    assert out == ref
    assert {k: type(v) for k, v in out.items()} == {
        k: type(v) for k, v in ref.items()}
    assert out["infer_seed"] == 1 and out["plot_loss_landscapes"] is False
    assert out["lr"] == pytest.approx(1e-3) and out["speaker"] == "A,B"
    assert out["note"] is None
    monkeypatch.setattr(sys, "argv", ["prog", "--speaker_seed", "3"])
    assert TIC.get_cmd_params() == jax_gc2() == {"speaker_seed": 3}
    monkeypatch.setattr(sys, "argv", ["prog", "--speaker"])
    with pytest.raises(ValueError, match="pairs"):
        TI.get_cmd_params()
