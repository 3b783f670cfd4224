"""The WaveGlow configuration (``configs/t2nv_waveglow.json``), its part,
reference, work counts and readers, on the CPU: its weights load into
the port's module; the work at the published widths; its Tacotron is
``t2nv_lsa_r1``'s; a tiny run is correct and each fault in the flows is
caught; the readers on a synthetic recorder; what it imports."""

import copy
import json
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

import harness
import parts
import pbtrace as T
import tiny
import weights as W
from conftest import HERE, PB, ROOT
from test_pb_faults import SEED, _answer_altered, _half_batch
from test_pb_imports import FORBIDDEN, _modules
from test_pb_weights import digest
from work import waveglow as WW

CELL = "t2nv_waveglow.offline_waveglow_b16"
CFG = harness.load_json(PB, "configs", "t2nv_waveglow.json")
V = CFG["vocoders"]["waveglow"]


def tiny_config(product_dtype: str = "float32") -> dict:
    """``tiny.config("t2nv_lsa_r1")`` (which cuts a HiFi-GAN block that
    this configuration has not) with a tiny WaveGlow in its vocoders: 4
    flows, 2 channels out after flow 2, WN 2 × 16."""
    cfg = tiny.config("t2nv_lsa_r1")
    v = copy.deepcopy(V)
    v.update(n_flows=4, n_early_every=2, product_dtype=product_dtype,
             WN_config={"n_layers": 2, "n_channels": 16, "kernel_size": 3})
    cfg.update(name="t2nv_waveglow", vocoders={"waveglow": v},
               random_init=dict(CFG["random_init"]))
    return cfg


def run(seed: int = SEED, *, product_dtype: str = "float32",
        limits: dict | None = None, **kw) -> dict:
    return harness.run_cell(
        CELL, seed, 1.0, False, device="cpu", cfg=tiny_config(product_dtype),
        traffic=tiny.traffic("offline_waveglow_b16"),
        limits=limits or dict(tiny.LIMITS["hifigan"]), log=lambda m: None,
        **kw)


def test_weight_spec_loads_into_the_port():
    from msa_tts_tpu_torch.vocoders.waveglow import WaveGlow

    part = parts.load(CFG, "waveglow")
    spec = part.weight_spec()
    model = WaveGlow(V["n_mel_channels"], V["n_flows"], V["n_group"],
                     V["n_early_every"], V["n_early_size"], V["WN_config"])
    assert list(spec) == list(model.state_dict())
    sd = W.make(spec, torch.Generator().manual_seed(1), "cpu")
    model.load_state_dict(sd, strict=True)
    assert sum(p.numel() for p in model.parameters()) == WW.weights(V, 80)
    # the invertible convolutions: the channel reversal plus U(±spread)
    a = CFG["random_init"]["waveglow_convinv_spread"]
    for k, (_, r) in enumerate(WW.flows(V)):
        w = sd[f"convinv.{k}.conv.weight"][..., 0]
        rev = torch.eye(r).flip(0)
        assert (w - rev).abs().max() <= a
        assert torch.linalg.cond(w.double()) < 4.0
    gain = CFG["random_init"]["waveglow_end_gain"]
    assert sd["WN.0.end.weight"].abs().max() <= gain / 16


def test_work_at_the_published_widths():
    macs = WW.position_macs(V, 80)
    assert len(macs) == 12
    assert macs[0] == 6_753_344 and all(6.75e6 < m < 6.76e6 for m in macs)
    per_s = WW.ops(V, 80, 22050 / 8)
    assert 447e9 < per_s < 449e9
    # a batch of 16 rows of 1,000 frames: ~83 TFLOP, 84 ms at the bf16
    # peak, far above its least bytes' time
    batch = WW.ops(V, 80, 16 * 32_000)
    assert 83e12 < batch < 83.3e12
    assert WW.least_bytes(V, 80, 16 * 32_000) / 3.35e12 < 1e-3
    assert 87.6e6 < WW.weights(V, 80) < 87.8e6


@pytest.mark.parametrize("seed", [3, 2 ** 40 + 11])
def test_tacotron_is_t2nv_lsa_r1s(seed):
    lsa = tiny.config("t2nv_lsa_r1")
    with torch.no_grad():
        a = W.all_weights(tiny_config(), seed, "cpu")
        b = W.all_weights(lsa, seed, "cpu")
    assert set(a) == {"tacotron", "waveglow"}
    assert digest(a["tacotron"]) == digest(b["tacotron"])


def test_sound_run_is_correct_and_controls_are_not():
    res = run(control=True)
    assert res["correct"], res["compared"]
    ctl = res["controls"]
    assert not any(c["correct"] for c in ctl.values()), ctl
    lim = res["compared"]["voc_rel_err"]["limit"]
    assert ctl["control_vocoder"]["readings"]["voc_rel_err"] > lim, ctl
    assert ctl["control_acoustic"]["readings"]["voc_rel_err"] == 0.0, ctl


def test_bfloat16_run_mirrors_the_reference():
    """At the stated bfloat16 the served vocoder and the reference round
    alike: voc_rel_err ~1e-4 on the CPU, the float8 control ~1e-2."""
    lim = {"requests": 8, "wave_rel_err": 3e-3, "voc_rel_err": 1e-3,
           "len_diff": 0}
    res = run(SEED + 1, product_dtype="bfloat16", limits=lim, control=True)
    assert res["correct"], res["compared"]
    voc = res["controls"]["control_vocoder"]["readings"]["voc_rel_err"]
    assert voc > 10 * res["compared"]["voc_rel_err"]["value"]
    assert voc > lim["voc_rel_err"]


def _drop_a_layer(monkeypatch):
    """The served WN runs without its first layer."""
    from msa_tts_tpu_torch.vocoders import waveglow as WG

    inner = WG.WaveGlowVocoder._set

    def dropped(self, *a, **kw):
        inner(self, *a, **kw)
        for f in self.flows:
            for lst in (f.cond_w, f.cond_b, f.in_w, f.rs_w, f.rs_b):
                lst.pop(0)

    monkeypatch.setattr(WG.WaveGlowVocoder, "_set", dropped)


def _no_exp(monkeypatch):
    """The coupling subtracts b but skips its exp(−s)."""
    from msa_tts_tpu_torch.vocoders import waveglow as WG

    def reverse(self, k, audio, spect, pad=None):
        f = self.flows[k]
        h = audio.shape[-1] // 2
        a0, a1 = audio[..., :h], audio[..., h:]
        e = self.wn(f, a0, spect, pad)
        return torch.cat([a0, a1 - e[..., :h]], -1) @ f.w_inv.T

    monkeypatch.setattr(WG.WaveGlowVocoder, "reverse_flow", reverse)


@pytest.mark.parametrize("fault", [_drop_a_layer, _no_exp, _half_batch,
                                   _answer_altered],
                         ids=lambda f: f.__name__.strip("_"))
def test_fault_is_caught(fault, monkeypatch):
    fault(monkeypatch)
    res = run()
    assert not res["correct"], res["compared"]


class Stamps(SimpleNamespace):
    pass


def _run(stamps, window_ns=10 ** 9):
    rec = SimpleNamespace(stamps=lambda kind: [s for s in stamps
                                               if s.kind == kind])
    return SimpleNamespace(
        cfg=CFG, trace=T.Trace(0, window_ns, [], []),
        gen=SimpleNamespace(ctx=SimpleNamespace(
            tts=SimpleNamespace(recorder=rec))))


def test_readers_on_a_synthetic_recorder():
    """Two calls in the window of 16 rows × 32,000 positions, 400 ms and
    600 ms stamped; one after it; a K1 stamp in between."""
    P = 16 * 32_000
    st = [Stamps(kind="waveglow", t_ns=2, us={"total": 4e5},
                 info={"rows": 16, "positions": P}),
          Stamps(kind="k1", t_ns=3, us={"total": 9e9}, info=None),
          Stamps(kind="waveglow", t_ns=5, us={"total": 6e5},
                 info={"rows": 16, "positions": P}),
          Stamps(kind="waveglow", t_ns=3 * 10 ** 9, us={"total": 1e9},
                 info={"rows": 16, "positions": P})]
    r = _run(st, window_ns=2 * 10 ** 9)
    share = harness.metric_reader("waveglow_share_pct.offline")(r)
    assert share == pytest.approx(50.0)
    roof = harness.metric_reader("waveglow_roofline_pct.offline")(r)
    assert roof == pytest.approx(100 * 2 * WW.ops(V, 80, P) / 989e12)
    for name in ("waveglow_share_pct.offline",
                 "waveglow_roofline_pct.offline"):
        assert harness.metric_reader(name)(_run([])) is None
        silent = _run([])
        silent.gen.ctx.tts = SimpleNamespace()
        assert harness.metric_reader(name)(silent) is None


def test_reference_and_setup_load_nothing_forbidden():
    mods = _modules(
        "import sys, json, check, inputs, weights\n"
        "from reference import waveglow\n"
        "from parts import waveglow as p\n"
        "from work import waveglow as w\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not mods & (FORBIDDEN | {"msa_tts_tpu_torch"})
    mods = _modules(
        "import sys, json, torch, system, inputs\n"
        "import test_pb_waveglow as t\n"
        "import weights as W\n"
        "cfg = t.tiny_config()\n"
        "s = system.System(cfg, W.all_weights(cfg, 1, 'cpu'), 'cpu')\n"
        "s.tts.synthesize_batch(['a cat'], vocoder='waveglow',"
        " spk_emb=inputs.speaker_vector(cfg, 1))\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert "msa_tts_tpu_torch" in mods
    assert not mods & FORBIDDEN


def test_a_port_without_waveglow_fails_at_setup(tmp_path):
    """As the parent commit does: the part names the module it lacks."""
    code = (
        "import sys\n"
        "sys.modules['msa_tts_tpu_torch.vocoders.waveglow'] = None\n"
        "import torch, test_pb_waveglow as t, system, weights as W\n"
        "cfg = t.tiny_config()\n"
        "system.System(cfg, W.all_weights(cfg, 1, 'cpu'), 'cpu')\n")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=ROOT, timeout=600,
        env={"PYTHONPATH": ":".join([HERE, PB, ROOT]), "PATH": "/usr/bin"})
    assert out.returncode != 0
    assert "msa_tts_tpu_torch/vocoders/waveglow.py" in out.stderr, (
        out.stderr[-2000:])
    assert "port_bench/parts/waveglow.py" in out.stderr


def test_a_vocoder_with_no_part_still_fails_at_setup():
    """``test_pb_parts.py`` names WaveGlow as its vocoder without a part,
    which it no longer is; the same with one that has none."""
    cfg = tiny.config("t2nv_lsa_r1")
    cfg["vocoders"]["melgan"] = {}
    t = dict(tiny.traffic("offline_hifigan_b16"), vocoder="melgan")
    with pytest.raises(SystemExit, match=r"port_bench/parts/melgan\.py"):
        harness.run_cell("t2nv_lsa_r1.offline_hifigan_b16", 1, 1e-3, False,
                         device="cpu", cfg=cfg, traffic=t,
                         limits=dict(tiny.LIMITS["hifigan"]),
                         log=lambda m: None)


def test_benchmark_entries():
    b = harness.benchmark()
    c = harness.cell(b, CELL)
    assert c["config"] == "t2nv_waveglow" and c["chips"] == 1
    assert json.load(open(harness.config_file(b, "t2nv_waveglow"))) == CFG
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert CELL in e2e["audio_s_per_s"]["workloads"]
    mine = [m for m in b["per_layer"] if CELL in m["workloads"]]
    assert {m["name"] for m in mine} == {"waveglow_roofline_pct.offline",
                                         "waveglow_share_pct.offline"}
    assert all(m["moves"] == "audio_s_per_s" and m["layer"] == "WaveGlow"
               for m in mine)
