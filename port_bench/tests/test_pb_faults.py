"""The check catches a broken timed path: a whole run at tiny size on
the CPU (the harness's look for a card skipped), once sound and once for
each fault a serving cell can have, with the served system broken
underneath.  The exchange between chips has no fault here: every cell
runs on one chip."""

import numpy as np
import pytest

import tiny

SEED = 2 ** 34 + 77
CELLS = ["t2nv_lsa_r1.offline_hifigan_b16", "t2nv_lsa_r1.single_hifigan",
         "msa_t2nv_fa_r2.poisson_hifigan"]


def _state_unchanged(monkeypatch):
    """Every decoder step starts from the state the loop started with."""
    from msa_tts_tpu_torch.models import decoder as D

    step = D._infer_step

    def frozen(*a, **kw):
        new_s, out = step(*a, **kw)
        s = a[-2] if len(a) >= 8 else kw["s"]
        return {**s, "mel_lengths": new_s["mel_lengths"],
                "not_finished": new_s["not_finished"]}, out

    monkeypatch.setattr(D, "_infer_step", frozen)


def _half_batch(monkeypatch):
    """Only the first half of a batch is synthesized; the rest get the
    mean of its waveforms."""
    from msa_tts_tpu_torch.serving import AdaptiveTTS

    inner = AdaptiveTTS.synthesize_batch

    def half(self, texts, *a, **kw):
        if len(texts) < 2:
            return inner(self, texts, *a, **kw)
        k = len(texts) // 2
        kw = dict(kw)
        if kw.get("pre_masks") is not None:
            kw["pre_masks"] = kw["pre_masks"][:, :, :k].contiguous()
        if kw.get("voc_noise") is not None:
            kw["voc_noise"] = kw["voc_noise"][:k]
        if kw.get("pad_batch_to"):
            kw["pad_batch_to"] = k
        wavs = inner(self, texts[:k], *a, **kw)
        mean = np.mean(np.stack(wavs), axis=0)
        return list(wavs) + [mean] * (len(texts) - k)

    monkeypatch.setattr(AdaptiveTTS, "synthesize_batch", half)


def _answer_altered(monkeypatch):
    """The vocoder's waveform has a tenth of its samples zeroed where it
    is produced."""
    from msa_tts_tpu_torch.serving import AdaptiveTTS

    inner = AdaptiveTTS._vocode

    def altered(self, *a, **kw):
        out = []
        for w in inner(self, *a, **kw):
            w = np.array(w, copy=True)
            w[len(w) // 2: len(w) // 2 + len(w) // 10] = 0
            out.append(w)
        return out

    monkeypatch.setattr(AdaptiveTTS, "_vocode", altered)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = tiny.run(cell, SEED)
    assert res["correct"], res["compared"]
    assert res["compared"]["len_diff"]["value"] == 0


# a batch of one has no half to leave out
CASES = [(c, f) for c in CELLS
         for f in (_state_unchanged, _half_batch, _answer_altered)
         if not (f is _half_batch and "single" in c)]


@pytest.mark.parametrize("cell,fault", CASES,
                         ids=[f"{c}-{f.__name__.strip('_')}" for c, f in CASES])
def test_fault_is_caught(cell, fault, monkeypatch):
    fault(monkeypatch)
    res = tiny.run(cell, SEED)
    assert not res["correct"], res["compared"]


def test_wavernn_cell_sound_and_altered(monkeypatch):
    cell = "msa_t2nv_fa_r2.offline_wavernn_b16"
    res = tiny.run(cell, SEED, seconds=0.1)
    assert res["correct"], res["compared"]
    _answer_altered(monkeypatch)
    res = tiny.run(cell, SEED, seconds=0.1)
    assert not res["correct"], res["compared"]


def _logits_altered(monkeypatch):
    """The WaveRNN sample loop's mixture logits shifted where the served
    vocoder computes them (fc3's first ten biases)."""
    import torch
    from msa_tts_tpu_torch.vocoders import wavernn as WV

    inner = WV.cast_generation_params

    def altered(model, dtype):
        p = inner(model, dtype)
        b = p["fc3"]["bias"].clone()
        b[:10] += torch.linspace(0.0, 4.0, 10, device=b.device)
        p["fc3"] = dict(p["fc3"], bias=b)
        return p

    monkeypatch.setattr(WV, "cast_generation_params", altered)


def test_wavernn_logits_fault_is_caught(monkeypatch):
    """The unpinned requests, followed step by step, catch a fault in
    the mixture logits that the pinned ones' waveforms cannot see."""
    cell = "msa_t2nv_fa_r2.offline_wavernn_b16"
    lim = dict(tiny.LIMITS["wavernn"], followed_requests=2,
               wavernn_step_miss=1e-3)
    over = {"pinned_share": 0.5}
    res = tiny.run(cell, SEED, seconds=0.1, limits=lim, traffic_over=over)
    c = res["compared"]
    assert res["correct"], c
    assert c["wavernn_step_miss"]["value"] == 0.0, c
    _logits_altered(monkeypatch)
    res = tiny.run(cell, SEED, seconds=0.1, limits=lim, traffic_over=over)
    c = res["compared"]
    assert not res["correct"], c
    assert c["wavernn_step_miss"]["value"] > 0.05, c
    assert c["wave_rel_err"]["value"] <= c["wave_rel_err"]["limit"], c


@pytest.mark.parametrize("cell", CELLS + ["msa_t2nv_fa_r2.offline_wavernn_b16"])
def test_control_fails(cell):
    """Each control (the reference one precision step lower in the served
    system's place: the whole model, the acoustic model alone, the
    vocoder alone) comes out not correct by the rule of ``correct``, and
    the vocoder alone fails the vocoder's own number."""
    res = tiny.run(cell, SEED + 1, seconds=0.1 if "wavernn" in cell else 1.0,
                   control=True)
    assert res["correct"], res["compared"]
    ctl = res["controls"]
    assert set(ctl) == {"control", "control_acoustic", "control_vocoder"}
    assert not any(c["correct"] for c in ctl.values()), ctl
    lim = res["compared"]["voc_rel_err"]["limit"]
    assert ctl["control_vocoder"]["readings"]["voc_rel_err"] > lim, ctl
    assert ctl["control_acoustic"]["readings"]["voc_rel_err"] == 0.0, ctl
    assert (ctl["control_acoustic"]["readings"]["wave_rel_err"]
            > res["compared"]["wave_rel_err"]["limit"]), ctl


def test_rounding_units_separate_sound_control_and_fault(monkeypatch):
    """``wave_err_per_rounding`` on a tiny bfloat16 run, the acoustic
    model's rounding its unit: the sound run reads 1.3-2.1 units on the
    CPU, the control (float8) 9.7-17; a zeroed tenth of the waveform
    reads far above both."""
    cell = "t2nv_lsa_r1.offline_hifigan_b16"
    lim = {"requests": 8, "wave_err_per_rounding": 5.0, "len_diff": 0}
    res = tiny.run(cell, SEED + 1, infer_dtype="bfloat16", limits=lim,
                   control=True)
    c = res["compared"]
    assert res["correct"], c
    assert (res["controls"]["control"]["readings"]["wave_err_per_rounding"]
            > 5.0), res["controls"]
    _answer_altered(monkeypatch)
    res = tiny.run(cell, SEED + 1, infer_dtype="bfloat16", limits=lim)
    assert not res["correct"], res["compared"]
