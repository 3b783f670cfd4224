"""A configuration brings a vocoder as new files only.  In a copy of the
benchmark, a tiny configuration served with Griffin-Lim (whose part,
reference and work counts are there already), its mix, its checks and
new entries of ``BENCHMARK.json`` are added and nothing else: the cell
runs correct, its control and a reference perturbed past the limit do
not, and no file that was there is changed.  A vocoder with no part
fails at set-up, naming the file it lacks."""

import copy
import json
import os
import shutil
import subprocess
import sys

import pytest

import harness
import tiny
from conftest import PB, ROOT

CELL = "tiny_gl.closed_b4_gl"
# the tiny cell's limit, from its readings on the CPU (float32 Tacotron,
# 24 frames, batches of 4) over seeds 1-12: sound runs 2.1e-4 to 6.4e-3
# (wave_rel_err) and 2.3e-4 to 4.8e-3 (voc_rel_err); the controls 0.18
# (the vocoder's, TF32) to 1.1
LIMIT = 0.03


def gl_files() -> dict:
    """relative path → content of each file the Griffin-Lim cell adds."""
    cfg = tiny.config("t2nv_lsa_r1")
    cfg.update(name="tiny_gl", vocoders={"griffinlim": {}})
    del cfg["random_init"]
    t = dict(tiny.traffic("offline_hifigan_b16"), vocoder="griffinlim")
    return {
        "port_bench/configs/tiny_gl.json": cfg,
        "port_bench/traffic/closed_b4_gl.json": t,
        f"port_bench/checks/{CELL}.json": {
            "requests": 4, "wave_rel_err": LIMIT, "voc_rel_err": LIMIT,
            "len_diff": 0}}


def gl_benchmark(bench: dict) -> dict:
    """``bench`` with the Griffin-Lim cell's entries added."""
    b = copy.deepcopy(bench)
    b["configs"].append({
        "name": "tiny_gl", "source": "https://github.com/NVIDIA/tacotron2",
        "file": "port_bench/configs/tiny_gl.json",
        "reduced": sorted(tiny.config("t2nv_lsa_r1")["reduced"]),
        "why": "a tiny Tacotron 2 served with Griffin-Lim"})
    b["workloads"].append({
        "name": CELL, "config": "tiny_gl", "traffic": "closed_b4_gl",
        "chips": 1, "why": "batches of 4 through Griffin-Lim"})
    b["end_to_end"].append({
        "name": "audio_s_per_s.griffinlim", "unit": "audio_s/s",
        "better": "higher", "bound": 0.25, "source": "host_clock",
        "workloads": [CELL]})
    return b


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    """A copy of the benchmark with the Griffin-Lim cell added, and the
    bytes of every file that was there before."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(PB, root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    before = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                before[os.path.relpath(p, root)] = fh.read()
    for rel, body in gl_files().items():
        assert rel not in before
        with open(root / rel, "w") as f:
            json.dump(body, f, indent=1)
    bench = gl_benchmark(json.loads(before["BENCHMARK.json"]))
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(bench, f, indent=1)
    return root, before


def run_in(root, seed: int, perturb: float = 0.0) -> dict:
    """One tiny run of the cell in the copy, with its controls, in a
    process that imports the copy's harness; ``perturb`` scales the
    reference's waveforms by 1 + perturb."""
    code = (
        "import json, sys, torch\n"
        "torch.set_num_threads(2)\n"
        "import harness\n"
        "from reference import griffinlim as RG\n"
        f"scale = 1.0 + {perturb!r}\n"
        "if scale != 1.0:\n"
        "    inner = RG.invert\n"
        "    RG.invert = lambda *a, **k: inner(*a, **k) * scale\n"
        f"res = harness.run_cell({CELL!r}, {seed}, 1e-3, False, device='cpu',"
        " log=lambda m: None, control=True)\n"
        "print(json.dumps({'correct': res['correct'],"
        " 'compared': res['compared'],"
        " 'controls': res['controls']}))\n")
    env = {**os.environ, "PYTHONDONTWRITEBYTECODE": "1",
           "PYTHONPATH": os.pathsep.join([str(root / "port_bench"), ROOT])}
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_vocoder_comes_in_new_files_only(checkout):
    root, before = checkout
    res = run_in(root, 2 ** 33 + 5)
    c = res["compared"]
    assert res["correct"], c
    assert c["len_diff"]["value"] == 0, c
    ctl = res["controls"]
    assert not any(v["correct"] for v in ctl.values()), ctl
    assert ctl["control_vocoder"]["readings"]["voc_rel_err"] > 2 * LIMIT, ctl
    bad = run_in(root, 2 ** 33 + 5, perturb=3 * LIMIT)
    assert not bad["correct"], bad["compared"]
    for rel, body in before.items():
        with open(root / rel, "rb") as f:
            now = f.read()
        if rel == "BENCHMARK.json":
            old, new = json.loads(body), json.loads(now)
            assert all(new[k][: len(v)] == v if isinstance(v, list)
                       else new[k] == v for k, v in old.items()), rel
        else:
            assert now == body, rel


def test_a_vocoder_with_no_part_fails_at_setup():
    cfg = tiny.config("t2nv_lsa_r1")
    cfg["vocoders"]["waveglow"] = {}
    t = dict(tiny.traffic("offline_hifigan_b16"), vocoder="waveglow")
    with pytest.raises(SystemExit, match=r"port_bench/parts/waveglow\.py"):
        harness.run_cell("t2nv_lsa_r1.offline_hifigan_b16", 1, 1e-3, False,
                         device="cpu", cfg=cfg, traffic=t,
                         limits=dict(tiny.LIMITS["hifigan"]),
                         log=lambda m: None)
