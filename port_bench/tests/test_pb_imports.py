"""A cell's set-up at CPU size loads no JAX module and nothing of the JAX
package (top-level names compared whole); the reference loads nothing of
the port."""

import json
import os
import subprocess
import sys

from conftest import HERE, PB, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "msa_tts_tpu"}


def _modules(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=ROOT, timeout=600,
        env={**os.environ, "PYTHONPATH": os.pathsep.join([HERE, PB, ROOT])})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_cell_setup_loads_no_jax():
    mods = _modules(
        "import sys, json, torch, harness, tiny, system, inputs\n"
        "import weights as W\n"
        "cfg = tiny.config('msa_t2nv_fa_r2')\n"
        "s = system.System(cfg, W.all_weights(cfg, 1, 'cpu'), 'cpu')\n"
        "s.tts.synthesize_batch(['a cat'], vocoder='hifigan',"
        " spk_emb=inputs.speaker_vector(cfg, 1))\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert "msa_tts_tpu_torch" in mods
    assert not mods & FORBIDDEN


def test_reference_loads_nothing_of_the_port():
    mods = _modules(
        "import sys, json, check, inputs, weights\n"
        "from reference import g2p, hifigan, precision, tacotron2, wavernn\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not mods & (FORBIDDEN | {"msa_tts_tpu_torch"})
