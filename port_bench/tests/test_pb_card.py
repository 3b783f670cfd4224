"""On the card: one short run of each cell through the command that the
benchmark names, its last line the contract's JSON object, correct."""

import json
import os
import subprocess
import sys

import pytest

import harness

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell, card):
    out = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 5), "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, cwd=harness.ROOT, timeout=1200,
        env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["failed"] == 0, res
    assert res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "compared"
