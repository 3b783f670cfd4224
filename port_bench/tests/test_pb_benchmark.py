"""Every cell of BENCHMARK.json resolves to its files, and the file keeps
to the contract's shape."""

import json
import os
import re

import pytest

import harness

B = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("w", B["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(w):
    cfg = harness.load_json(harness.config_file(B, w["config"]))
    t = harness.load_json(harness.HERE, "traffic", f"{w['traffic']}.json")
    assert os.path.exists(os.path.join(harness.HERE, "traffic",
                                       f"{t['kind']}.py"))
    lim = harness.load_json(harness.HERE, "checks", f"{w['name']}.json")
    assert lim["len_diff"] == 0 and lim["requests"] >= 2
    waves = [k for k in lim if k.startswith("wave_")]
    assert waves and all(lim[k] > 0 for k in waves)
    assert t["vocoder"] in cfg["vocoders"]
    assert w["chips"] == 1 and NAME.match(w["name"])
    reported = [m for m in B["per_layer"] + B["end_to_end"]
                if w["name"] in m.get("workloads", [w["name"]])]
    assert {"setup_s"} < {m["name"] for m in reported}
    for m in reported:
        if m in B["per_layer"]:
            assert callable(harness.metric_reader(m["name"]))
            moved = [e for e in B["end_to_end"] if e["name"] == m["moves"]][0]
            assert w["name"] in moved.get("workloads", [w["name"]])


def test_contract_shape():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["paths"] == ["port_bench"] and 1 <= B["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in B[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in B["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    assert any(m["name"] == "setup_s" for m in B["end_to_end"])
    for m in B["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    for c in B["configs"]:
        cfg = json.load(open(os.path.join(harness.ROOT, c["file"])))
        assert set(c["reduced"]) == set(cfg["reduced"])
        assert c["file"].startswith("port_bench/")
    assert len(json.dumps(B)) < 64 * 1024
