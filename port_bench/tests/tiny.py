"""Tiny configurations and mixes for the CPU tests: the benchmark's
configurations with every size cut, so that a whole run (system, window,
reference) takes seconds on a CPU."""

import copy
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
PB = os.path.dirname(HERE)


def load(*parts):
    with open(os.path.join(PB, *parts)) as f:
        return json.load(f)


def config(name: str) -> dict:
    """The configuration cut to tiny sizes and served in float32: the
    sound tiny run then agrees with the reference to rounding (~1e-6),
    whatever batches the CPU's timing forms, and the faults and the
    control (bfloat16 here) are far above any limit between."""
    cfg = copy.deepcopy(load("configs", f"{name}.json"))
    cfg["infer_dtype"] = "float32"
    m = cfg["model"]
    m.update(encoder_embedding_dim=32, symbols_embedding_dim=32,
             speaker_embedding_dim=16, attention_rnn_dim=48,
             decoder_rnn_dim=48, prenet_dim=24, postnet_embedding_dim=24,
             max_decoder_steps=12 // m["n_frames_per_step"] * 2)
    m["attention_params"] = dict(m["attention_params"], attention_dim=16,
                                 attention_location_n_filters=4,
                                 attention_location_kernel_size=5)
    if "wavernn" in cfg["vocoders"]:
        cfg["vocoders"]["wavernn"].update(gen_dtype="float32",
                                          rnn_dims=24, fc_dims=24,
                                          compute_dims=8, res_out_dims=8,
                                          res_blocks=1)
    cfg["vocoders"]["hifigan"].update(upsample_initial_channel=16,
                                      resblock_kernel_sizes=[3],
                                      resblock_dilation_sizes=[[1, 3]])
    return cfg


def traffic(name: str) -> dict:
    t = copy.deepcopy(load("traffic", f"{name}.json"))
    t["phonemes"] = {"median": 12, "sigma": 0.4, "min": 6, "max": 20,
                     "block": 8}
    if "batch" in t:
        t["batch"] = 4
    if t["kind"] == "open_poisson":
        t["rate_per_s"] = 40.0          # above the CPU's rate: batches form
        t["block"] = 8
    if "pinned_share" in t:
        t["pinned_share"] = 1.0         # one tiny batch has some to compare
    t["warmup_calls"] = 1
    return t


# the check's limits at the tiny sizes in float32, from the tiny runs' own
# readings: sound runs 1.4e-7 to 1.4e-6, the controls (bfloat16) 2.4e-3
# to 2.0e-2
LIMITS = {"hifigan": {"requests": 8, "wave_rel_err": 1e-4,
                      "voc_rel_err": 1e-4, "len_diff": 0},
          "wavernn": {"requests": 8, "wave_rel_err": 1e-4,
                      "voc_rel_err": 1e-4, "len_diff": 0}}


def run(cell_name: str, seed: int, seconds: float = 1.0, *,
        infer_dtype: str = "float32", limits: dict | None = None,
        traffic_over: dict | None = None, **kw) -> dict:
    import harness

    bench = harness.benchmark()
    c = harness.cell(bench, cell_name)
    t = dict(traffic(c["traffic"]), **(traffic_over or {}))
    cfg = dict(config(c["config"]), infer_dtype=infer_dtype)
    return harness.run_cell(cell_name, seed, seconds, False, device="cpu",
                            bench=bench, cfg=cfg, traffic=t,
                            limits=limits or dict(LIMITS[t["vocoder"]]),
                            log=lambda m: None, **kw)
