"""The weights of every configuration are the tensors they were before
the vocoders moved into their parts (``parts/``): the same leaves drawn
in the same order from one generator, pinned by hashes of the tensors
that the harness drew on the CPU before the move."""

import hashlib

import pytest
import torch

import harness
import weights as W

# configuration/seed → model → the first 16 hex digits of the sha256 of
# every leaf's name, type, shape and bytes, in order
PINNED = {
    "msa_t2nv_fa_r2/3": {"tacotron": "4c12312630f90de3",
                         "wavernn": "a6a64dc68949a9d8",
                         "hifigan": "8824ec445e91d948"},
    "msa_t2nv_fa_r2/1099511627787": {"tacotron": "c62bb612f9a3ede7",
                                     "wavernn": "c1f78876a98f737c",
                                     "hifigan": "7d7206ff889a7cc9"},
    "t2nv_lsa_r1/3": {"tacotron": "8b6ef0354faf03cf",
                      "hifigan": "682579ad64bf253a"},
    "t2nv_lsa_r1/1099511627787": {"tacotron": "61cc88e6888b56e6",
                                  "hifigan": "232b586e64d87076"},
}


def digest(sd: dict) -> str:
    h = hashlib.sha256()
    for k, t in sd.items():
        t = t.detach().contiguous().cpu().reshape(-1)
        h.update(f"{k}|{t.dtype}|{tuple(sd[k].shape)}|".encode())
        h.update(t.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("key", sorted(PINNED))
def test_weights_as_pinned(key):
    name, seed = key.split("/")
    bench = harness.benchmark()
    cfg = harness.load_json(harness.config_file(bench, name))
    with torch.no_grad():
        w = W.all_weights(cfg, int(seed), "cpu")
    assert {m: digest(sd) for m, sd in w.items()} == PINNED[key]


def test_a_new_vocoder_draws_after_the_first():
    cfg = {"vocoders": {"griffinlim": {}, "hifigan": {}, "x": {},
                        "wavernn": {}}}
    assert W.vocoder_order(cfg) == ["wavernn", "hifigan", "griffinlim", "x"]
