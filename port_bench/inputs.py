"""The inputs the benchmark makes for each request besides its text:
the speaker vector and the prenet's dropout masks, each from a seed, on
the device (a vocoder's own inputs: its part's ``call_inputs``).  The
served system and the reference are given the same ones."""

from __future__ import annotations

import numpy as np
import torch

from traffic.text import sub_seed


def speaker_vector(cfg: dict, seed: int) -> np.ndarray:
    """A unit-norm d-vector, the run's one speaker."""
    rng = np.random.default_rng(sub_seed(seed, "speaker"))
    v = rng.standard_normal(cfg["model"]["speaker_embedding_dim"])
    return (v / np.linalg.norm(v)).astype(np.float32)


def prenet_masks(cfg: dict, seed: int, rows: int, device) -> torch.Tensor:
    """(S, 2, rows, P) 0/1 float32 masks, kept with 1 − p_prenet_dropout."""
    m = cfg["model"]
    keep = 1.0 - m.get("p_prenet_dropout", 0.5)
    g = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand((m["max_decoder_steps"], 2, rows, m["prenet_dim"]),
                   generator=g, device=device)
    return (u < keep).to(torch.float32)


def server_masks(cfg: dict, rows: int) -> torch.Tensor:
    """The masks the served system draws for a batch it is given no masks
    for: a CPU generator seeded 0, (S, 2, rows, P) with rows the batch's
    padded row count."""
    m = cfg["model"]
    keep = 1.0 - m.get("p_prenet_dropout", 0.5)
    g = torch.Generator().manual_seed(0)
    u = torch.rand((m["max_decoder_steps"], 2, rows, m["prenet_dim"]),
                   generator=g)
    return (u < keep).to(torch.float32)
