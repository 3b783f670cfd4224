"""The inputs the benchmark makes for each request besides its text:
the speaker vector, the prenet's dropout masks and WaveRNN's sampling
noise, each from a seed, on the device.  The served system and the
reference are given the same ones."""

from __future__ import annotations

import numpy as np
import torch

from traffic.text import sub_seed

# added to the winner of a request's own Gumbel draw when the request's
# mixture choice is pinned: far beyond any difference of the mixture
# logits, so the noise alone decides the choice (a sampled request whose
# two computations part at a near tie cannot be compared sample by sample)
PIN = 1e3
_U_LO, _U_HI = 1e-5, 1.0 - 1e-5


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


def wavernn_noise(seed: int, steps: int, rows: int, device, *,
                  pinned: bool, K: int = 10):
    """One request's ``(n1 (steps, rows, K), n2 (steps, rows))``: Gumbel
    noise for the mixture choice (pinned: its winner raised by PIN) and
    the logistic draw, from uniforms in (1e-5, 1 − 1e-5)."""
    g = torch.Generator(device=device).manual_seed(seed)
    u1 = torch.rand((steps, rows, K), generator=g, device=device)
    u2 = torch.rand((steps, rows), generator=g, device=device)
    u1 = _U_LO + (_U_HI - _U_LO) * u1
    u2 = _U_LO + (_U_HI - _U_LO) * u2
    n1 = -torch.log(-torch.log(u1))
    if pinned:
        n1 = n1 + PIN * torch.nn.functional.one_hot(
            n1.argmax(-1), K).to(n1.dtype)
    return n1, torch.log(u2) - torch.log1p(-u2)


def fold_rows(frames: int, hop: int, target: int, overlap: int) -> tuple:
    """(folds, folds rounded up to a multiple of 4) of a mel of
    ``frames`` frames, as the served vocoder folds it."""
    T = frames * hop
    n = (T - overlap) // (target + overlap)
    if T - (n * (overlap + target) + overlap) != 0:
        n += 1
    return n, -(-n // 4) * 4
