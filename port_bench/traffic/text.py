"""Sentences for the traffic, drawn from the seed.

Phoneme counts follow a clipped log-normal (about LJSpeech's sentence
lengths: median ~80 phoneme symbols, 20 to 190).  So that every seed
asks for the same work, the counts come in blocks of ``block``: one
block is the distribution's ``block`` quantiles, shuffled by the seed,
or, for batches, dealt into the same batches for every seed
(:func:`batch_counts`).  Each sentence is words from ``words.txt`` drawn
by the seed until the phoneme count (as the rule-based G2P counts it,
word separators included) reaches the block's value.
"""

from __future__ import annotations

import functools
import hashlib
import os
from statistics import NormalDist

import numpy as np

from reference.g2p import phoneme_ids

_WORDS = None


def words() -> list:
    global _WORDS
    if _WORDS is None:
        path = os.path.join(os.path.dirname(__file__), "words.txt")
        with open(path) as f:
            _WORDS = [w.strip() for w in f if w.strip()]
    return _WORDS


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one purpose of one run, from the run's seed."""
    h = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


@functools.lru_cache(maxsize=64)
def _quantiles(median, sigma, lo, hi, n) -> tuple:
    nd = NormalDist(np.log(median), sigma)
    return tuple(int(round(min(max(np.exp(nd.inv_cdf((i + 0.5) / n)), lo),
                               hi))) for i in range(n))


def quantile_counts(p: dict) -> list:
    return list(_quantiles(p["median"], p["sigma"], p["min"], p["max"],
                           int(p["block"])))


def batch_counts(p: dict, seed: int, b: int, rows: int) -> list:
    """The counts of batch ``b`` of ``rows`` rows.  A block's quantiles
    are dealt into ``block / rows`` batches by stride (batch j takes
    quantiles j, j + block/rows, ...), so every seed sends the same
    batches; the seed orders the batches within each block and the rows
    within each batch."""
    q = quantile_counts(p)
    per = len(q) // rows
    if per * rows != len(q):
        raise ValueError(f"a block of {len(q)} does not deal into {rows} rows")
    blk, j = divmod(b, per)
    j = int(np.random.default_rng(sub_seed(seed, "batches", blk))
            .permutation(per)[j])
    counts = q[j::per]
    rng = np.random.default_rng(sub_seed(seed, "rows", b))
    return [counts[i] for i in rng.permutation(rows)]


def phoneme_counts(p: dict, seed: int, n: int) -> list:
    """``n`` target counts: whole blocks of the quantiles, each shuffled."""
    q = quantile_counts(p)
    out, b = [], 0
    while len(out) < n:
        rng = np.random.default_rng(sub_seed(seed, "lengths", b))
        out += [q[i] for i in rng.permutation(len(q))]
        b += 1
    return out[:n]


@functools.cache
def cost(word: str) -> int:
    return len(phoneme_ids(word))


@functools.cache
def _costs() -> dict:
    """Phoneme symbols a word adds to a sentence (its own and one
    separator) → the words that add that many."""
    out: dict = {}
    for w in words():
        out.setdefault(cost(w), []).append(w)
    return out


def sentence(target: int, seed: int, i: int) -> str:
    """Words whose phoneme count is exactly ``target``: random words
    while more than two words' worth is left, then one or two words that
    fill the rest exactly."""
    rng = np.random.default_rng(sub_seed(seed, "words", i))
    ws, costs = words(), _costs()
    out, left = [], int(target)
    top = max(costs)
    while left > 2 * top:
        w = ws[int(rng.integers(len(ws)))]
        out.append(w)
        left -= cost(w)
    if left in costs and (left <= top):
        fill = [left]
    else:
        pairs = [(a, left - a) for a in sorted(costs) if left - a in costs]
        fill = list(pairs[int(rng.integers(len(pairs)))])
    for c in fill:
        out.append(costs[c][int(rng.integers(len(costs[c])))])
    order = rng.permutation(len(out))
    return " ".join(out[j] for j in order)


def sentences(p: dict, seed: int, n: int) -> list:
    return [sentence(t, seed, i)
            for i, t in enumerate(phoneme_counts(p, seed, n))]
