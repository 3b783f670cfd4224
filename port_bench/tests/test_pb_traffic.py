"""The traffic generators are deterministic under the seed, and every
seed asks for the same work."""

import pytest

from reference.g2p import phoneme_ids
from traffic import open_poisson, text

P = {"median": 80, "sigma": 0.45, "min": 20, "max": 190, "block": 64}
BIG = 2 ** 33 + 12345


@pytest.mark.parametrize("seed", [0, 7, BIG])
def test_sentences_repeat_and_hit_their_counts(seed):
    a = text.sentences(P, seed, 70)
    assert a == text.sentences(P, seed, 70)
    assert [len(phoneme_ids(s)) for s in a] == text.phoneme_counts(P, seed, 70)


def test_every_seed_the_same_lengths_in_another_order():
    a, b = (text.phoneme_counts(P, s, 128) for s in (1, BIG))
    assert a != b and sorted(a) == sorted(b)
    q = text.quantile_counts(P)
    assert min(q) >= 20 and max(q) <= 190 and 70 <= sorted(q)[32] <= 90


def test_arrivals_same_gaps_in_another_order():
    p = {"rate_per_s": 20.0, "block": 64}
    a, b = open_poisson.gaps(p, 3, 64), open_poisson.gaps(p, BIG, 64)
    assert a == open_poisson.gaps(p, 3, 64)
    assert a != b and sorted(a) == sorted(b)
    assert abs(sum(a) / 64 - 1 / 20.0) < 0.1 / 20.0


def test_sub_seed_fits_and_differs():
    s = {text.sub_seed(BIG, "x", i) for i in range(100)}
    assert len(s) == 100 and all(0 <= v < 2 ** 63 for v in s)


@pytest.mark.parametrize("rows", [1, 16])
def test_every_seed_the_same_batches_in_another_order(rows):
    def batches(seed):
        return [text.batch_counts(P, seed, b, rows)
                for b in range(2 * 64 // rows)]

    a, b = batches(5), batches(BIG)
    assert a != b
    assert sorted(map(sorted, a)) == sorted(map(sorted, b))
    assert sorted(c for x in a[: 64 // rows] for c in x) == sorted(
        text.quantile_counts(P))
