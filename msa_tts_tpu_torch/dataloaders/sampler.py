"""Batch-order samplers (counterpart of
``msa_tts_tpu/dataloaders/sampler.py``, on the same numpy
``default_rng`` draws, so that the orders are the JAX package's byte for
byte).

``BinnedLengthSampler`` is the reference's duration-binned shuffle: sort
by length, shuffle inside fixed-size bins, shuffle the order of the bins,
so that a batch holds items of similar length while epochs stay
random.
"""

from __future__ import annotations

import numpy as np


class BinnedLengthSampler:
    def __init__(self, lengths, batch_size: int, bin_size: int, seed: int = 0):
        if bin_size % batch_size != 0:
            raise ValueError("bin_size must be a multiple of batch_size")
        self.idx = np.argsort(np.asarray(lengths))
        self.batch_size = batch_size
        self.bin_size = bin_size
        self._rng = np.random.default_rng(seed)

    def __iter__(self):
        idx = self.idx.copy()
        n_bins = len(idx) // self.bin_size
        bins = []
        for i in range(n_bins):
            b = idx[i * self.bin_size: (i + 1) * self.bin_size]
            self._rng.shuffle(b)
            bins.append(b)
        order = np.arange(n_bins)
        self._rng.shuffle(order)
        out = (np.concatenate([bins[i] for i in order]) if bins
               else np.empty((0,), np.int64))
        rest = idx[n_bins * self.bin_size:]
        self._rng.shuffle(rest)
        return iter(np.concatenate([out, rest]).astype(np.int64))

    def __len__(self):
        return len(self.idx)


class ShuffleSampler:
    def __init__(self, n: int, seed: int = 0):
        self.n = n
        self._rng = np.random.default_rng(seed)

    def __iter__(self):
        return iter(self._rng.permutation(self.n))

    def __len__(self):
        return self.n


class SequentialSampler:
    def __init__(self, n: int):
        self.n = n

    def __iter__(self):
        return iter(range(self.n))

    def __len__(self):
        return self.n
