"""Episodic (meta-learning) dataloader (counterpart of
``msa_tts_tpu/dataloaders/loader_meta.py``): the unit of iteration is a
speaker (task).  Per task it draws up to ``shots`` utterances from the
speaker's train pool (support) and test pool (query) with the same
``np.random.default_rng(seed)`` draws, in the same order, as the JAX
package, so that the episodes are byte for byte the same; a meta-batch
is ``meta_batch_size`` speakers, stacked into fixed ``(n_tasks, shots,
...)`` arrays of one padded shape for the whole dataset.
"""

from __future__ import annotations

import os
from typing import Iterator, NamedTuple

import numpy as np
import torch

from .collate import Batch, collate
from .dataset import TTSDataset
from .metafile import parse_metafile, split_speakers


class TaskBatch(NamedTuple):
    """A stacked episode: leading axis = task (speaker)."""

    inputs: np.ndarray          # (K, S, T_text) int32
    input_lengths: np.ndarray   # (K, S)
    mels: np.ndarray            # (K, S, n_mel, T_mel)
    mel_lengths: np.ndarray     # (K, S)
    speaker_ids: np.ndarray     # (K, S)
    spk_embs: np.ndarray        # (K, S, D)
    stop_labels: np.ndarray     # (K, S, T_mel)

    def speaker_vecs(self, speaker_emb_type: str) -> np.ndarray:
        if speaker_emb_type == "learnable_lookup":
            return self.speaker_ids
        return self.spk_embs


def stack_batches(batches: list[Batch]) -> TaskBatch:
    """Stack equal-shape per-task batches along a new leading axis."""
    return TaskBatch(*(np.stack([getattr(b, f) for b in batches])
                       for f in TaskBatch._fields))


def unpack_task_batch(tb: TaskBatch, speaker_emb_type: str,
                      device) -> dict:
    """A stacked episode as the model's batch dictionary on ``device``,
    leading axis the task (integers as int64)."""
    def t(x):
        x = torch.from_numpy(np.ascontiguousarray(x))
        if not x.is_floating_point():
            x = x.to(torch.int64)
        return x.to(device, non_blocking=True)

    return {
        "inputs": t(tb.inputs),
        "input_lengths": t(tb.input_lengths),
        "melspecs": t(tb.mels),
        "melspec_lengths": t(tb.mel_lengths),
        "speaker_vecs": t(tb.speaker_vecs(speaker_emb_type)),
        "stop_labels": t(tb.stop_labels),
    }


def _round16(n: int) -> int:
    return ((n + 15) // 16) * 16


def _round_mult(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


class MetaDataLoader:
    """Yields meta-batches of per-speaker support/query episodes."""

    def __init__(self, dataset: TTSDataset, dataset_test: TTSDataset, *,
                 shots: int, meta_batch_size: int,
                 reduction_factor: int = 1, seed: int = 0,
                 text_pad_to: int | None = None,
                 mel_pad_to: int | None = None):
        self.ds_support = dataset
        self.ds_query = dataset_test
        self.shots = shots
        self.meta_batch_size = meta_batch_size
        self.reduction_factor = reduction_factor
        self.speakers = list(dataset.speaker_to_id.keys())
        self._rng = np.random.default_rng(seed)
        # one padded shape for every episode
        self.text_pad_to = text_pad_to or _round16(
            max(dataset.max_text_len(), dataset_test.max_text_len()))
        mel_max = max(dataset.max_mel_len(), dataset_test.max_mel_len())
        self.mel_pad_to = mel_pad_to or _round_mult(
            mel_max, max(16, reduction_factor))

    def __len__(self) -> int:
        k = self.meta_batch_size
        return (len(self.speakers) + k - 1) // k

    def _draw(self, pool_n: int) -> np.ndarray:
        """``shots`` indices into a pool of ``pool_n``: without
        replacement, then with it when the pool is short (so that the
        shot axis stays static)."""
        n = min(pool_n, self.shots)
        sel = self._rng.choice(pool_n, size=n, replace=False)
        if n < self.shots:
            extra = self._rng.choice(pool_n, size=self.shots - n,
                                     replace=True)
            sel = np.concatenate([sel, extra])
        return sel

    def _episode(self, speaker: str) -> dict[str, Batch]:
        out = {}
        for mode, ds in (("train", self.ds_support), ("test", self.ds_query)):
            pool = ds.items_for_speaker(speaker)
            if not pool:
                raise ValueError(
                    f"speaker {speaker!r} has no items in its {mode!r} "
                    "split: too few utterances survived the duration "
                    "budget / train-test split to build episodes (each "
                    "speaker needs at least one train and one test item)"
                )
            out[mode] = collate(
                [pool[i] for i in self._draw(len(pool))],
                reduction_factor=self.reduction_factor,
                text_pad_to=self.text_pad_to, mel_pad_to=self.mel_pad_to)
        return out

    def skip_epoch(self) -> None:
        """Advance the sampling generator by exactly one epoch's draws
        without building episodes (resume fast-forwards with it)."""
        for i in self._rng.permutation(len(self.speakers)):
            for ds in (self.ds_support, self.ds_query):
                self._draw(len(ds.items_for_speaker(self.speakers[i])))

    def __iter__(self) -> Iterator[dict[str, dict[str, Batch]]]:
        order = self._rng.permutation(len(self.speakers))
        for start in range(0, len(order), self.meta_batch_size):
            chunk = order[start: start + self.meta_batch_size]
            yield {self.speakers[i]: self._episode(self.speakers[i])
                   for i in chunk}

    def iter_stacked(self) -> Iterator[tuple[list[str], TaskBatch,
                                             TaskBatch]]:
        """Yield ``(speakers, support, query)`` with fixed-shape stacked
        arrays."""
        for meta_batch in self:
            speakers = list(meta_batch.keys())
            yield (speakers,
                   stack_batches([meta_batch[s]["train"] for s in speakers]),
                   stack_batches([meta_batch[s]["test"] for s in speakers]))


def get_dataloader(phase_name: str, **params):
    """The episodic loader for ``dataset_<phase_name>`` and its split
    log."""
    ds_data = params[f"dataset_{phase_name}"]
    utts = parse_metafile(os.path.join(ds_data["dataset_path"],
                                       ds_data["meta_file"]))
    splits, logs = split_speakers(
        utts, ds_data["speakers_list"],
        total_duration_per_spk=ds_data.get("total_duration_per_spk", -1),
        perc_train=ds_data.get("perc_train", 0.9),
        seed=params.get("dataset_random_seed", 0),
    )
    common = dict(
        dataset_path=ds_data["dataset_path"],
        audio_folder=ds_data.get("audio_folder", "wavs"),
        trim_margin_silence=ds_data.get("trim_margin_silence", False),
        ref_level_db=ds_data.get("ref_level_db", 26),
        audio_processor=params.get("audio_processor", "ap"),
        audio_params=params["audio_params"],
    )
    loader = MetaDataLoader(
        TTSDataset(splits, "train", **common),
        TTSDataset(splits, "test", **common),
        shots=ds_data["batch_size"],
        meta_batch_size=params.get("meta_batch_size", 1),
        reduction_factor=params["model"]["n_frames_per_step"],
        seed=params.get("dataset_random_seed", 0),
    )
    return loader, logs
