"""The joint-training dataloader (counterpart of
``msa_tts_tpu/dataloaders/loader_default.py``): ``get_dataloader(**params)``
parses the metafile, applies the duration budget and the train split,
and returns ``(train_loader, test_loader, log_string)``; a loader yields
numpy :class:`~.collate.Batch` es collated from the feature cache.
"""

from __future__ import annotations

import os
from typing import Iterator, Sequence

from .collate import Batch, collate
from .dataset import Item, TTSDataset
from .metafile import parse_metafile, split_speakers
from .sampler import BinnedLengthSampler, SequentialSampler, ShuffleSampler


class DataLoader:
    """An epoch iterator over a :class:`TTSDataset` or a list of items."""

    def __init__(self, dataset: TTSDataset | Sequence[Item], *,
                 batch_size: int, sampler=None, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0,
                 reduction_factor: int = 1,
                 text_pad_multiple: int | None = 16,
                 mel_pad_multiple: int | None = 32,
                 use_soft_mel: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        if sampler is None:
            sampler = (ShuffleSampler(len(dataset), seed) if shuffle
                       else SequentialSampler(len(dataset)))
        self.sampler = sampler
        self.drop_last = drop_last
        self.reduction_factor = reduction_factor
        self.text_pad_multiple = text_pad_multiple
        self.mel_pad_multiple = mel_pad_multiple
        self.use_soft_mel = use_soft_mel

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def skip_epoch(self) -> None:
        """Advance the sampler by one epoch without collating: resume
        fast-forwards the shuffle order with it."""
        for _ in self.sampler:
            pass

    def __iter__(self) -> Iterator[Batch]:
        buf = []
        for idx in self.sampler:
            buf.append(self.dataset[int(idx)])
            if len(buf) == self.batch_size:
                yield self._make_batch(buf)
                buf = []
        if buf and not self.drop_last:
            yield self._make_batch(buf)

    def _make_batch(self, items) -> Batch:
        return collate(items, reduction_factor=self.reduction_factor,
                       text_pad_multiple=self.text_pad_multiple,
                       mel_pad_multiple=self.mel_pad_multiple,
                       use_soft_mel=self.use_soft_mel)


def build_datasets(**params) -> tuple[TTSDataset, TTSDataset, str]:
    """The train and test datasets of ``dataset_train`` and the split's
    log (shared by the default and the buffer loader)."""
    ds = params["dataset_train"]
    utts = parse_metafile(os.path.join(ds["dataset_path"], ds["meta_file"]))
    splits, logs = split_speakers(
        utts, ds["speakers_list"],
        total_duration_per_spk=ds.get("total_duration_per_spk", -1),
        perc_train=ds.get("perc_train", 0.9),
        seed=params.get("dataset_random_seed", 0),
    )
    common = dict(
        dataset_path=ds["dataset_path"],
        audio_folder=ds.get("audio_folder", "wavs"),
        trim_margin_silence=ds.get("trim_margin_silence", False),
        ref_level_db=ds.get("ref_level_db", 26),
        audio_processor=params.get("audio_processor", "ap"),
        audio_params=params["audio_params"],
    )
    return (TTSDataset(splits, "train", **common),
            TTSDataset(splits, "test", **common), logs)


def get_dataloader(**params) -> tuple[DataLoader, DataLoader, str]:
    dataset_train, dataset_test, logs = build_datasets(**params)
    ds = params["dataset_train"]
    batch_size = ds["batch_size"]
    seed = params.get("dataset_random_seed", 0)
    use_binned = ds.get("use_binned_sampler", False)
    sampler = (BinnedLengthSampler(dataset_train.get_audio_durations(),
                                   batch_size,
                                   ds.get("bin_size", batch_size), seed=seed)
               if use_binned else None)
    common = dict(
        batch_size=batch_size,
        reduction_factor=params["model"]["n_frames_per_step"],
        text_pad_multiple=params.get("text_pad_multiple", 16),
        mel_pad_multiple=params.get("mel_pad_multiple", 32),
    )
    loader_train = DataLoader(dataset_train, sampler=sampler,
                              shuffle=not use_binned, seed=seed, **common)
    loader_test = DataLoader(dataset_test, shuffle=False, **common)
    return loader_train, loader_test, logs
