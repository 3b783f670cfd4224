"""The buffer (knowledge-distillation) loader (counterpart of
``msa_tts_tpu/dataloaders/loader_buffer.py``).

The reference's buffer loader differs from the default one in a mutable
mel slot per item, which the ER-KD trainer fills with the model's soft
target.  Here that slot is :attr:`~.dataset.Item.soft_mel` and
``collate``'s ``use_soft_mel``, so the buffer loader is the default
loader under the reference's name, with :func:`set_soft_target`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .dataset import Item
from .loader_default import DataLoader, build_datasets, get_dataloader

__all__ = ["get_dataloader", "DataLoader", "set_soft_target",
           "build_datasets"]


def set_soft_target(item: Item, soft_mel: np.ndarray) -> Item:
    """A copy of ``item`` whose training target is ``soft_mel`` (items are
    shared between views, so the copy, not the item, changes)."""
    return dataclasses.replace(item,
                               soft_mel=np.asarray(soft_mel, np.float32))
