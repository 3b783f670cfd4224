"""Continual learning with Experience Replay (counterpart of
``msa_tts_tpu/trainers/continual_er.py``).

The first task seeds the buffer with ``buffer_sample_size`` random items
of its own and trains on its own data; every later task trains on its
data and the buffer, then adds ``buffer_sample_size`` random items of
its own to the buffer.  Entry point::

    python -m msa_tts_tpu_torch.trainers.continual_er --params_path <dir>
"""

from __future__ import annotations

import argparse
import os

from .continual_base import ContinualTrainerBase


class ExperienceReplayTrainer(ContinualTrainerBase):
    def _new_buffer_items(self, items):
        """What enters the buffer from ``items`` (ER-KD softens them,
        ER-reg may replicate them)."""
        return self._sample_items(items, self.params["buffer_sample_size"])

    def _initial_task_items(self, speakers):
        items = self._task_items(speakers, "train")
        self.buffer = self._new_buffer_items(items)
        return items

    def _task_train_items(self, speaker: str, spk_itr: int):
        current = self._task_items([speaker], "train")
        if not hasattr(self, "buffer"):
            # the first task seeds the buffer and trains on its own data
            self.buffer = self._new_buffer_items(current)
            return current
        train_items = current + list(self.buffer)
        self.buffer = list(self.buffer) + self._new_buffer_items(current)
        return train_items


def main(args):
    from ..config import load_params

    params = load_params(os.path.join(args.params_path, "params.yml"))
    ExperienceReplayTrainer(**params).run()


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--params_path", type=str, required=True)
    main(parser.parse_args())
