"""Cumulative trainer, the joint upper bound of a speaker stream
(counterpart of ``msa_tts_tpu/trainers/cumulative.py``): the stream
protocol of the continual trainers, each task training on every speaker
seen so far (no buffer).  Entry point::

    python -m msa_tts_tpu_torch.trainers.cumulative --params_path <dir>
"""

from __future__ import annotations

import argparse
import os

from .continual_base import ContinualTrainerBase


class CumulativeTrainer(ContinualTrainerBase):
    def _task_train_items(self, speaker: str, spk_itr: int):
        return self._task_items(self.speakers_so_far, "train")


def main(args):
    from ..config import load_params

    params = load_params(os.path.join(args.params_path, "params.yml"))
    CumulativeTrainer(**params).run()


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--params_path", type=str, required=True)
    main(parser.parse_args())
