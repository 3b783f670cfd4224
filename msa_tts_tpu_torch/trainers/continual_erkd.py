"""Continual learning with Experience Replay and knowledge distillation
(counterpart of ``msa_tts_tpu/trainers/continual_erkd.py``).

When items enter the buffer, the current model's teacher-forced postnet
mel becomes their training target (``Item.soft_mel``), so that replay
distills the earlier model instead of replaying the ground truth.  The
soft targets come from the float32 weights whatever ``compute_dtype``
(the JAX package runs its forward directly, without the trainer's
casts), in training mode with the dropout masks keyed on ``kd_seed``, on
unsorted batches, each cut to its item's true length.  Entry point::

    python -m msa_tts_tpu_torch.trainers.continual_erkd --params_path <dir>
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import torch

from ..dataloaders.collate import collate
from .continual_er import ExperienceReplayTrainer


class ExperienceReplayKnowledgeDistillTrainer(ExperienceReplayTrainer):
    @torch.no_grad()
    def _soften(self, items):
        """``items`` with the current model's teacher-forced prediction
        as their mel target."""
        out = []
        kd_seed = int(self.params.get("kd_seed", 7))
        bs = self.params.get("buffer_batch_size",
                             self.params["dataset_train"]["batch_size"])
        ts = self.train_state
        for start in range(0, len(items), bs):
            chunk = items[start: start + bs]
            batch = self._unpack_batch(collate(
                chunk, reduction_factor=self.cfg.n_frames_per_step,
                sort_by_length=False, use_soft_mel=False))
            masks = self._draw_step_masks("kd", (kd_seed,), batch)
            with self._tp_scope():
                outs, _ = torch.func.functional_call(
                    self.model, {**ts.params, **ts.model_state},
                    (batch["inputs"], batch["input_lengths"],
                     batch["melspecs"], batch["melspec_lengths"],
                     batch["speaker_vecs"], masks))
            mel_post = outs[1].cpu().numpy()
            for i, it in enumerate(chunk):
                out.append(dataclasses.replace(
                    it, soft_mel=mel_post[i, :, :it.mel.shape[1]]))
        return out

    def _new_buffer_items(self, items):
        return self._soften(super()._new_buffer_items(items))


def main(args):
    from ..config import load_params

    params = load_params(os.path.join(args.params_path, "params.yml"))
    ExperienceReplayKnowledgeDistillTrainer(**params).run()


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--params_path", type=str, required=True)
    main(parser.parse_args())
