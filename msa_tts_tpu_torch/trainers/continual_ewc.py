"""Continual learning with Elastic Weight Consolidation (counterpart of
``msa_tts_tpu/trainers/continual_ewc.py``).

The stream keeps an ER-style sample buffer but trains each task on its
own speaker's data only.  At every task after the first (once the
current speaker's samples are in the buffer) a diagonal Fisher is
estimated over the buffer: per batch the squared gradient of the batch's
mean loss, divided by the number of batches; it is anchored at a copy of
the current weights θ*, and the task's loss gains ``ewc_importance`` ·
Σ F (θ − θ*)² over every parameter.  The logged ``loss`` is that total,
``base_loss`` the loss without it.  The Fisher is recomputed at a task's
start from the buffer, so a resumed stream needs no copy of it.  Entry
point::

    python -m msa_tts_tpu_torch.trainers.continual_ewc --params_path <dir>
"""

from __future__ import annotations

import argparse
import os

import torch

from ..ops.nn import synced_batchnorm
from ..parallel.collectives import all_reduce_flat
from ..parallel.tp import leaf_sum
from .continual_base import ContinualTrainerBase


class EWCTrainer(ContinualTrainerBase):
    def _init_criterion_optimizer(self):
        super()._init_criterion_optimizer()
        self._ewc = None        # (fisher, means) once past the first task

    # --------------------------------------------------------- EWC math
    def _compute_fisher(self, spk_itr: int):
        p = self.params
        loader = self._make_loader(
            list(self.buffer),
            batch_size=p.get("buffer_batch_size",
                             p["dataset_train"]["batch_size"]),
            shuffle=bool(p.get("buffer_shuffle", True)))
        n = max(len(loader), 1)
        ts = self.train_state
        fisher = {k: torch.zeros_like(p) for k, p in ts.params.items()}
        for itr, b in enumerate(loader, 1):
            batch = self._unpack_batch(b)
            masks = self._draw_step_masks("fisher", (spk_itr, itr), batch)
            with torch.no_grad():
                for k, g in self._batch_grads(ts, batch, masks).items():
                    fisher[k] = fisher[k] + g * g / n
        # a copy: the penalty is measured from the weights of this moment
        means = {k: p.detach().clone() for k, p in ts.params.items()}
        self._ewc = (fisher, means)

    def _batch_grads(self, ts, batch: dict, masks: dict) -> dict:
        """The gradient of ``batch``'s mean loss at ``ts``'s weights (zero
        where the loss does not reach).  On a mesh each rank takes its
        rows, and the ranks' shares are summed before anything squares
        the gradient."""
        batch, masks, group = self._put_batch(batch, masks)
        params = {k: p.detach().requires_grad_()
                  for k, p in ts.params.items()}
        with torch.enable_grad(), synced_batchnorm(group):
            loss, _ = self._loss_for_batch(params, ts.model_state, batch,
                                           masks)
            if group is not None:
                loss = self._loss_share(loss, None, group.size)
            grads = torch.autograd.grad(loss, list(params.values()),
                                        allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params.values(), grads)]
        if group is not None:
            grads = all_reduce_flat(grads, group)
        return dict(zip(params, grads))

    def _penalty(self, params: dict):
        """``ewc_importance`` · Σ F (θ − θ*)², a sharded leaf's over all its
        shards (``parallel.tp.leaf_sum``)."""
        fisher, means = self._ewc
        importance = float(self.params["ewc_importance"])
        return importance * leaf_sum({
            k: torch.sum(fisher[k] * (params[k] - means[k]) ** 2)
            for k in params})

    def _task_step(self, state, batch, masks):
        if self._ewc is not None:
            return self._grad_step(state, batch, masks, self._penalty)
        return self._train_step(state, batch, masks)

    # ------------------------------------------------------------ stream
    def _initial_task_items(self, speakers):
        items = self._task_items(speakers, "train")
        self.buffer = self._sample_items(items,
                                         self.params["buffer_sample_size"])
        return items

    def _task_train_items(self, speaker: str, spk_itr: int):
        current = self._task_items([speaker], "train")
        if not hasattr(self, "buffer"):
            self.buffer = self._sample_items(
                current, self.params["buffer_sample_size"])
            return current
        # past the first task: the current speaker's samples join the
        # buffer, then the Fisher is estimated at the current weights
        self.buffer = list(self.buffer) + self._sample_items(
            current, self.params["buffer_sample_size"])
        print("Computing EWC Fisher matrix")
        self._compute_fisher(spk_itr)
        return current


def main(args):
    from ..config import load_params

    params = load_params(os.path.join(args.params_path, "params.yml"))
    EWCTrainer(**params).run()


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--params_path", type=str, required=True)
    main(parser.parse_args())
