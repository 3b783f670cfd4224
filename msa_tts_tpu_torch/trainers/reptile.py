"""Reptile meta-trainer (counterpart of ``msa_tts_tpu/trainers/reptile.py``).

First-order meta-learning: per speaker, k inner steps from the current
weights, and the outer optimizer steps along θ₀ − θ_T
(``meta/reptile.py``).  ``reptile_mode: sequential`` (default) takes one
outer step per speaker in the meta-batch, in order, as the reference
does; ``batched`` averages the speakers' directions into one step.
With a ``parallel: {dp, task}`` block, batched mode runs each rank's
K / (dp·task) tasks and sums the directions over the ranks; sequential
mode runs every task on every rank (its outer step sits between tasks).
A meta-batch counts one global step per speaker, as the reference's does.
The run goes on the GPU unless ``device: cpu`` is set in the params.
Entry point::

    python -m msa_tts_tpu_torch.trainers.reptile --params_path <dir>
"""

from __future__ import annotations

import argparse
import os

from ..meta.reptile import make_reptile_step
from ..parallel.shard_meta import task_placement
from .metatrainer import MetaTrainer


class Reptile(MetaTrainer):
    def _init_criterion_optimizer(self):
        super()._init_criterion_optimizer()
        clip = (float(self.params.get("grad_clip_thresh", 1.0))
                if self.params.get("clip_grad_norm", False) else None)
        self.n_inner_train = int(self.params.get("n_inner_train", 1))
        mode = self.params.get("reptile_mode", "sequential")
        args = (self._meta_loss_fn(), self.inner_tx, self.outer_tx,
                self.n_inner_train)
        self._reptile_step = self._in_tp_scope(make_reptile_step(
            *args, mode=mode, clip_thresh=clip))
        self._reptile_step_sharded = None
        if self.mesh is not None and mode == "batched":
            self._reptile_step_sharded = self._in_tp_scope(make_reptile_step(
                *args, mode=mode, clip_thresh=clip,
                placement=task_placement(self.mesh)))
        elif self.mesh is not None:
            print("[parallel] sequential Reptile takes its outer step "
                  "between tasks: every rank runs every task")

    def run(self):
        self.step_global = 0
        done, _ = self._try_resume_epoch()
        interval_test = self.params.get("metatest_epoch_interval", 1)
        interval_ckpt = self.params.get("ckpt_save_epoch_interval", 1)
        self._start_watchdog()
        try:
            for epoch in range(1, self.params["n_epochs"] + 1):
                if epoch <= done:
                    # replay the finished epochs' data draws
                    self.dataloader_metatrain.skip_epoch()
                    if epoch % interval_test == 0:
                        self.dataloader_metatest.skip_epoch()
                    continue
                if not self._metatrain(epoch):
                    print(f"[preemption] stopping mid-epoch {epoch}; "
                          "resume replays it from the last saved state")
                    break
                saved = epoch % interval_ckpt == 0
                if saved:
                    self._save_checkpoint()
                    self._save_epoch_state(epoch)
                if self._preempt_requested():
                    if not saved:
                        self._save_checkpoint()
                        self._save_epoch_state(epoch)
                    print(f"[preemption] stopping after epoch {epoch}")
                    break
                if epoch % interval_test == 0:
                    print("Meta-test phase ...")
                    self._metatest(epoch)
        finally:
            self._stop_watchdog()
            self._finish_checkpoints()

    def _metatrain(self, epoch: int) -> bool:
        """One epoch of meta-batches; False when preempted before its
        end."""
        for itr_b, (speakers, sup, qry) in enumerate(
                self._episodes(self.dataloader_metatrain)):
            if self._preempt_requested():
                return False
            masks = self._draw_masks("train", epoch, itr_b, len(speakers),
                                     self.n_inner_train + 1, sup)
            step = self._reptile_step
            if self._reptile_step_sharded is not None:
                sup, qry, sharded = self._put_task_batch(sup, qry)
                if sharded:
                    step = self._reptile_step_sharded
            self.train_state, metrics = step(self.train_state, sup, qry,
                                             masks)
            self._heartbeat()
            logs = {"train/loss": (float(metrics.loss), self.step_global)}
            for i, spk in enumerate(speakers):
                task_loss = float(metrics.task_losses[i])
                logs[f"train/loss_{spk}"] = (task_loss, self.step_global)
                print(f"| Epoch: {epoch}, itr: {self.step_global}, "
                      f"spk:{spk} ::  step loss: {task_loss:#.4}")
            self.log_writer(logs)
            self.step_global += len(speakers)
        return True


def main(args):
    from ..config import load_params

    params = load_params(os.path.join(args.params_path, "params.yml"))
    Reptile(**params).run()


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--params_path", type=str, required=True)
    main(parser.parse_args())
