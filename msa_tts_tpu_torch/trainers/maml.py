"""MAML meta-trainer, second or first order (counterpart of
``msa_tts_tpu/trainers/maml.py``).

``track_higher_grads: true`` → second-order MAML (gradients with
respect to the initial weights through the inner steps); ``false`` →
FOMAML (the query gradient at the adapted weights).  The tasks of a
meta-batch run one after another (``meta/maml.py``); ``maml_remat`` is
ignored, since only one task's graph is alive at a time.  With a
``parallel: {dp, task}`` block each rank runs its K / (dp·task) tasks
(whole, where K does not divide) and the ranks' gradients are summed.
The run goes on the GPU unless ``device: cpu`` is set in the params.
Entry point::

    python -m msa_tts_tpu_torch.trainers.maml --params_path <dir>
"""

from __future__ import annotations

import argparse
import os

from ..meta.maml import make_maml_step
from ..parallel.shard_meta import task_placement
from .metatrainer import MetaTrainer


class MAML(MetaTrainer):
    def _init_criterion_optimizer(self):
        super()._init_criterion_optimizer()
        clip = (float(self.params.get("grad_clip_thresh", 1.0))
                if self.params.get("clip_grad_norm", False) else None)
        self.n_inner_train = int(self.params.get("n_inner_train", 1))
        # `maml_remat` is not read: one task's graph is alive at a time,
        # so recomputation has nothing to buy
        kw = dict(
            second_order=bool(self.params.get("track_higher_grads", True)),
            clip_thresh=clip)
        args = (self._meta_loss_fn(), self.inner_tx, self.outer_tx,
                self.n_inner_train)
        self._maml_step = self._in_tp_scope(make_maml_step(*args, **kw))
        # on a mesh: this rank's K/world tasks, the gradients summed
        self._maml_step_sharded = None if self.mesh is None else (
            self._in_tp_scope(make_maml_step(
                *args, **kw, placement=task_placement(self.mesh))))

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
        """One epoch of outer steps; False when preempted before its
        end."""
        for itr_b, (speakers, sup, qry) in enumerate(
                self._episodes(self.dataloader_metatrain)):
            if self._preempt_requested():
                return False
            masks = self._draw_masks("train", epoch, itr_b, len(speakers),
                                     self.n_inner_train + 1, sup)
            sup, qry, sharded = self._put_task_batch(sup, qry)
            step = self._maml_step_sharded if sharded else self._maml_step
            self.train_state, metrics = step(self.train_state, sup, qry,
                                             masks)
            self._heartbeat()
            loss = float(metrics.loss)
            logs = {
                "train/loss": (loss, self.step_global),
                "train/grad_norm": (float(metrics.grad_norm),
                                    self.step_global),
            }
            for i, spk in enumerate(speakers):
                task_loss = float(metrics.task_losses[i])
                logs[f"train/loss_{spk}"] = (task_loss, self.step_global)
                print(f"| Epoch: {epoch}, itr: {self.step_global}, "
                      f"spk:{spk} ::  step loss: {task_loss:#.4}")
            self.log_writer(logs)
            self.step_global += 1
        return True


def main(args):
    from ..config import load_params

    params = load_params(os.path.join(args.params_path, "params.yml"))
    MAML(**params).run()


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--params_path", type=str, required=True)
    main(parser.parse_args())
