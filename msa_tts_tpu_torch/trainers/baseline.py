"""Joint multi-speaker trainer, the "baseline" method (counterpart of
``msa_tts_tpu/trainers/baseline.py``).

An epoch loop of teacher-forced training over all speakers, a test pass
after each epoch that keeps ``checkpoint_best.ckpt``, periodic
checkpoints with the epoch state (``best_test_loss`` with it) for
``resume``, and with ``do_metatest`` a periodic meta-test: k adaptation
steps on each held-out speaker and the query loss.  Batches reach the
device ``prefetch`` ahead (``dataloaders/prefetch.py``).  The run goes
on the GPU unless ``device: cpu`` is set in the params.  Entry point::

    python -m msa_tts_tpu_torch.trainers.baseline --params_path <dir>
"""

from __future__ import annotations

import argparse
import contextlib
import os

from ..dataloaders.loader_default import get_dataloader
from ..dataloaders.loader_meta import get_dataloader as get_dataloader_meta
from ..dataloaders.loader_meta import unpack_task_batch
from ..dataloaders.prefetch import prefetch_to_device, tree_map
from ..meta.maml import make_metatest_fn
from ..utils.profiling import trace
from .base import TrainerBase
from .train_state import make_optimizer


class JointTrainer(TrainerBase):
    def _init_dataloaders(self):
        print("\nInitializing train/test loaders")
        (self.dataloader_train, self.dataloader_test,
         logs_tr) = get_dataloader(**self.params)
        log_ds = "Train:\n\n" + logs_tr + "\n\n\n"
        if self.params.get("do_metatest", False):
            print("\nInitializing meta-test loaders")
            self.dataloader_metatest, logs_mts = get_dataloader_meta(
                "metatest", **self.params)
            log_ds += "Meta-Test:\n\n" + logs_mts
        if not self.is_writer:
            return
        with open(os.path.join(self.path_manager.output_path,
                               "dataset_details.txt"), "w") as f:
            f.write(log_ds)

    def _num_speakers(self) -> int:
        return len(self.dataloader_train.dataset.speaker_to_id)

    def _init_criterion_optimizer(self):
        super()._init_criterion_optimizer()
        if self.params.get("do_metatest", False):
            def loss_fn(params, model_state, batch, masks):
                loss, (_, new_ms) = self._loss_for_batch(
                    params, model_state, batch, masks)
                return loss, new_ms

            self.n_inner_test = int(self.params.get("n_inner_test", 1))
            self._metatest_fn = make_metatest_fn(
                loss_fn, make_optimizer(self.inner_optim_cfg),
                self.n_inner_test)

    # ------------------------------------------------------------- run
    def _metatest_due(self, epoch: int) -> bool:
        return (self.params.get("do_metatest", False) and epoch
                % self.params.get("metatest_epoch_interval", 1) == 0)

    def run(self):
        self.step_global = 0
        self.best_test_loss = float("inf")
        done, extra = self._try_resume_epoch()
        if extra is not None:
            self.best_test_loss = extra.get("best_test_loss", float("inf"))
        interval_ckpt = self.params.get("ckpt_save_epoch_interval", 1)
        self._start_watchdog()
        try:
            for epoch in range(1, self.params["n_epochs"] + 1):
                if epoch <= done:
                    # replay the finished epochs' data draws
                    self.dataloader_train.skip_epoch()
                    if self._metatest_due(epoch):
                        self.dataloader_metatest.skip_epoch()
                    continue
                if not self._train(epoch):
                    # a partial epoch cannot resume bit for bit: exit on
                    # the last saved state, which resume replays from
                    print(f"[preemption] stopping mid-epoch {epoch}; "
                          "resume replays it from the last saved state")
                    break
                self._test(epoch)
                saved = epoch % interval_ckpt == 0
                if saved:
                    self._save_checkpoint()
                    self._save_epoch_state(
                        epoch, {"best_test_loss": self.best_test_loss})
                if self._preempt_requested():
                    if not saved:
                        self._save_checkpoint()
                        self._save_epoch_state(
                            epoch, {"best_test_loss": self.best_test_loss})
                    print(f"[preemption] stopping after epoch {epoch}")
                    break
                if self._metatest_due(epoch):
                    print("Meta-test phase ...")
                    self._metatest(epoch)
        finally:
            self._stop_watchdog()
            self._finish_checkpoints()

    # ----------------------------------------------------------- train
    def _train(self, epoch: int) -> bool:
        """One epoch; False when preempted before its end.  With
        ``profile_dir``, epoch ``profile_epoch`` runs under
        ``utils.profiling.trace`` (``torch.profiler``) and its trace is
        written there."""
        print(f"===== Training epoch {epoch}")
        profile_dir = self.params.get("profile_dir")
        if profile_dir and epoch == int(self.params.get("profile_epoch", 1)):
            ctx = trace(profile_dir, self.device)
        else:
            ctx = contextlib.nullcontext()
        with ctx:
            return self._train_epoch(epoch)

    def _batches(self, loader):
        """The loader's batches on the device, ``prefetch`` ahead."""
        n = int(self.params.get("prefetch", 2))
        if n <= 0:
            return (self._unpack_batch(b) for b in loader)
        return prefetch_to_device((self._host_batch(b) for b in loader),
                                  size=n, device=self.device)

    def _train_epoch(self, epoch: int) -> bool:
        n_batches = len(self.dataloader_train)
        last = None
        for itr, batch in enumerate(self._batches(self.dataloader_train), 1):
            if self._preempt_requested():
                return False
            masks = self._draw_step_masks("train", (epoch, itr), batch)
            self.train_state, metrics, outs = self._train_step(
                self.train_state, batch, masks)
            self._heartbeat()
            loss, mcd = float(metrics["loss"]), float(metrics["mcd"])
            if self.step_global % self.params.get("tb_log_interval", 10) == 0:
                self.log_writer({
                    "train/loss": (loss, self.step_global),
                    "train/mcd": (mcd, self.step_global),
                    "train/grad_norm": (float(metrics["grad_norm"]),
                                        self.step_global),
                })
            print(f"| Epoch: {epoch} - {self.step_global}, itr: {itr}/"
                  f"{n_batches} ::  step loss: {loss:#.4} | mcd: {mcd:#.4} ")
            self.step_global += 1
            last = (batch, outs)
        if last is not None and self.params.get("plot_examples", True):
            self._plot_example(last, f"train-{self.step_global // 1000}K")
        return True

    # ------------------------------------------------------------ test
    def _test(self, epoch: int):
        print(f"===== Testing epoch {epoch}")
        loss_total = mcd_total = 0.0
        n = 0
        for itr, batch in enumerate(self._batches(self.dataloader_test), 1):
            masks = self._draw_step_masks("test", (epoch, itr), batch)
            self.train_state, metrics, _ = self._eval_step(
                self.train_state, batch, masks)
            self._heartbeat()
            loss_total += float(metrics["loss"])
            mcd_total += float(metrics["mcd"])
            n += 1
        if n == 0:
            return
        loss_total /= n
        mcd_total /= n
        if loss_total < self.best_test_loss:
            self.best_test_loss = loss_total
            self._save_checkpoint("checkpoint_best.ckpt")
        self.log_writer({"test/loss": (loss_total, self.step_global),
                         "test/mcd": (mcd_total, self.step_global)})
        print(f"| Epoch: {epoch}, itr: {self.step_global} ::  loss_total:"
              f" {loss_total:#.4} | mcd_total: {mcd_total:#.4} ")

    # -------------------------------------------------------- metatest
    def _metatest(self, epoch: int):
        """Per held-out speaker of each meta-test batch: ``n_inner_test``
        adaptation steps on its support set and the query loss, logged as
        ``test/loss_{spk}`` (the weights are not changed).  On a mesh
        rank 0 runs it (with its tp group) and the others wait."""
        if not self._evaluates:
            self._barrier()
            return
        ts = self.train_state
        n = self.n_inner_test
        for itr_b, (speakers, support, query) in enumerate(
                self.dataloader_metatest.iter_stacked()):
            sup = unpack_task_batch(support, self.speaker_emb_type,
                                    self.device)
            qry = unpack_task_batch(query, self.speaker_emb_type,
                                    self.device)
            masks = self._draw_masks("metatest", epoch, itr_b, len(speakers),
                                     n + 1, sup)
            for i, spk in enumerate(speakers):
                qloss, _, _, _ = self._metatest_fn(
                    ts.params, ts.model_state,
                    tree_map(lambda x: x[i], sup),
                    tree_map(lambda x: x[i], qry), masks[i])
                self._heartbeat()
                loss_test = float(qloss)
                self.log_writer({f"test/loss_{spk}": (loss_test,
                                                      self.step_global)})
                print(f"| Epoch: {epoch}, itr: {self.step_global}, spk:{spk}"
                      f" ::  step loss: {loss_test:#.4}")
        self._barrier()


def main(args):
    from ..config import load_params

    params = load_params(os.path.join(args.params_path, "params.yml"))
    JointTrainer(**params).run()


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--params_path", type=str, required=True)
    main(parser.parse_args())
