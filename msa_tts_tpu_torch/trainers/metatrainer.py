"""Shared scaffolding for the meta-trainers (counterpart of
``msa_tts_tpu/trainers/metatrainer.py``): the meta-train and meta-test
episodic loaders, the inner and outer optimizers, the per-pass loss,
the episode stream and the meta-test phase.

Dropout masks.  The JAX package draws each pass's masks from a key
schedule (per step ``fold_in(k_train, itr_b)``, split per task, each
task's key split into the adaptation's and the query pass's).  Here
:meth:`TrainerBase._draw_masks` draws them on the device from a
``torch.Generator`` seeded by the run's ``train_seed``, the phase, the
epoch and the step, so a resumed run draws what an unbroken one would;
a test replaces that one method to inject the JAX package's masks.
"""

from __future__ import annotations

import os

import torch

from ..dataloaders.loader_meta import get_dataloader as get_dataloader_meta
from ..dataloaders.loader_meta import unpack_task_batch
from ..meta.maml import make_metatest_fn
from ..ops.metrics import mcd_batch
from .base import TrainerBase
from .train_state import make_optimizer


class MetaTrainer(TrainerBase):
    def _init_dataloaders(self):
        print("\nInitializing meta-train loaders")
        self.dataloader_metatrain, logs_mtr = get_dataloader_meta(
            "metatrain", **self.params)
        print("\nInitializing meta-test loaders")
        self.dataloader_metatest, logs_mts = get_dataloader_meta(
            "metatest", **self.params)
        if not self.is_writer:
            return
        with open(os.path.join(self.path_manager.output_path,
                               "dataset_details.txt"), "w") as f:
            f.write("Meta-Train:\n\n" + logs_mtr
                    + "\n\n\nMeta-Test:\n\n" + logs_mts)

    def _num_speakers(self) -> int:
        return len(self.dataloader_metatrain.ds_support.speaker_to_id)

    def _meta_loss_fn(self):
        def loss_fn(params, model_state, batch, masks):
            loss, (_, new_ms) = self._loss_for_batch(params, model_state,
                                                     batch, masks)
            return loss, new_ms

        return loss_fn

    def _init_criterion_optimizer(self):
        super()._init_criterion_optimizer()
        # the outer optimizer replaces the base `optim`
        self.outer_tx = make_optimizer(
            self.params.get("optim_outer", self.params["optim"]))
        self.inner_tx = make_optimizer(self.inner_optim_cfg)
        self.train_state = self.train_state._replace(
            opt_state=self.outer_tx.init(self.train_state.params))
        self.n_inner_test = int(self.params.get("n_inner_test", 1))
        self._metatest_fn = make_metatest_fn(
            self._meta_loss_fn(), self.inner_tx, self.n_inner_test)

    # --------------------------------------------------------- episodes
    def _episodes(self, loader):
        """``(speakers, support, query)`` with each episode on the device,
        the next one's upload started before this one is yielded."""
        def put(ep):
            speakers, support, query = ep
            return (speakers,
                    unpack_task_batch(support, self.speaker_emb_type,
                                      self.device),
                    unpack_task_batch(query, self.speaker_emb_type,
                                      self.device))

        it = loader.iter_stacked()
        nxt = next(it, None)
        nxt = put(nxt) if nxt is not None else None
        while nxt is not None:
            cur = nxt
            ep = next(it, None)
            nxt = put(ep) if ep is not None else None
            yield cur

    # --------------------------------------------------------- metatest
    def _metatest(self, epoch: int):
        """Per task of each meta-test batch: ``n_inner_test`` adaptation
        steps on the support set, the query loss, and the MCD of a
        teacher-forced forward with the adapted weights (logged as
        ``test/loss_{spk}`` and ``test/mcd_{spk}``).  It touches no
        training state: on a mesh rank 0 runs it (with its tp group)
        and the others wait."""
        if not self._evaluates:
            self._barrier()
            return
        ts = self.train_state
        n = self.n_inner_test
        for itr_b, (speakers, support, query) in enumerate(
                self._episodes(self.dataloader_metatest)):
            masks = self._draw_masks("test", epoch, itr_b, len(speakers),
                                     n + 2, support)
            for i, spk in enumerate(speakers):
                sup = {k: v[i] for k, v in support.items()}
                qry = {k: v[i] for k, v in query.items()}
                qloss, adapted, ms, _ = self._metatest_fn(
                    ts.params, ts.model_state, sup, qry, masks[i][:n + 1])
                with torch.no_grad(), self._tp_scope():
                    # float32 whatever compute_dtype, as the JAX package
                    outs, _ = torch.func.functional_call(
                        self.model, {**adapted, **ms},
                        (qry["inputs"], qry["input_lengths"],
                         qry["melspecs"], qry["melspec_lengths"],
                         qry["speaker_vecs"], masks[i][n + 1]))
                self._heartbeat()
                loss_test = float(qloss)
                mcd = mcd_batch(outs[1].transpose(1, 2),
                                qry["melspecs"].transpose(1, 2),
                                qry["melspec_lengths"])
                if (self.params.get("plot_examples", True)
                        and self.is_writer):
                    from ..utils.plot import plot_spec_attn_example

                    idx = -1
                    plot_spec_attn_example(
                        outs[1][idx].cpu().numpy(),
                        qry["melspecs"][idx].cpu().numpy(),
                        outs[3][idx].detach().cpu().numpy(),
                        os.path.join(self.path_manager.examples_path,
                                     f"metatest_epoch-{epoch}_{spk}"),
                        length_mel=int(qry["melspec_lengths"][idx]),
                        length_attn=int(qry["input_lengths"][idx]),
                    )
                self.log_writer({
                    f"test/loss_{spk}": (loss_test, self.step_global),
                    f"test/mcd_{spk}": (mcd, self.step_global),
                })
                print(f"| Epoch: {epoch}, itr: {self.step_global}, "
                      f"spk:{spk} ::  step loss: {loss_test:#.4} | "
                      f"mcd: {mcd:#.4} ")
        self._barrier()
