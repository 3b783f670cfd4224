"""Shared scaffolding of the continual (speaker-stream) trainers
(counterpart of ``msa_tts_tpu/trainers/continual_base.py``).

The reference's protocol: shuffle the speaker list with
``speaker_seed`` (``random.Random``), optionally pre-train on the first
``num_initial_speakers``, then for each speaker of the stream: a fresh
optimizer, up to ``n_max_epochs`` epochs with early stopping on the
task's test loss, a ``best_{itr}_{speaker}.ckpt`` checkpoint, and a test
of every speaker seen so far (the backward-transfer matrix, pickled to
``cumutest.pkl``).

The corpus is read and its features computed once; a task's loaders are
views over the cached items.  The replay buffer is a list of items drawn
with a seeded numpy generator.  After every task the whole stream state
(position, buffer, the buffer's generator, the cumulative-test matrix,
the train state with the optimizer) goes into one atomic file, and
``resume: true`` restarts at the next task bit for bit.  In place of the
JAX package's key, that file holds the seed of the port's mask seam
(``TrainerBase._draw_step_masks``, keyed on the task and step indices).
"""

from __future__ import annotations

import copy
import dataclasses
import os
import pickle
import random

import numpy as np

from ..dataloaders.dataset import Item, TTSDataset
from ..dataloaders.loader_default import DataLoader
from ..dataloaders.metafile import parse_metafile, split_speakers
from ..utils.checkpoint import (
    AsyncCheckpointer,
    deserialize_payload,
    serialize_payload,
    wait_all_checkpoints,
)
from .base import TrainerBase
from .train_state import make_optimizer


class ContinualTrainerBase(TrainerBase):
    def __init__(self, **params):
        self.all_speakers = list(params["dataset_train"]["speakers_list"])
        random.Random(params.get("speaker_seed", 0)).shuffle(
            self.all_speakers)
        self._buffer_rng = np.random.default_rng(
            params.get("buffer_seed", params.get("speaker_seed", 0)))
        super().__init__(**params)

    # ------------------------------------------------------------ data
    def _init_dataloaders(self):
        """Read the corpus once; per-task loaders are views over it."""
        params = self.params
        ds = params["dataset_train"]
        utts = parse_metafile(os.path.join(ds["dataset_path"],
                                           ds["meta_file"]))
        splits, logs = split_speakers(
            utts, self.all_speakers,
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
        self.dataset_train_all = TTSDataset(splits, "train", **common)
        self.dataset_test_all = TTSDataset(splits, "test", **common)
        if not self.is_writer:
            return
        with open(os.path.join(self.path_manager.output_path,
                               "dataset_details.txt"), "w") as f:
            f.write("Train:\n\n" + logs)

    def _num_speakers(self) -> int:
        # the reference pins num_speakers to 1 for a stream: the speaker
        # comes in through its d-vector
        return 1

    def _task_items(self, speakers: list[str], mode: str) -> list[Item]:
        ds = self.dataset_train_all if mode == "train" else (
            self.dataset_test_all)
        return [it for it in ds.items if it.speaker in speakers]

    def _make_loader(self, items: list[Item], *, batch_size=None,
                     shuffle=True, seed=0) -> DataLoader:
        params = self.params
        return DataLoader(
            items,
            batch_size=batch_size or params["dataset_train"]["batch_size"],
            shuffle=shuffle, seed=seed,
            reduction_factor=params["model"]["n_frames_per_step"],
            text_pad_multiple=params.get("text_pad_multiple", 16),
            mel_pad_multiple=params.get("mel_pad_multiple", 32),
        )

    def _sample_items(self, items: list[Item], n: int) -> list[Item]:
        """``n`` items drawn without replacement by the buffer's
        generator."""
        n = min(n, len(items))
        idx = self._buffer_rng.permutation(len(items))[:n]
        return [items[i] for i in idx]

    # ---------------------------------------------------------- training
    def _train_task(self, speaker: str, spk_itr: int,
                    items: list[Item]) -> bool:
        """The task's epoch loop with early stopping on its test loss;
        False when preempted before the task's end."""
        params = self.params
        loader = self._make_loader(items, seed=spk_itr)
        test_loader = self._make_loader(self._task_items([speaker], "test"),
                                        shuffle=False, seed=spk_itr)
        losses: list[float] = []
        last = None
        for epoch in range(1, params.get("n_max_epochs", 1) + 1):
            for itr, b in enumerate(loader, 1):
                if b.inputs.shape[0] == 1:
                    continue        # the reference skips singleton batches
                if self._preempt_requested():
                    return False
                batch = self._unpack_batch(b)
                masks = self._draw_step_masks(
                    "task", (spk_itr, self.step_global), batch)
                self.train_state, metrics, outs = self._task_step(
                    self.train_state, batch, masks)
                self._heartbeat()
                loss, mcd = float(metrics["loss"]), float(metrics["mcd"])
                print(f"|Speaker {spk_itr}/{len(self.all_speakers)}: Epoch "
                      f"{epoch} - {self.step_global}, itr {itr}/"
                      f"{len(loader)} ::  step loss: {loss:#.4} | mcd: "
                      f"{mcd:#.4}")
                if self.step_global % params.get("tb_log_interval", 10) == 0:
                    self.log_writer({"train/loss": (loss, self.step_global),
                                     "train/mcd": (mcd, self.step_global)})
                self.step_global += 1
                last = (batch, outs)
            if epoch % params.get("test_interval", 1) == 0:
                losses.append(self._test_task(epoch, speaker, spk_itr,
                                              test_loader))
                k = params.get("early_stopping_steps", 3)
                if (params.get("early_stopping", False) and len(losses) > k
                        and losses[-k - 1] < min(losses[-k:])):
                    print("Early stopping")
                    break
        if last is not None and params.get("plot_examples", True):
            self._plot_example(last, f"{spk_itr}_train-spk{speaker}")
        return True

    def _task_step(self, state, batch, masks):
        """The optimisation step of the current task (EWC adds its
        penalty)."""
        return self._train_step(state, batch, masks)

    def _test_task(self, epoch: int, speaker: str, spk_itr: int,
                   test_loader) -> float:
        loss_total = mcd_total = 0.0
        n = 0
        for itr, b in enumerate(test_loader, 1):
            batch = self._unpack_batch(b)
            masks = self._draw_step_masks("task_test", (spk_itr, itr), batch)
            self.train_state, metrics, _ = self._eval_step(
                self.train_state, batch, masks)
            self._heartbeat()
            loss_total += float(metrics["loss"])
            mcd_total += float(metrics["mcd"])
            n += 1
        if n == 0:
            return float("inf")
        loss_total /= n
        mcd_total /= n
        self.log_writer({
            f"test/loss_{speaker}": (loss_total, self.step_global),
            f"test/mcd_{speaker}": (mcd_total, self.step_global),
        })
        print(f"| Epoch: {epoch}, itr: {self.step_global} ::  loss_total:"
              f" {loss_total:#.4} | mcd_total: {mcd_total:#.4} ")
        return loss_total

    def _test_cumulative(self, speaker: str, spk_itr: int) -> None:
        """Every speaker seen so far, tested after task ``spk_itr``; the
        matrix goes to ``cumutest.pkl``."""
        print("-" * 20, "Cumulative Testing")
        self.cumutest_dict[spk_itr] = {"speaker": speaker, "losses": {}}
        for test_speaker in self.speakers_so_far:
            loader = self._make_loader(
                self._task_items([test_speaker], "test"), shuffle=False)
            loss_total, n, last = 0.0, 0, None
            for itr, b in enumerate(loader, 1):
                batch = self._unpack_batch(b)
                masks = self._draw_step_masks("cumulative", (spk_itr, itr),
                                              batch)
                self.train_state, metrics, outs = self._eval_step(
                    self.train_state, batch, masks)
                self._heartbeat()
                loss_total += float(metrics["loss"])
                n += 1
                last = (batch, outs)
            loss_total = loss_total / max(n, 1)
            print(f"| Speaker: {test_speaker}, itr: {self.step_global} ::"
                  f"  loss_total: {loss_total:#.4}")
            self.cumutest_dict[spk_itr]["losses"][test_speaker] = loss_total
            if last is not None and self.params.get("plot_examples", True):
                self._plot_example(last, f"cumTest_{spk_itr}_spk-{speaker}"
                                 f"_to_spk-{test_speaker}")
        if self.is_writer:
            with open(os.path.join(self.path_manager.examples_path,
                                   "cumutest.pkl"), "wb") as f:
                pickle.dump(self.cumutest_dict, f)
        print("-" * 30 + "\n")

    # ------------------------------------------------------------ resume
    _STREAM_STATE = "stream_state.pkl"

    def _stream_extras(self) -> dict:
        """The method's own stream state: the replay buffer as (item_id,
        soft_mel) pairs, bound to the cached items again on restore
        (EWC's Fisher is recomputed at a task's start from the buffer)."""
        if hasattr(self, "buffer"):
            return {"buffer": [(it.item_id, it.soft_mel)
                               for it in self.buffer]}
        return {}

    def _restore_stream_extras(self, extras: dict) -> None:
        if "buffer" in extras:
            by_id = {it.item_id: it for it in self.dataset_train_all.items}
            self.buffer = [
                by_id[i] if soft is None else dataclasses.replace(
                    by_id[i], soft_mel=np.asarray(soft))
                for i, soft in extras["buffer"]]

    def _save_stream_state(self, next_spk_itr: int) -> None:
        ckpt = self._ckpt_payload()
        if not self.is_writer:
            return
        payload = {
            "next_spk_itr": next_spk_itr,
            "all_speakers": list(self.all_speakers),
            "speakers_so_far": list(self.speakers_so_far),
            "cumutest_dict": copy.deepcopy(self.cumutest_dict),
            "step_global": self.step_global,
            "rng": self._mask_seed,
            "buffer_rng": copy.deepcopy(self._buffer_rng),
            "extras": self._stream_extras(),
        }
        path = os.path.join(self.path_manager.checkpoints_path,
                            self._STREAM_STATE)
        # one atomic file: the checkpoint rides inside the stream pickle
        if self.params.get("async_checkpoint", True):
            if self._async_ckpt is None:
                self._async_ckpt = AsyncCheckpointer()
            self._async_ckpt.save_pickle(path, payload,
                                         ckpt_payload=ckpt)
            return
        payload["ckpt"] = serialize_payload(ckpt)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(payload, f)
        os.replace(tmp, path)

    def _try_resume(self) -> int | None:
        """The next task's index when resuming, else None."""
        if not self.params.get("resume", False):
            return None
        wait_all_checkpoints()
        self._barrier()
        path = os.path.join(self.path_manager.checkpoints_path,
                            self._STREAM_STATE)
        if not os.path.exists(path):
            print("resume requested but no stream state found; "
                  "starting fresh")
            return None
        with open(path, "rb") as f:
            d = pickle.load(f)
        if d["all_speakers"] != self.all_speakers:
            raise ValueError(
                "stream state speaker order does not match this config "
                "(speaker_seed / speakers_list changed?)")
        self.restore_raw(deserialize_payload(d["ckpt"]))
        self.step_global = int(d["step_global"])
        self.speakers_so_far = list(d["speakers_so_far"])
        self.cumutest_dict = dict(d["cumutest_dict"])
        self._mask_seed = int(d["rng"])
        self._buffer_rng = d["buffer_rng"]
        self._restore_stream_extras(d["extras"])
        print(f"Resuming continual stream at task {d['next_spk_itr']} "
              f"(step {self.step_global})")
        return int(d["next_spk_itr"])

    # ------------------------------------------------------------- hooks
    def _reset_optimizer(self, speaker: str | None = None):
        """A fresh optimizer per task, as the reference's."""
        self.tx = make_optimizer(self.params["optim"])
        self.train_state = self.train_state._replace(
            opt_state=self.tx.init(self.train_state.params))

    def _task_train_items(self, speaker: str, spk_itr: int) -> list[Item]:
        """The items task ``spk_itr`` trains on (method-specific)."""
        raise NotImplementedError

    def _initial_task_items(self, speakers: list[str]) -> list[Item]:
        """The items of the initial phase (task 0 when
        ``num_initial_speakers`` > 0); a method seeds its buffer here."""
        return self._task_items(speakers, "train")

    # --------------------------------------------------------------- run
    def run(self):
        self.step_global = 0
        self.speakers_so_far: list[str] = []
        self.cumutest_dict: dict = {}
        num_initial = self.params.get("num_initial_speakers", 0)
        start_itr = self._try_resume()
        self._start_watchdog()
        try:
            if start_itr is None:
                start_itr = num_initial
                if num_initial > 0:
                    initial = self.all_speakers[:num_initial]
                    if not self._train_task(initial[0], 0,
                                            self._initial_task_items(
                                                initial)):
                        print("[preemption] initial-finetune phase "
                              "abandoned; resume restarts it")
                        return
                    self._save_checkpoint(f"best_0_{initial[0]}.ckpt")
                    self._save_stream_state(num_initial)
            for spk_itr, speaker in enumerate(self.all_speakers, num_initial):
                if spk_itr < start_itr:
                    continue
                if self._preempt_requested():
                    print(f"[preemption] stopping before task {spk_itr} "
                          f"({speaker}); resume continues there")
                    break
                self.speakers_so_far.append(speaker)
                self._reset_optimizer(speaker)
                items = self._task_train_items(speaker, spk_itr)
                if not self._train_task(speaker, spk_itr, items):
                    # the state saved after the previous task stands;
                    # resume restarts this task and replays it
                    print(f"[preemption] task {spk_itr} ({speaker}) "
                          "abandoned mid-stream; resume restarts it")
                    break
                self._save_checkpoint(f"best_{spk_itr}_{speaker}.ckpt")
                self._test_cumulative(speaker, spk_itr)
                self._save_stream_state(spk_itr + 1)
        finally:
            self._stop_watchdog()
            self._finish_checkpoints()
