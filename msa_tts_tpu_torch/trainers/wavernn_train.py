"""WaveRNN vocoder trainer (counterpart of
``msa_tts_tpu/trainers/wavernn_train.py``).

Teacher-forced mixture-of-logistics (or Gaussian) training on (mel
window, waveform segment) pairs drawn from the corpus of
``dataset_train``: each pair a window of an item's cached mel (the
``audio_processor`` frontend, computed once when the dataset is built)
and the ``seq_len + 1`` samples under it.  The conditioning network's
batch norms normalise with their (initial) running statistics: fixed
preprocessing, as in the JAX package, whatever the module's mode.  Adam
(``lr``, default 1e-4) through ``optim.make_optimizer``.

The weights live in ``model_params`` (name → float32 tensor on the
device, under the reference ``state_dict`` names) and the batch norms'
buffers in ``model_state``; the step runs a weightless meta-device
``WaveRNNModel`` on them through ``torch.func.functional_call``, its
GRUs as ``nn.GRU`` (cuDNN on a GPU).  ``wavernn_<step>.ckpt`` holds
``params``, ``model_state``, ``opt_state`` and ``step`` in the JAX
package's layout, and :meth:`WaveRNNTrainer.restore` reads either
package's.  Entry point::

    python -m msa_tts_tpu_torch.trainers.wavernn_train --params_path <dir>
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
from torch.func import functional_call

from ..optim import apply_updates, make_optimizer
from ..utils.checkpoint import (
    load_checkpoint,
    opt_from_tree,
    opt_to_tree,
    restore_like,
    save_checkpoint,
)
from ..utils.convert import (
    wavernn_jax_from_state_dict,
    wavernn_state_dict_from_jax,
)
from ..vocoders.wavernn import (
    WaveRNNModel,
    config_from_params,
    discretized_mix_logistic_loss,
    gaussian_loss,
)
from .vocoder_base import VocoderTrainer


class WaveRNNTrainer(VocoderTrainer):
    method = "wavernn"

    def __init__(self, **params):
        super().__init__(**params)
        self.cfg = config_from_params(**params)
        self.seq_len = int(params.get("seq_len", 1280))
        if self.seq_len % self.cfg.hop_length:
            raise ValueError("seq_len must be a multiple of hop_length")
        self.mel_win = self.seq_len // self.cfg.hop_length + 2 * self.cfg.pad
        gen = torch.Generator().manual_seed(int(params.get("model_seed", 0)))
        sd = WaveRNNModel(self.cfg, gen).state_dict()
        with torch.device("meta"):
            self.model = WaveRNNModel(self.cfg)
        self.param_names = [k for k, _ in self.model.named_parameters()]
        self.model_params = {k: sd[k].to(self.device)
                             for k in self.param_names}
        self.model_state = {k: v.to(self.device) for k, v in sd.items()
                            if k not in self.model_params}
        self.tx = make_optimizer({"optimizer_type": "Adam",
                                  "lr": float(params.get("lr", 1e-4))})
        self.opt_state = self.tx.init(self.model_params)
        if self.shard is not None:
            self.model_params, self.opt_state = self.shard.replicate(
                (self.model_params, self.opt_state))

    # ------------------------------------------------------------- data
    def _sample_batch(self, rng: np.random.Generator, batch_size: int):
        """A batch of ``(mel windows (B, n_mels, seq_len / hop + 2·pad),
        waveform segments (B, seq_len + 1))`` as host float32 tensors,
        drawn from ``rng`` in the JAX package's order: an item, then (if
        its waveform loaded and its mel is long enough) a start frame."""
        cfg = self.cfg
        mels, wavs = [], []
        while len(mels) < batch_size:
            it = self.dataset.items[rng.integers(0, len(self.dataset.items))]
            wav = self._wav(it)
            if wav is None:
                continue
            n_frames = it.mel.shape[1]
            if n_frames <= self.mel_win + 1:
                continue
            start = int(rng.integers(cfg.pad,
                                     n_frames - self.mel_win + cfg.pad))
            seg = wav[start * cfg.hop_length:
                      start * cfg.hop_length + self.seq_len + 1]
            if len(seg) < self.seq_len + 1:
                continue
            mels.append(it.mel[:, start - cfg.pad:
                               start - cfg.pad + self.mel_win])
            wavs.append(seg)
        return (torch.from_numpy(np.stack(mels)),
                torch.from_numpy(np.stack(wavs, dtype=np.float32)))

    # ------------------------------------------------------------- step
    def _loss(self, params: dict, mels, wav):
        logits = functional_call(self.model, {**params, **self.model_state},
                                 (wav[:, :-1], mels))
        y = wav[:, 1:, None]
        if self.cfg.mode == "MOL":
            return discretized_mix_logistic_loss(logits, y)
        return gaussian_loss(logits, y)

    def _grads(self, params: dict, mels, wav):
        """``(loss, {name: gradient})`` at ``params``."""
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        with torch.enable_grad():
            loss = self._loss(p, mels, wav)
            grads = torch.autograd.grad(loss, list(p.values()))
        return loss.detach(), dict(zip(p, grads))

    @torch.no_grad()
    def _step(self, params: dict, opt_state, mels, wav,
              n_rows: int | None = None):
        """One Adam step on a batch on the device: ``(params, opt_state,
        loss)``, the inputs untouched.  ``n_rows``: the global batch's
        rows when ``mels`` / ``wav`` are this rank's block of it (the
        ranks' gradients and losses are then averaged)."""
        loss, grads = self._grads(params, mels, wav)
        if n_rows is not None:
            grads = self._mean_grads(grads, n_rows)
            loss = self._mean_metrics({"nll": loss}, n_rows)["nll"]
        updates, opt_state = self.tx.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, loss

    # -------------------------------------------------------------- run
    def run(self) -> float:
        p = self.params
        rng = np.random.default_rng(p.get("train_seed", 0))
        batch_size = int(p.get("batch_size", 16))
        n_steps = int(p.get("n_steps", 1000))
        loss = float("nan")
        for step in range(1, n_steps + 1):
            mels, wav = self._put(*self._sample_batch(rng, batch_size))
            self.model_params, self.opt_state, loss_t = self._step(
                self.model_params, self.opt_state, mels, wav,
                n_rows=batch_size)
            loss = float(loss_t)
            self.step_global += 1
            self._log({"nll": loss}, step, n_steps)
            if step % p.get("ckpt_save_step_interval", 500) == 0:
                self._save()
        self._save()
        self._finish()
        return loss

    # ------------------------------------------------------ checkpoints
    def _params_tree(self, d: dict) -> dict:
        return wavernn_jax_from_state_dict(d, self.cfg)[0]

    def _payload(self) -> dict:
        params, state = wavernn_jax_from_state_dict(
            {**self.model_params, **self.model_state}, self.cfg)
        return {"params": params, "model_state": state,
                "opt_state": opt_to_tree(self.opt_state,
                                         set(self.param_names),
                                         self._params_tree),
                "step": self.step_global}

    def _save(self) -> str:
        path = os.path.join(self.path_manager.checkpoints_path,
                            f"wavernn_{self.step_global}.ckpt")
        if self.is_writer:
            save_checkpoint(path, self._payload())
        return path

    def restore(self, path: str) -> None:
        """Resume from a ``wavernn_<step>.ckpt`` of either package: the
        weights, batch-norm statistics, Adam's state and the step."""
        raw = load_checkpoint(path)

        def from_tree(tree):
            return wavernn_state_dict_from_jax(tree, raw["model_state"],
                                               self.cfg)

        sd = from_tree(raw["params"])
        self.model_params = restore_like(
            self.model_params, {k: sd[k] for k in self.model_params})
        self.model_state = restore_like(
            self.model_state, {k: sd[k] for k in self.model_state})
        self.opt_state = opt_from_tree(self.opt_state, raw["opt_state"],
                                       set(self.param_names), from_tree)
        self.step_global = int(raw["step"])
        if self.shard is not None:
            self.model_params, self.opt_state = self.shard.replicate(
                (self.model_params, self.opt_state))


def main(args):
    from ..config import load_params

    params = load_params(os.path.join(args.params_path, "params.yml"))
    WaveRNNTrainer(**params).run()


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--params_path", type=str, required=True)
    main(parser.parse_args())
