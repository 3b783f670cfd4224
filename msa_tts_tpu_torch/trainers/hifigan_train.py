"""HiFi-GAN vocoder trainer (counterpart of
``msa_tts_tpu/trainers/hifigan_train.py``).

The HiFi-GAN recipe: the generator against the Multi-Period and
Multi-Scale discriminators (``vocoders/hifigan_discriminators.py``) with
LSGAN losses, feature matching (×2) and the L1 of the "ap2" log-mels
(×45), two AdamWs (``lr``, default 2e-4; b1 0.8, b2 0.99, weight decay
0, as ``optax.adamw`` composes them).  A step updates the discriminators
on the detached generated audio, then the generator against the updated
discriminators; the generated audio is computed once, since the
generator's weights do not move in between.  The mel loss recomputes the
log-mel of the generated audio on the device (``ops.audio.
melspec_ap2_torch``).

Batches: ``segment_size`` (default 8192) samples from a hop-aligned start
in an item's waveform (cut to its silence-trim slice), and their "ap2"
log-mel computed on the host.  The params.yml holds a ``hifigan`` section
with the standard config keys and the corpus's ``audio_params`` in the
"ap2" vocabulary.  ``hifigan_<step>.ckpt`` holds ``generator``,
``discriminators``, ``opt_g``, ``opt_d`` and ``step`` in the JAX
package's layout.  Entry point::

    python -m msa_tts_tpu_torch.trainers.hifigan_train --params_path <dir>
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
from torch.func import functional_call

from ..ops.audio import melspec_ap2, melspec_ap2_torch
from ..optim import adamw, apply_updates
from ..utils.checkpoint import (
    load_checkpoint,
    opt_from_tree,
    opt_to_tree,
    restore_like,
    save_checkpoint,
)
from ..utils.convert import state_dict_to_tree, tree_to_state_dict
from ..vocoders.hifigan import Generator
from ..vocoders.hifigan_discriminators import (
    Discriminators,
    discriminator_loss,
    feature_loss,
    generator_loss,
)
from .vocoder_base import VocoderTrainer


def _leaf_grads(loss, params: dict) -> dict:
    return dict(zip(params, torch.autograd.grad(loss, list(params.values()))))


class HiFiGANTrainer(VocoderTrainer):
    method = "hifigan"

    def __init__(self, **params):
        super().__init__(**params)
        self.h = dict(params["hifigan"])
        ap = params["audio_params"]
        self.hop = ap["hop_size"]
        if int(np.prod(self.h["upsample_rates"])) != self.hop:
            raise ValueError(f"upsample_rates {self.h['upsample_rates']} "
                             f"do not multiply to hop_size {self.hop}")
        self.segment_size = int(params.get("segment_size", 8192))
        if self.segment_size % self.hop:
            raise ValueError("segment_size must be a multiple of hop_size")
        self.mel_frames = self.segment_size // self.hop
        gen = torch.Generator().manual_seed(int(params.get("model_seed", 0)))
        g_sd = Generator(self.h, ap["n_mels"], gen).state_dict()
        d_sd = Discriminators(gen).state_dict()
        with torch.device("meta"):
            self.gen = Generator(self.h, ap["n_mels"])
            self.disc = Discriminators()
        self.gen_params = {k: v.to(self.device) for k, v in g_sd.items()}
        self.disc_params = {k: v.to(self.device) for k, v in d_sd.items()}
        lr = float(params.get("lr", 2e-4))
        self.tx_g = adamw(lr, b1=0.8, b2=0.99, weight_decay=0.0)
        self.tx_d = adamw(lr, b1=0.8, b2=0.99, weight_decay=0.0)
        self.opt_g = self.tx_g.init(self.gen_params)
        self.opt_d = self.tx_d.init(self.disc_params)
        self._replicate()

    def _replicate(self) -> None:
        """Every rank's weights and optimizer states as rank 0's."""
        if self.shard is not None:
            (self.gen_params, self.disc_params, self.opt_g,
             self.opt_d) = self.shard.replicate(
                (self.gen_params, self.disc_params, self.opt_g, self.opt_d))

    # ------------------------------------------------------------- data
    def _sample_batch(self, rng: np.random.Generator, batch_size: int):
        """``(log-mels (B, n_mels, segment_size / hop), segments (B,
        segment_size))`` as host float32 tensors, drawn from ``rng`` in
        the JAX package's order."""
        ap = self.params["audio_params"]
        mels, wavs = [], []
        while len(mels) < batch_size:
            it = self.dataset.items[rng.integers(0, len(self.dataset.items))]
            wav = self._wav(it)
            if wav is None or len(wav) < self.segment_size + 1:
                continue
            start = int(rng.integers(0, len(wav) - self.segment_size))
            start = (start // self.hop) * self.hop
            seg = wav[start: start + self.segment_size]
            mels.append(melspec_ap2(seg[None, :], ap)[0][:, :self.mel_frames])
            wavs.append(seg)
        return (torch.from_numpy(np.stack(mels).astype(np.float32)),
                torch.from_numpy(np.stack(wavs).astype(np.float32)))

    # ------------------------------------------------------------- step
    @torch.no_grad()
    def _step(self, gen_params, disc_params, opt_g, opt_d, mels, wav,
              n_rows: int | None = None):
        """One discriminator and one generator update: ``(gen_params,
        disc_params, opt_g, opt_d, {loss_d, loss_g, loss_mel})``, the
        inputs untouched.  ``n_rows``: the global batch's rows when the
        batch is this rank's block of it (each update then takes the
        ranks' averaged gradients, the losses their average)."""
        ap = self.params["audio_params"]
        y = wav[:, None, :]
        gp = {k: v.detach().requires_grad_() for k, v in gen_params.items()}
        with torch.enable_grad():
            y_hat = functional_call(self.gen, gp, (mels,))[:, None, :]

            # ---- the discriminators, on the detached generated audio
            dp = {k: v.detach().requires_grad_()
                  for k, v in disc_params.items()}
            (r_p, g_p, _, _), (r_s, g_s, _, _) = functional_call(
                self.disc, dp, (y, y_hat.detach()))
            d_loss = (discriminator_loss(r_p, g_p)[0]
                      + discriminator_loss(r_s, g_s)[0])
            d_grads = _leaf_grads(d_loss, dp)
        if n_rows is not None:
            d_grads = self._mean_grads(d_grads, n_rows)
        updates, opt_d = self.tx_d.update(d_grads, opt_d, disc_params)
        disc_params = apply_updates(disc_params, updates)

        # ---- the generator, against the updated discriminators
        with torch.enable_grad():
            mel_g = melspec_ap2_torch(y_hat[:, 0, :], ap)
            mel_loss = (mel_g[:, :, :self.mel_frames] - mels).abs().mean() \
                * 45.0
            (_, g_p, f_rp, f_gp), (_, g_s, f_rs, f_gs) = functional_call(
                self.disc, disc_params, (y, y_hat))
            fm = feature_loss(f_rp, f_gp) + feature_loss(f_rs, f_gs)
            g_loss = (generator_loss(g_p)[0] + generator_loss(g_s)[0] + fm
                      + mel_loss)
            g_grads = _leaf_grads(g_loss, gp)
        if n_rows is not None:
            g_grads = self._mean_grads(g_grads, n_rows)
        updates, opt_g = self.tx_g.update(g_grads, opt_g, gen_params)
        gen_params = apply_updates(gen_params, updates)
        metrics = {"loss_d": d_loss.detach(), "loss_g": g_loss.detach(),
                   "loss_mel": mel_loss.detach()}
        if n_rows is not None:
            metrics = self._mean_metrics(metrics, n_rows)
        return gen_params, disc_params, opt_g, opt_d, metrics

    # -------------------------------------------------------------- run
    def run(self) -> dict:
        p = self.params
        rng = np.random.default_rng(p.get("train_seed", 0))
        batch_size = int(p.get("batch_size", 16))
        n_steps = int(p.get("n_steps", 1000))
        metrics = {}
        for step in range(1, n_steps + 1):
            mels, wav = self._put(*self._sample_batch(rng, batch_size))
            (self.gen_params, self.disc_params, self.opt_g, self.opt_d,
             metrics) = self._step(self.gen_params, self.disc_params,
                                   self.opt_g, self.opt_d, mels, wav,
                                   n_rows=batch_size)
            self.step_global += 1
            self._log(metrics, step, n_steps)
            if step % p.get("ckpt_save_step_interval", 500) == 0:
                self._save()
        self._save()
        self._finish()
        return {k: float(v) for k, v in metrics.items()}

    # ------------------------------------------------------ checkpoints
    def _payload(self) -> dict:
        return {
            "generator": state_dict_to_tree(self.gen_params),
            "discriminators": state_dict_to_tree(self.disc_params),
            "opt_g": opt_to_tree(self.opt_g, self.gen_params.keys(),
                                 state_dict_to_tree),
            "opt_d": opt_to_tree(self.opt_d, self.disc_params.keys(),
                                 state_dict_to_tree),
            "step": self.step_global,
        }

    def _save(self) -> str:
        path = os.path.join(self.path_manager.checkpoints_path,
                            f"hifigan_{self.step_global}.ckpt")
        if self.is_writer:
            save_checkpoint(path, self._payload())
        return path

    def restore(self, path: str) -> None:
        """Resume from a ``hifigan_<step>.ckpt`` of either package."""
        raw = load_checkpoint(path)
        self.gen_params = restore_like(
            self.gen_params, tree_to_state_dict(raw["generator"]))
        self.disc_params = restore_like(
            self.disc_params, tree_to_state_dict(raw["discriminators"]))
        self.opt_g = opt_from_tree(self.opt_g, raw["opt_g"],
                                   self.gen_params.keys(), tree_to_state_dict)
        self.opt_d = opt_from_tree(self.opt_d, raw["opt_d"],
                                   self.disc_params.keys(),
                                   tree_to_state_dict)
        self.step_global = int(raw["step"])
        self._replicate()


def main(args):
    from ..config import load_params

    params = load_params(os.path.join(args.params_path, "params.yml"))
    HiFiGANTrainer(**params).run()


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--params_path", type=str, required=True)
    main(parser.parse_args())
