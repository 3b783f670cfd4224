"""Continual learning with Experience Replay and a speaker-similarity
regularizer (counterpart of ``msa_tts_tpu/trainers/continual_er_reg.py``).

The cosine similarity of the new speaker's d-vector to the mean d-vector
of the speakers seen before it scales one of three regularizers, chosen
by ``regularization_method`` (the shipped configs spell it
``regularizaton_method``; both are read):

  * ``buffer_replicate``: each item entering the buffer is repeated
    ``buffer_replicate_factor`` times;
  * ``adaptive_weightdecay``: the optimizer's (coupled, L2) weight decay
    is ``weightdecay_value`` · (1 − similarity);
  * ``adaptive_weightclipping``: the clip threshold is scaled by the
    similarity for the whole task.

Entry point::

    python -m msa_tts_tpu_torch.trainers.continual_er_reg --params_path <dir>
"""

from __future__ import annotations

import argparse
import copy
import os

import numpy as np

from ..dataloaders.metafile import load_speaker_embeddings
from .continual_er import ExperienceReplayTrainer
from .train_state import make_optimizer


def get_similarity(vec1, vec_list, sim_type: str = "cosine") -> float:
    """The mean similarity of ``vec1`` to each vector of ``vec_list``."""
    total = 0.0
    for vec2 in vec_list:
        if sim_type == "dot_prod":
            sim = float(np.dot(vec1, vec2))
        elif sim_type == "cosine":
            sim = float(np.dot(vec1, vec2)
                        / (np.linalg.norm(vec1) * np.linalg.norm(vec2)))
        elif sim_type == "l2_dist":
            # sum(sqrt(x²)) = sum(|x|) is an L1 distance, not L2: kept as
            # the reference computes it, whose regularization strength
            # it sets
            sim = float(np.sum(np.sqrt((vec1 - vec2) ** 2)))
        else:
            raise ValueError(sim_type)
        total += sim
    return total / float(len(vec_list))


def get_spk_similarity(spk_emb: dict, spk_so_far: list[str],
                       spk: str) -> float:
    """Cosine similarity of ``spk``'s d-vector to the mean of the
    d-vectors of ``spk_so_far``."""
    vec1 = np.asarray(spk_emb[spk])
    prev = np.mean(np.stack([np.asarray(spk_emb[s]) for s in spk_so_far]),
                   axis=0)
    return get_similarity(vec1, [prev], "cosine")


class ExperienceReplayRegTrainer(ExperienceReplayTrainer):
    def __init__(self, **params):
        self._reg_method = params.get("regularization_method",
                                      params.get("regularizaton_method"))
        if self._reg_method is None:
            raise ValueError("regularization_method not set")
        super().__init__(**params)
        self.spk_emb_dict = load_speaker_embeddings(
            params["dataset_train"]["dataset_path"])
        self._spk_similarity = 1.0
        self._base_clip_thresh = float(params.get("grad_clip_thresh", 1.0))

    def _new_buffer_items(self, items):
        new = super()._new_buffer_items(items)
        if self._reg_method == "buffer_replicate":
            return new * int(self.params.get("buffer_replicate_factor", 1))
        return new

    def _reset_optimizer(self, speaker: str | None = None):
        # the similarity to every speaker seen before this one
        prev = [s for s in self.speakers_so_far if s != speaker]
        if speaker is not None and prev:
            self._spk_similarity = get_spk_similarity(self.spk_emb_dict,
                                                      prev, speaker)
            print(f"Speaker {speaker}: similarity to previous speakers ="
                  f" {self._spk_similarity:.4f}")
        else:
            self._spk_similarity = 1.0
        optim_params = copy.deepcopy(self.params["optim"])
        sim = self._spk_similarity
        if self._reg_method == "adaptive_weightdecay" and sim != 1.0:
            print("Changing weight decay")
            optim_params["weight_decay"] = (
                self.params["weightdecay_value"] * (1.0 - sim))
        self.tx = make_optimizer(optim_params)
        self.train_state = self.train_state._replace(
            opt_state=self.tx.init(self.train_state.params))
        # the step reads grad_clip_thresh when it runs: set the task's
        if (self._reg_method == "adaptive_weightclipping" and sim != 1.0
                and self.params.get("clip_grad_norm", False)):
            self.params["grad_clip_thresh"] = sim * self._base_clip_thresh
        else:
            self.params["grad_clip_thresh"] = self._base_clip_thresh


def main(args):
    from ..config import load_params

    params = load_params(os.path.join(args.params_path, "params.yml"))
    ExperienceReplayRegTrainer(**params).run()


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--params_path", type=str, required=True)
    main(parser.parse_args())
