"""What the two vocoder trainers share (``wavernn_train.py``,
``hifigan_train.py``): the experiment directory and its logs, the corpus
(``dataset_train`` through ``build_datasets``, its mels cached once) and
each item's waveform, loaded at the corpus rate and cut to the item's
silence-trim slice, the device, and the logs.

The run goes onto the GPU unless ``device: cpu`` is set in the params;
there every step is made reproducible (``utils/determinism.py``).  A
``parallel: {dp, task}`` block makes the run one rank of a
``torch.distributed`` world (``parallel/sharding.py::DpShard``; as the
acoustic trainers, from ``torchrun``'s variables when no group is up):
every rank draws the same global batch and takes its rows, the ranks'
gradients are averaged in one flat all-reduce, and rank 0 alone writes
the params, logs and checkpoints.  ``tp`` raises ``NotImplementedError``
through ``DpShard`` with the JAX package's text (the vocoders have no
tensor parallelism).
"""

from __future__ import annotations

import os

import numpy as np

from ..config import save_params
from ..dataloaders.loader_default import build_datasets
from ..ops.audio import load_wav
from ..parallel.mesh import init_from_env
from ..parallel.sharding import DpShard
from ..utils.backend import load_device
from ..utils.determinism import make_reproducible
from ..utils.logging_utils import MetricsLogger
from ..utils.paths import PathManager


class VocoderTrainer:
    method = ""          # the default ``method`` (the output sub-directory)

    def __init__(self, **params):
        self.params = params
        device = params.get("device")
        if params.get("parallel"):
            device = init_from_env(device) or device
        self.device = load_device(device or "cuda")
        make_reproducible(self.device)
        self.shard = DpShard.from_params(params)
        output_path = os.path.join(params["output_path"],
                                   params.get("method", self.method),
                                   params["experiment_name"])
        self.path_manager = PathManager(output_path)
        self.logger = None
        if self.is_writer:
            save_params(params, os.path.join(output_path, "params.yml"))
            self.logger = MetricsLogger(
                self.path_manager.logs_path,
                use_tensorboard=params.get("use_tensorboard", True))
        self.dataset = build_datasets(**params)[0]
        self._wav_cache: dict[str, np.ndarray | None] = {}
        self.step_global = 0

    def _wav(self, item) -> np.ndarray | None:
        """``item``'s waveform at the corpus rate, cut to the trim slice
        its mel was computed from (so that mel frame 0 and sample 0
        align); None when the file cannot be read.  Cached."""
        if item.item_id not in self._wav_cache:
            try:
                w = load_wav(item.audio_path, target_sample_rate=self.params[
                    "audio_params"]["sample_rate"])
                if item.trim is not None:
                    w = w[item.trim[0]: item.trim[1]]
            except (FileNotFoundError, TypeError):
                w = None
            self._wav_cache[item.item_id] = w
        return self._wav_cache[item.item_id]

    @property
    def is_writer(self) -> bool:
        """Whether this process writes the run's files (rank 0)."""
        return self.shard is None or self.shard.is_writer

    def _put(self, mels, wav):
        """A global host batch as this rank's rows on the device."""
        if self.shard is not None:
            mels, wav = self.shard.put_batch(mels, wav)
        return (mels.to(self.device, non_blocking=True),
                wav.to(self.device, non_blocking=True))

    def _mean_grads(self, grads: dict, n_rows: int) -> dict:
        """The ranks' gradients averaged (the batch's ``n_rows`` split
        over them); unchanged without a mesh."""
        if self.shard is None:
            return grads
        return self.shard.mean_grads(grads, n_rows)

    def _mean_metrics(self, metrics: dict, n_rows: int) -> dict:
        if self.shard is None:
            return metrics
        return self.shard.mean_metrics(metrics, n_rows)

    def _finish(self) -> None:
        """No rank leaves before rank 0's files are whole."""
        if self.shard is not None:
            self.shard.barrier()

    def _log(self, metrics: dict, step: int, n_steps: int) -> None:
        """Every ``tb_log_interval`` steps the metrics under ``train/``,
        every ``print_interval`` a line."""
        p = self.params
        if self.logger is not None and step % p.get("tb_log_interval",
                                                     10) == 0:
            self.logger.log_scalars({f"train/{k}": (float(v),
                                                    self.step_global)
                                     for k, v in metrics.items()})
        if step % p.get("print_interval", 10) == 0:
            print(f"| step {step}/{n_steps} :: " + " ".join(
                f"{k} {float(v):#.4}" for k, v in metrics.items()))
