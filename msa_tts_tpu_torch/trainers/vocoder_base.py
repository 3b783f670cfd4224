"""What the two vocoder trainers share (``wavernn_train.py``,
``hifigan_train.py``): the experiment directory and its logs, the corpus
(``dataset_train`` through ``build_datasets``, its mels cached once) and
each item's waveform, loaded at the corpus rate and cut to the item's
silence-trim slice, the device, and the logs.

The run goes onto the GPU unless ``device: cpu`` is set in the params;
there every step is made reproducible (``utils/determinism.py``).  A
``parallel`` block raises ``NotImplementedError``: multi-device training
is not ported.
"""

from __future__ import annotations

import os

import numpy as np

from ..config import save_params
from ..dataloaders.loader_default import build_datasets
from ..ops.audio import load_wav
from ..utils.backend import load_device
from ..utils.determinism import make_reproducible
from ..utils.logging_utils import MetricsLogger
from ..utils.paths import PathManager


class VocoderTrainer:
    method = ""          # the default ``method`` (the output sub-directory)

    def __init__(self, **params):
        self.params = params
        if params.get("parallel"):
            raise NotImplementedError(
                "parallel: multi-device training is not ported to the "
                "PyTorch package yet (ROADMAP.md item 22)")
        self.device = load_device(params.get("device", "cuda"))
        make_reproducible(self.device)
        output_path = os.path.join(params["output_path"],
                                   params.get("method", self.method),
                                   params["experiment_name"])
        self.path_manager = PathManager(output_path)
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

    def _log(self, metrics: dict, step: int, n_steps: int) -> None:
        """Every ``tb_log_interval`` steps the metrics under ``train/``,
        every ``print_interval`` a line."""
        p = self.params
        if step % p.get("tb_log_interval", 10) == 0:
            self.logger.log_scalars({f"train/{k}": (float(v),
                                                    self.step_global)
                                     for k, v in metrics.items()})
        if step % p.get("print_interval", 10) == 0:
            print(f"| step {step}/{n_steps} :: " + " ".join(
                f"{k} {float(v):#.4}" for k, v in metrics.items()))
