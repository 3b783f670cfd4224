"""Training observability: JSONL metrics stream + optional TensorBoard
(the port's own copy of ``msa_tts_tpu/utils/logging_utils.py``).

The reference logs scalars/histograms through
``torch.utils.tensorboard.SummaryWriter`` (msa_tts/baseline.py:136-148).
We write an append-only ``metrics.jsonl`` (machine-readable, survives
without TB) and mirror to TensorBoard when available.
"""

from __future__ import annotations

import json
import os
import time
from datetime import datetime


class MetricsLogger:
    def __init__(self, logs_path: str, use_tensorboard: bool = True):
        # the reference stamps runs at minute resolution
        # (baseline.py:37-39); keep that name but uniquify when two runs
        # start in the same minute (sequential trainers in one process —
        # sweeps, continual streams, test suites) so their metrics.jsonl
        # and TB event files don't interleave in one directory
        stamp = datetime.now().strftime("%d_%m-%H_%M")
        self.run_dir = os.path.join(logs_path, stamp)
        n = 1
        while os.path.exists(self.run_dir):
            self.run_dir = os.path.join(logs_path, f"{stamp}.{n}")
            n += 1
        os.makedirs(self.run_dir, exist_ok=True)
        self.jsonl_path = os.path.join(self.run_dir, "metrics.jsonl")
        self._jsonl = open(self.jsonl_path, "a", buffering=1)
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=self.run_dir)
            except ImportError:     # no tensorboard package
                self._tb = None

    def log_scalars(self, logs: dict):
        """``logs``: {tag: (value, step)} — reference log_writer shape."""
        now = time.time()
        for tag, (value, step) in logs.items():
            value = float(value)
            self._jsonl.write(
                json.dumps(
                    {"t": now, "tag": tag, "value": value, "step": int(step)}
                )
                + "\n"
            )
            if self._tb is not None:
                self._tb.add_scalar(tag, value, int(step))

    def log_histograms(self, logs: dict):
        """``logs``: {tag: (values, step)}, to TensorBoard only."""
        for tag, (values, step) in logs.items():
            if self._tb is not None:
                import numpy as np

                self._tb.add_histogram(tag, np.asarray(values), int(step))

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
