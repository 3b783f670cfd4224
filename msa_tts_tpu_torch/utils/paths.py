"""Experiment output directory management (the port's own copy of
``msa_tts_tpu/utils/paths.py``; reference:
msa_tts/utils/path_manager.py — creates ``checkpoints/ logs/ examples/
inference/`` under the experiment root)."""

from __future__ import annotations

import os


class PathManager:
    def __init__(self, output_path: str):
        self.output_path = output_path
        self.checkpoints_path = os.path.join(output_path, "checkpoints")
        self.logs_path = os.path.join(output_path, "logs")
        self.examples_path = os.path.join(output_path, "examples")
        self.inference_path = os.path.join(output_path, "inference")
        for p in (
            self.output_path,
            self.checkpoints_path,
            self.logs_path,
            self.examples_path,
            self.inference_path,
        ):
            os.makedirs(p, exist_ok=True)
