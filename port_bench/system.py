"""The system under test: the PyTorch and CUDA port, built from the
benchmark's configuration and weights.  This file and the vocoders'
parts (``parts/``) are all that import the port; they read its launch
counters and its G2P backend, and nothing else of its state.

Each model is built as a deployment builds it from a checkpoint: the
module constructed (here on the device), the weights copied in with
``load_state_dict``, then handed to the serving object, which moves and
casts it."""

from __future__ import annotations

import torch

import parts


class System:
    def __init__(self, cfg: dict, weights: dict, device):
        from msa_tts_tpu_torch.models import cuda_decoder
        from msa_tts_tpu_torch.models.tacotron2nv import (Tacotron2NV,
                                                          config_from_params)
        from msa_tts_tpu_torch.serving import AdaptiveTTS

        from weights import model_params

        self._k1 = cuda_decoder
        self.device = torch.device(device)
        mp = model_params(cfg)
        with torch.device(self.device):
            model = Tacotron2NV(config_from_params(mp))
        model.load_state_dict(weights["tacotron"], strict=True)
        params = {"model": dict(cfg["model"]),
                  "audio_params": dict(cfg["audio_params"]),
                  "infer_dtype": cfg["infer_dtype"],
                  "decode_backend": "auto"}
        self.tts = AdaptiveTTS(params, model, device=self.device)
        # name → part of each vocoder of the configuration
        self.parts = parts.of(cfg)
        for name, part in self.parts.items():
            voc = part.build(weights.get(name), self.device)
            if voc is not None:
                self.tts.attach_vocoder(name, voc)

    def counters(self) -> dict:
        """The port's launch counters so far in this process: the
        decoder-loop kernel's (K1) and each vocoder part's own."""
        out = {"k1_launches": self._k1.LAUNCHES}
        for part in self.parts.values():
            out.update(part.counters())
        return out

    def g2p_backend(self) -> str:
        return self.tts.g2p.backend_name

    def server(self, spk_emb, p: dict):
        """A ``TTSServer`` over the system with the mix's batching
        settings; only its batcher is started by the caller."""
        from msa_tts_tpu_torch.server import TTSServer

        return TTSServer(self.tts, default_spk_emb=spk_emb,
                         max_batch=p["max_batch"], window_ms=p["window_ms"],
                         batch_buckets=tuple(p["buckets"]),
                         text_pad_multiple=p["text_pad_multiple"])
