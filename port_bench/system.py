"""The system under test: the PyTorch and CUDA port, built from the
benchmark's configuration and weights.  This is the one file that
imports the port; it reads the port's launch counters and its G2P
backend, and nothing else of its state.

Each model is built as a deployment builds it from a checkpoint: the
module constructed (here on the device), the weights copied in with
``load_state_dict``, then handed to the serving object, which moves and
casts it."""

from __future__ import annotations

import torch


class System:
    def __init__(self, cfg: dict, weights: dict, device):
        from msa_tts_tpu_torch.models import cuda_decoder
        from msa_tts_tpu_torch.models.tacotron2nv import (Tacotron2NV,
                                                          config_from_params)
        from msa_tts_tpu_torch.serving import AdaptiveTTS
        from msa_tts_tpu_torch.vocoders import cuda_gen
        from msa_tts_tpu_torch.vocoders.hifigan import Generator, HiFiGAN
        from msa_tts_tpu_torch.vocoders.wavernn import (WaveRNN,
                                                        WaveRNNConfig,
                                                        WaveRNNModel)

        from weights import model_params

        self._k1, self._k3 = cuda_decoder, cuda_gen
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
        ap = cfg["audio_params"]
        voc = cfg["vocoders"]
        if "wavernn" in voc:
            v = voc["wavernn"]
            wcfg = WaveRNNConfig(
                mode=v["voc_mode"], n_mels=ap["n_mels"], rnn_dims=v["rnn_dims"],
                fc_dims=v["fc_dims"], compute_dims=v["compute_dims"],
                res_out_dims=v["res_out_dims"], res_blocks=v["res_blocks"],
                hop_length=ap["hop_length"], sample_rate=ap["sample_rate"],
                pad=v["pad"], upsample_factors=tuple(v["upsample_factors"]))
            with torch.device(self.device):
                wm = WaveRNNModel(wcfg)
            wm.load_state_dict(weights["wavernn"], strict=True)
            self.tts.attach_vocoder("wavernn", WaveRNN(
                wm, wcfg, gen_dtype=v["gen_dtype"], device=self.device))
        if "hifigan" in voc:
            with torch.device(self.device):
                gen = Generator(voc["hifigan"], ap["n_mels"])
            gen.load_state_dict(weights["hifigan"], strict=True)
            self.tts.attach_vocoder(
                "hifigan", HiFiGAN.from_params(gen, voc["hifigan"],
                                               device=self.device))

    def counters(self) -> dict:
        """The port's launch counters: decoder-loop kernel (K1) and
        sample-loop kernel (K3) launches so far in this process."""
        return {"k1_launches": self._k1.LAUNCHES,
                "k3_launches": self._k3.GEN_LAUNCHES}

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
