"""Continual-stream inference driver (counterpart of
``msa_tts_tpu/infer_cumulative.py``).

Reference: msa_tts/infer_cumulative.py — for each per-task checkpoint
``best_{itr}_{speaker}`` of a continual run (``checkpoint_{id}`` with
``joint_training``), synthesize a sentence list for every speaker seen up
to that point, vocode (WaveRNN + denoiser, or Griffin-Lim) and save wavs
under ``inference/``::

    python -m msa_tts_tpu_torch.infer_cumulative --params_path <dir> \\
        --input_text_file sents.txt --spk_emb_path spk_emb.pkl \\
        [--vocoder wavernn --vocoder_params_path voc.yml] [--key value ...]

(or the ``EXPERIMENT_PATH`` variable).  The run goes on the GPU unless
``device: cpu`` is given; without a CUDA device the default raises.

The reference fans the speakers out over a ``ProcessPoolExecutor`` of
model replicas (infer_cumulative.py:156-191); here the speakers run in
turn on one device and each speaker's whole sentence list is ONE batch:
its phoneme ids padded to a multiple of 16 (``ops/masking.pad_axis_to``),
decoded in one call (on the GPU one launch of the decoder-loop kernel at
B = the number of sentences) and vocoded by WaveRNN's ``generate_batch``
(on the GPU one launch of its sample-loop kernel for every fold of every
sentence).  The prenet masks of a batch come from
:meth:`InferCumulative._prenet_masks`, the one place a test injects the
JAX package's.
"""

from __future__ import annotations

import os
import pickle
import random
import time

import numpy as np
import torch

from .config import experiment_path_from_env, load_params
from .infer import _sync, get_cmd_params, load_wavernn
from .models.cuda_decoder import check_supported, prenet_masks
from .models.tacotron2nv import Tacotron2NV, config_from_params, \
    tacotron2nv_infer
from .ops.audio import griffinlim_logmelspec, save_wav
from .ops.masking import pad_axis_to
from .utils.backend import load_device, resolve_kernel_backend
from .utils.checkpoint import load_model_checkpoint
from .utils.g2p import N_SYMBOLS, Grapheme2Phoneme
from .utils.paths import PathManager


class InferCumulative:
    def __init__(self, **params):
        self.params = params
        output_path = os.path.join(
            params["output_path"], params["method"], params["experiment_name"]
        )
        self.path_manager = PathManager(output_path)
        self.device = load_device(params.get("device", "cuda"))

        self.all_speakers = list(params["dataset_train"]["speakers_list"])
        if "joint_training" not in params:
            random.Random(params.get("speaker_seed", 0)).shuffle(
                self.all_speakers
            )
        print(self.all_speakers)

        mp = dict(params["model"])
        mp["num_speakers"] = 1
        mp["n_symbols"] = N_SYMBOLS
        mp["n_mel_channels"] = params["audio_params"]["n_mels"]
        for k in ("freeze_charemb", "freeze_encoder", "freeze_decoder"):
            mp[k] = params.get(k, False)
        params["model"] = mp
        self.cfg = config_from_params(mp)
        self.speaker_emb_type = mp["speaker_emb_type"]
        self.decode_backend = params.get("decode_backend") or "auto"
        if resolve_kernel_backend(self.decode_backend, self.device) == "cuda":
            check_supported(self.cfg.decoder_config())
        self.model = Tacotron2NV(self.cfg).to(self.device).eval()
        self.timings: list[dict] = []

    # ----------------------------------------------------------- loading
    def _load_stream_checkpoint(self, name: str):
        """``checkpoints/<name>`` (``.ckpt``, else ``.pt``; ``name`` may
        carry either suffix) into the model."""
        sd, path = load_model_checkpoint(
            os.path.join(self.path_manager.checkpoints_path, name), self.cfg)
        self.model.load_state_dict(sd, strict=True)
        print(f"Loading checkpoint from  {path}")

    def _load_vocoder(self):
        if self.params.get("vocoder", "griffinlim") == "wavernn":
            return ("wavernn", *load_wavernn(self.params, self.device))
        return ("griffinlim", None, None, None)

    # ---------------------------------------------------------- synthesis
    def _prenet_masks(self, B: int) -> torch.Tensor:
        """(S, 2, B, P) prenet masks of one batch (a generator seeded 0,
        as the JAX package decodes every batch under ``PRNGKey(0)``)."""
        dcfg = self.cfg.decoder_config()
        return prenet_masks(dcfg, dcfg.max_decoder_steps, B,
                            torch.Generator().manual_seed(0),
                            device=self.device)

    @torch.no_grad()
    def _infer_batch(self, inputs: np.ndarray, in_lens: np.ndarray,
                     spk: np.ndarray):
        """One padded (B, T_in) batch → mels (B, n_mel, S·r) on the
        device and host mel_lengths (B,) in decoder steps."""
        dev = self.device
        mel, mel_lengths, _ = tacotron2nv_infer(
            self.model, self.cfg,
            torch.as_tensor(inputs, dtype=torch.int64, device=dev),
            torch.as_tensor(in_lens, dtype=torch.int64, device=dev),
            torch.as_tensor(np.ascontiguousarray(spk), dtype=torch.float32,
                            device=dev),
            self._prenet_masks(len(inputs)),
            decode_backend=self.decode_backend)
        return mel, mel_lengths.cpu().numpy()

    def _infer_for_speaker(self, step: int, ref_speaker: str,
                           target_speaker: str, vocoder_bundle):
        """Synthesize the whole sentence list for ``target_speaker`` in
        one batch."""
        print(f"Inferring from {ref_speaker} to {target_speaker}.")
        seqs = []
        for sent in self.sent_list:
            seq, _ = self.g2p.convert(
                inp=sent,
                language=self.params.get("language", "en-us"),
                convert_mode=self.params.get(
                    "convert_mode", "text_to_phone_to_idx"
                ),
            )
            seqs.append(np.asarray(seq, np.int32))
        max_len = ((max(len(s) for s in seqs) + 15) // 16) * 16
        inputs = np.stack([pad_axis_to(s, max_len) for s in seqs])
        in_lens = np.asarray([len(s) for s in seqs], np.int32)

        emb = self.speaker_embeddings[target_speaker]
        vec = emb["mean"] if isinstance(emb, dict) else emb
        spk = np.broadcast_to(
            np.asarray(vec, np.float32)[None, :],
            (len(seqs), len(vec)),
        )

        t0 = time.perf_counter()
        mel, mel_lengths = self._infer_batch(inputs, in_lens, spk)
        _sync(self.device)
        t1 = time.perf_counter()

        kind, wavernn, params_voc, denoiser = vocoder_bundle
        r = self.cfg.n_frames_per_step
        mels = [
            mel[i, :, : max(int(mel_lengths[i]) * r, r)]
            for i in range(len(self.sent_list))
        ]
        if kind == "wavernn":
            # all sentences' folds in ONE sample loop (generate_batch)
            wavs = wavernn.generate_batch(
                mels, target=params_voc["target"],
                overlap=params_voc["overlap"], verbose=False,
            )
            if denoiser is not None:
                wavs = [denoiser.denoise(w) for w in wavs]
        else:
            wavs = [griffinlim_logmelspec(
                m, self.params["audio_params"]).cpu().numpy() for m in mels]
        t2 = time.perf_counter()
        for i, wav in enumerate(wavs):
            fname = (
                f"{step}_{ref_speaker}_to_{target_speaker}_sent{i}.wav"
            )
            save_wav(
                os.path.join(self.path_manager.inference_path, fname),
                wav,
                self.params["audio_params"]["sample_rate"],
            )
        self.timings.append({"step": step, "speaker": target_speaker,
                             "decode_s": t1 - t0, "vocode_s": t2 - t1})

    # --------------------------------------------------------------- run
    def run(self):
        self.speakers_so_far = []
        with open(self.params["spk_emb_path"], "rb") as f:
            self.speaker_embeddings = pickle.load(f)
        self.g2p = Grapheme2Phoneme()
        with open(self.params["input_text_file"]) as f:
            self.sent_list = [s.strip() for s in f if s.strip()]

        vocoder_bundle = self._load_vocoder()
        num_initial = int(self.params.get("num_initial_speakers", 0))
        checkpoint_id = str(self.params.get("checkpoint_id", "all"))

        for spk_itr, speaker in enumerate(self.all_speakers):
            if "joint_training" not in self.params:
                self.speakers_so_far.append(speaker)
                if checkpoint_id != "all" and str(spk_itr) != checkpoint_id:
                    print("Skipping speaker ", spk_itr)
                    continue
                ckpt_name = f"best_{spk_itr + num_initial}_{speaker}"
            else:
                ckpt_name = f"checkpoint_{checkpoint_id}"
                self.speakers_so_far = self.all_speakers

            self._load_stream_checkpoint(ckpt_name)

            for itr_t, target in enumerate(self.speakers_so_far):
                print(
                    f"\n\nInferring for speaker {target}:"
                    f" {itr_t}/{len(self.speakers_so_far)}"
                )
                self._infer_for_speaker(
                    spk_itr, speaker, target, vocoder_bundle
                )
            if "joint_training" in self.params:
                break


def main(cmd_params: dict):
    experiment_path = experiment_path_from_env(
        cmd_params.pop("params_path", None)
    )
    params = load_params(os.path.join(experiment_path, "params.yml"))
    params.update(cmd_params)
    ic = InferCumulative(**params)
    ic.run()
    return ic


if __name__ == "__main__":
    main(get_cmd_params())
