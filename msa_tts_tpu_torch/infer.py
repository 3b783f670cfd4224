"""Few-shot adaptation inference driver (counterpart of
``msa_tts_tpu/infer.py``).

Reference: msa_tts/infer.py — load a trained checkpoint, and for each
requested speaker: k inner-loop adaptation steps on their support set,
autoregressive mel synthesis from free text, vocoding (Griffin-Lim /
WaveRNN+denoiser / HiFi-GAN), wav + attention/mel plots + .npy dumps in
``inference/``; optional loss-landscape plots.  The shell contract is the
JAX package's::

    EXPERIMENT_PATH=<dir> python -m msa_tts_tpu_torch.infer \\
        --checkpoint_id 0 --speaker A,B --input_text "..." [--key value ...]

(``--params_path <dir>`` in place of ``EXPERIMENT_PATH``; every value is
YAML-coerced to the type params.yml would give it).  The run goes on the
GPU unless ``device: cpu`` is given (``--device cpu``); without a CUDA
device the default raises.

Adaptation is ``meta/maml.py``'s meta-test function on the
teacher-forced training loss; synthesis is ``tacotron2nv_infer`` with
the params' ``decode_backend``: on the GPU the decoder loop is one
launch of the CUDA kernel (``models/cuda_decoder.py``), and a WaveRNN
vocoder's sample loop one launch of its kernel (``vocoders/cuda_gen.
py``).  Every draw of noise goes through one method, so that a test can
inject the JAX package's: the dropout masks of the adaptation
(:meth:`Inference._adapt_masks`), the prenet masks of synthesis
(:meth:`Inference._prenet_masks`) and the masks of the landscapes' loss
(:meth:`Inference._landscape_masks`); the landscapes' directions are
``random_plane``'s ``directions``.
"""

from __future__ import annotations

import os
import pickle
import sys
import time

import numpy as np
import torch

from .analysis.landscapes import linear_interpolation, random_plane
from .config import experiment_path_from_env, load_params
from .dataloaders.loader_meta import get_dataloader as get_dataloader_meta
from .meta.maml import make_metatest_fn
from .models.cuda_decoder import check_supported, prenet_masks
from .models.tacotron2nv import (
    Tacotron2NV,
    config_from_params,
    dropout_masks,
    tacotron2nv_infer,
)
from .ops.audio import griffinlim_logmelspec, save_wav
from .optim import make_optimizer
from .serving import teacher_forced_loss_fn
from .utils.backend import load_device, resolve_kernel_backend
from .utils.checkpoint import load_model_checkpoint
from .utils.g2p import N_SYMBOLS, Grapheme2Phoneme
from .utils.paths import PathManager
from .utils.plot import plot_attention, plot_spectrogram, pyplot


def _sync(device: torch.device) -> None:
    """Wait for the device, so that a wall time covers its work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def load_wavernn(params: dict, device, noise_profile: str | None = None):
    """The CLIs' WaveRNN: ``params["vocoder_params_path"]``'s model on
    ``device`` (the CLI's device, whatever the vocoder was trained on),
    its params, and the denoiser of ``params["noise_profile_path"]``
    (else ``noise_profile``) when that file exists, else None."""
    from .vocoders.wavernn import get_wavernn

    params_voc = load_params(params["vocoder_params_path"])
    wavernn = get_wavernn(
        device, **{k: v for k, v in params_voc.items() if k != "device"})
    path = params.get("noise_profile_path", noise_profile)
    denoiser = None
    if path and os.path.exists(path):
        from .vocoders.denoiser import AudioDenoiser

        denoiser = AudioDenoiser(path)
    return wavernn, params_voc, denoiser


class Inference:
    def __init__(self, **params):
        self.params = params
        output_path = os.path.join(
            params["output_path"], params["method"], params["experiment_name"]
        )
        self.path_manager = PathManager(output_path)
        self.g2p = Grapheme2Phoneme()
        self.device = load_device(params.get("device", "cuda"))

        mp = dict(params["model"])
        mp["n_mel_channels"] = params["audio_params"]["n_mels"]
        mp["n_symbols"] = N_SYMBOLS
        mp["num_speakers"] = 1
        for k in ("freeze_charemb", "freeze_encoder", "freeze_decoder"):
            mp[k] = params.get(k, False)
        params["model"] = mp
        self.cfg = config_from_params(mp)
        self.speaker_emb_type = mp["speaker_emb_type"]
        params["n_inner_test"] = int(params.get("n_inner_test", 1))
        self.decode_backend = params.get("decode_backend") or "auto"
        # raises now, not at the first speaker, for `cuda` on a CPU or a
        # config the kernel does not lower on a GPU
        if resolve_kernel_backend(self.decode_backend, self.device) == "cuda":
            check_supported(self.cfg.decoder_config())

        self._init_model()

        # Episodic loader over the meta-test speakers.  The configured
        # shot count is overridden only when the caller passed one.
        if "batch_size" in params:
            self.params["dataset_metatest"]["batch_size"] = int(
                params["batch_size"]
            )
        self.params["dataset_metatest"].setdefault("batch_size", 4)
        self.dataloader_metatest, log = get_dataloader_meta(
            "metatest", **self.params
        )
        print(log)

        self._loss_fn = teacher_forced_loss_fn(self.cfg, params["criterion"])
        self._metatest = make_metatest_fn(
            self._loss_fn, make_optimizer(params["optim_inner"]),
            params["n_inner_test"])
        self.timings: list[dict] = []

    # ------------------------------------------------------------ model
    def _init_model(self):
        ckpt_id = self.params["checkpoint_id"]
        sd, path = load_model_checkpoint(
            os.path.join(self.path_manager.checkpoints_path,
                         f"checkpoint_{ckpt_id}"), self.cfg)
        model = Tacotron2NV(self.cfg)
        model.load_state_dict(sd, strict=True)
        self._synth_model = model.to(self.device).eval()
        names = {k for k, _ in model.named_parameters()}
        # copies: the synthesis model's tensors take each speaker's
        # adapted weights in turn
        sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
        self.model_params = {k: v for k, v in sd.items() if k in names}
        self.model_state = {k: v for k, v in sd.items() if k not in names}
        print(f"Loaded {'model' if path.endswith('.ckpt') else 'reference'}"
              f" checkpoint from {path}")

    # ------------------------------------------------------------ noise
    def _adapt_masks(self, itr_b: int, batch: dict) -> list:
        """The dropout masks of meta-batch ``itr_b``'s adaptation: its
        ``n_inner_test`` inner steps and its query pass, drawn from a
        generator seeded by ``adapt_seed`` and ``itr_b``."""
        B, T_in = batch["inputs"].shape
        T_mel = batch["melspecs"].shape[-1]
        seed = int(self.params.get("adapt_seed", 0)) * 1_000_003 + itr_b
        g = torch.Generator(device=self.device).manual_seed(seed)
        return [dropout_masks(self.cfg, B, T_in, T_mel, g,
                              device=self.device)
                for _ in range(self.params["n_inner_test"] + 1)]

    def _prenet_masks(self, B: int) -> torch.Tensor:
        """(S, 2, B, P) prenet masks of a synthesis, from ``infer_seed``."""
        dcfg = self.cfg.decoder_config()
        g = torch.Generator().manual_seed(
            int(self.params.get("infer_seed", 0)))
        return prenet_masks(dcfg, dcfg.max_decoder_steps, B, g,
                            device=self.device)

    def _landscape_masks(self, batch: dict) -> dict:
        """One fixed set of dropout masks for every point of a landscape
        (the JAX package evaluates each under ``PRNGKey(1)``)."""
        B, T_in = batch["inputs"].shape
        g = torch.Generator(device=self.device).manual_seed(1)
        return dropout_masks(self.cfg, B, T_in, batch["melspecs"].shape[-1],
                             g, device=self.device)

    # -------------------------------------------------------- synthesis
    def _speaker_vec(self, speaker: str) -> np.ndarray:
        if not hasattr(self, "_spk_emb_cache"):
            # one unpickle for the whole run (the file holds every
            # speaker)
            with open(self.params["spk_emb_path"], "rb") as f:
                self._spk_emb_cache = pickle.load(f)
        emb = self._spk_emb_cache[speaker]
        return np.asarray(emb["mean"] if isinstance(emb, dict) else emb,
                          np.float32)

    @torch.no_grad()
    def generate_melspec(self, adapted_params: dict, model_state: dict,
                         speaker: str):
        """Phonemize the input text and synthesize a mel for ``speaker``
        with the adapted weights (reference infer.py:171-198); returns
        host arrays ``(mel (n_mels, frames), attn (steps, T_in))``."""
        seq, _ = self.g2p.convert(
            inp=self.params["input_text"],
            language=self.params.get("language", "en-us"),
            convert_mode=self.params.get(
                "convert_mode", "text_to_phone_to_idx"
            ),
        )
        dev = self.device
        inputs = torch.as_tensor(np.asarray(seq, np.int64)[None], device=dev)
        in_len = torch.as_tensor([len(seq)], device=dev)
        spk_vec = torch.as_tensor(self._speaker_vec(speaker)[None],
                                  device=dev)
        model = self._synth_model
        model.load_state_dict({**adapted_params, **model_state}, strict=True)
        mel, mel_lengths, attn = tacotron2nv_infer(
            model, self.cfg, inputs, in_len, spk_vec, self._prenet_masks(1),
            decode_backend=self.decode_backend)
        n_steps = max(int(mel_lengths[0]), 1)
        r = self.cfg.n_frames_per_step
        mel = mel[0, :, : n_steps * r].float().cpu().numpy()
        attn = attn[0, :n_steps, : len(seq)].float().cpu().numpy()
        print(f"postnet_outputs: {mel.shape}")
        print(f"attn_weights: {attn.shape}")
        return mel, attn

    # --------------------------------------------------------- vocoding
    def _vocoder_bundle(self) -> dict:
        """The configured vocoder (and denoiser), loaded once."""
        if hasattr(self, "_voc_cache"):
            return self._voc_cache
        vocoder = self.params.get("vocoder", "griffinlim")
        bundle = {"name": vocoder}
        if vocoder == "wavernn":
            wavernn, params_voc, denoiser = load_wavernn(
                self.params, self.device,
                "experiments/files/noise_profiles/noise_prof1.wav")
            bundle.update(wavernn=wavernn, params_voc=params_voc)
            if denoiser is not None:
                bundle["denoiser"] = denoiser
        elif vocoder == "hifigan":
            from .vocoders.hifigan import HiFiGAN

            bundle["hifigan"] = HiFiGAN(
                self.params["vocoder_params_path"],
                self.params["vocoder_ckpt_path"], device=self.device,
            )
        elif vocoder != "griffinlim":
            raise ValueError(f"unknown vocoder: {vocoder}")
        self._voc_cache = bundle
        return bundle

    def _vocode(self, melspec: np.ndarray) -> np.ndarray:
        bundle = self._vocoder_bundle()
        mel = torch.as_tensor(melspec, device=self.device)
        if bundle["name"] == "griffinlim":
            return griffinlim_logmelspec(
                mel, self.params["audio_params"]).cpu().numpy()
        if bundle["name"] == "wavernn":
            params_voc = bundle["params_voc"]
            wav = bundle["wavernn"].generate(
                mel[None], True, params_voc["target"], params_voc["overlap"],
            )
            if "denoiser" in bundle:
                wav = bundle["denoiser"].denoise(wav)
            return np.asarray(wav)
        return bundle["hifigan"].inference(mel).cpu().numpy()

    # ------------------------------------------------------- landscapes
    def plot_loss_landscape(self, adapted_params: dict, model_state: dict,
                            batch: dict, speaker: str):
        """The training loss on a random plane through the adapted
        weights (16 x 16 points over a distance of 10, filter
        normalization), as a surface plot."""
        print(f"Plotting loss landscape for speaker {speaker}")
        masks = self._landscape_masks(batch)

        def loss_of(p):
            return self._loss_fn(p, model_state, batch, masks)[0]

        STEPS = 16
        surface = random_plane(
            loss_of, adapted_params, distance=10, steps=STEPS,
            normalization="filter",
        )
        plt = pyplot()
        fig = plt.figure()
        ax = plt.axes(projection="3d")
        X, Y = np.meshgrid(
            np.arange(surface.shape[1]), np.arange(surface.shape[0])
        )
        ax.plot_surface(X, Y, surface, cmap="viridis", edgecolor="none")
        ax.set_title("Surface Plot of Loss Landscape")
        fig.savefig(
            os.path.join(
                self.path_manager.inference_path,
                f"{speaker}_loss_surface.png",
            )
        )
        plt.close(fig)

    def plot_linear_interpolation(self, plot_inputs: dict):
        """The training loss along the line between the first two
        speakers' adapted weights, each on its own support set, both
        ways."""
        print("Plotting linear interpolation")
        STEPS = 32
        spk1, spk2 = self.params["speaker"][:2]
        p1, batch1, ms1 = plot_inputs[spk1]
        p2, batch2, ms2 = plot_inputs[spk2]

        def mk_loss(batch, ms):
            masks = self._landscape_masks(batch)
            return lambda p: self._loss_fn(p, ms, batch, masks)[0]

        loss_12 = linear_interpolation(mk_loss(batch1, ms1), p1, p2, STEPS)
        loss_21 = np.flip(
            linear_interpolation(mk_loss(batch2, ms2), p2, p1, STEPS)
        )
        plt = pyplot()
        xs = [i / STEPS for i in range(STEPS)]
        plt.figure()
        plt.plot(xs, loss_12, "b")
        plt.plot(xs, loss_21, "r")
        plt.title("Linear Interpolation of Loss")
        plt.xlabel("Interpolation Coefficient")
        plt.ylabel("Loss")
        plt.savefig(
            os.path.join(
                self.path_manager.inference_path,
                f"loss_linearinterp_{spk1}_to_{spk2}"
                f"_ckpt{self.params['checkpoint_id']}.png",
            )
        )
        plt.close()

    # ------------------------------------------------------------- main
    def make_inference(self):
        """Adapt to, synthesize and vocode each requested speaker of the
        meta-test set; ``self.timings`` gets each speaker's wall seconds
        of adaptation, decoding and vocoding.  ``plot_inference: false``
        skips the attention and mel plots (for hosts without
        matplotlib)."""
        speakers = self.params["speaker"]
        if isinstance(speakers, str):
            speakers = speakers.split(",")
        self.params["speaker"] = speakers

        plot_inputs = {}
        dev = self.device
        self._vocoder_bundle()      # loaded before the first speaker
        for itr_b, meta_batch in enumerate(self.dataloader_metatest):
            for spk, episode in meta_batch.items():
                if spk not in speakers:
                    continue
                print(f"Speaker: {spk}")
                support = unpack_task_batch_single(
                    episode["train"], self.speaker_emb_type, dev
                )
                query = unpack_task_batch_single(
                    episode["test"], self.speaker_emb_type, dev
                )
                t0 = time.perf_counter()
                with torch.enable_grad():
                    qloss, adapted, ms, inner_losses = self._metatest(
                        self.model_params, self.model_state, support, query,
                        self._adapt_masks(itr_b, support))
                adapted = {k: v.detach() for k, v in adapted.items()}
                ms = {k: v.detach() for k, v in ms.items()}
                for i, il in enumerate(inner_losses.cpu().numpy()):
                    print(
                        f"{i}/{self.params['n_inner_test']}, loss: {il}"
                    )
                _sync(dev)
                t1 = time.perf_counter()
                plot_inputs[spk] = (adapted, support, ms)

                print("Generating melspec ...")
                melspec, attn_weights = self.generate_melspec(
                    adapted, ms, spk
                )
                t2 = time.perf_counter()

                filename = (
                    spk
                    + "_"
                    + self.params["input_text"][:10].lower().replace(" ", "_")
                    + f"_ckpt{self.params['checkpoint_id']}"
                )
                out = self.path_manager.inference_path
                if self.params.get("plot_inference", True):
                    plot_attention(attn_weights,
                                   os.path.join(out, filename + "_attn"))
                    plot_spectrogram(melspec,
                                     os.path.join(out, filename + "_mel"))

                print("Generating wav ...")
                t3 = time.perf_counter()
                wav = self._vocode(melspec)
                t4 = time.perf_counter()
                save_wav(os.path.join(out, filename + ".wav"), wav,
                         self.params["audio_params"]["sample_rate"])
                np.save(os.path.join(out, filename + ".npy"), melspec)
                self.timings.append({"speaker": spk, "adapt_s": t1 - t0,
                                     "decode_s": t2 - t1,
                                     "vocode_s": t4 - t3})

        if self.params.get("plot_loss_landscapes", False):
            for spk in speakers:
                if spk in plot_inputs:
                    adapted, support, ms = plot_inputs[spk]
                    self.plot_loss_landscape(adapted, ms, support, spk)
            if len(speakers) >= 2 and all(
                s in plot_inputs for s in speakers[:2]
            ):
                self.plot_linear_interpolation(plot_inputs)


def unpack_task_batch_single(batch, speaker_emb_type: str,
                             device) -> dict:
    """One task's collated batch as the model's batch dictionary on
    ``device`` (integers as int64)."""
    def t(x):
        x = torch.from_numpy(np.ascontiguousarray(x))
        if not x.is_floating_point():
            x = x.to(torch.int64)
        return x.to(device)

    return {
        "inputs": t(batch.inputs),
        "input_lengths": t(batch.input_lengths),
        "melspecs": t(batch.mels),
        "melspec_lengths": t(batch.mel_lengths),
        "speaker_vecs": t(batch.speaker_vecs(speaker_emb_type)),
        "stop_labels": t(batch.stop_labels),
    }


# ---------------------------------------------------------------- CLI


def coerce_cli_value(v: str):
    """Coerce one ``--key value`` CLI string to the type params.yml would
    give it: ``--infer_seed 1`` an int, ``--plot_loss_landscapes false``
    the boolean False.  YAML 1.1 first (the loader params.yml goes
    through), then ``config.literal`` for the numeric spellings YAML
    leaves as strings (``1e-3``).  Anything else stays a plain string
    (speaker lists like ``A,B``, free text)."""
    import yaml

    from .config import literal

    try:
        parsed = yaml.safe_load(v)
    except yaml.YAMLError:
        parsed = None
    if parsed is None and v.strip() not in ("null", "~", ""):
        parsed = v
    if isinstance(parsed, str):
        lit = literal(parsed)
        # literal() returns free text unchanged; take it only when it
        # found a real value
        return lit if not isinstance(lit, str) else parsed
    return parsed


def get_cmd_params() -> dict:
    """``--key value`` free-form CLI params (reference infer.py:378-393),
    values YAML-coerced to params.yml types."""
    args = sys.argv[1:]
    if len(args) % 2 != 0:
        raise ValueError("arguments must be --key value pairs")
    return {args[i - 1].lstrip("-"): coerce_cli_value(args[i])
            for i in range(1, len(args), 2)}


def main(cmd_params: dict):
    experiment_path = experiment_path_from_env(
        cmd_params.pop("params_path", None)
    )
    print(f"Experiment path: {experiment_path}")
    params = load_params(os.path.join(experiment_path, "params.yml"))
    params.update(cmd_params)
    if "audio_params_path" in params:
        params["audio_params"] = load_params(params["audio_params_path"])
    inference = Inference(**params)
    inference.make_inference()
    return inference


if __name__ == "__main__":
    main(get_cmd_params())
