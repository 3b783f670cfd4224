"""What the readers share: the requests a device call served and the
work each needs."""

from __future__ import annotations

import inputs
from work import hifigan as WH
from work import peaks
from work import tacotron as WT
from work import wavernn as WW
from weights import model_params


def real_requests(call) -> list:
    return [r for r in call.requests if r is not None]


def steps(cfg: dict) -> int:
    return cfg["model"]["max_decoder_steps"]


def frames(cfg: dict) -> int:
    return steps(cfg) * cfg["model"]["n_frames_per_step"]


def wavernn_folds(cfg: dict) -> tuple:
    """(real folds of one request's mel, sample steps a fold)."""
    v = cfg["vocoders"]["wavernn"]
    n, _ = inputs.fold_rows(frames(cfg), cfg["audio_params"]["hop_length"],
                            v["target"], v["overlap"])
    return n, v["target"] + 2 * v["overlap"]


def request_seconds_at_peak(run, r) -> float:
    """The least time the chip needs for request ``r``'s model
    operations: each type's operations over its peak."""
    cfg = run.cfg
    m = model_params(cfg)
    acoustic = cfg["infer_dtype"]
    t = (WT.encoder_ops(m, 1, r.n_phonemes)
         + WT.decoder_ops(m, 1, r.n_phonemes, steps(cfg))
         + WT.postnet_ops(m, 1, frames(cfg))) / peaks.FLOPS[acoustic]
    n_mels = cfg["audio_params"]["n_mels"]
    conv = peaks.conv_type(run.cudnn_tf32)
    if run.traffic["vocoder"] == "hifigan":
        t += WH.ops(cfg["vocoders"]["hifigan"], n_mels, 1,
                    frames(cfg)) / peaks.FLOPS[conv]
    elif run.traffic["vocoder"] == "wavernn":
        v = cfg["vocoders"]["wavernn"]
        n, L = wavernn_folds(cfg)
        t += WW.conditioning_ops(v, n_mels, 1, frames(cfg)) / peaks.FLOPS[conv]
        t += WW.projection_ops(v, n_mels, n, L) / peaks.FLOPS[
            "tf32" if run.matmul_tf32 else "float32"]
        t += WW.loop_ops(v, n, L) / peaks.FLOPS[v["gen_dtype"]]
    return t
