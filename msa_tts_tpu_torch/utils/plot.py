"""Diagnostic plots (the port's own copy of ``msa_tts_tpu/utils/plot.py``):
attention heatmaps and spectrograms (the inference CLI's), and the
attention + predicted-mel + ground-truth-mel panel the trainers save at a
meta-test (reference: msa_tts/utils/plot.py:26-47).  Each figure is
written as ``<path>.png`` on matplotlib's Agg backend."""

from __future__ import annotations

import numpy as np


def pyplot():
    """``matplotlib.pyplot`` on the Agg backend, imported here: serving
    and training without plots must not need it.  Raises with the cause
    where it is not installed."""
    try:
        import matplotlib
    except ImportError as e:
        raise RuntimeError(
            "plots need matplotlib, which is not installed; set "
            "plot_examples: false in params.yml to train without them"
        ) from e

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _heatmap(x: np.ndarray, path: str, xlabel: str, ylabel: str):
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(8, 4))
    im = ax.imshow(np.asarray(x), aspect="auto", origin="lower",
                   interpolation="none")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    fig.colorbar(im, ax=ax)
    fig.savefig(path if path.endswith(".png") else path + ".png", dpi=100)
    plt.close(fig)


def plot_attention(attn: np.ndarray, path: str):
    """(decoder steps, encoder steps) alignments as a heatmap."""
    _heatmap(np.asarray(attn).T, path, "decoder step", "encoder step")


def plot_spectrogram(mel: np.ndarray, path: str):
    """(n_mels, frames) mel as a heatmap."""
    _heatmap(mel, path, "frame", "mel bin")


def plot_spec_attn_example(
    mel: np.ndarray,
    mel_gt: np.ndarray,
    attn: np.ndarray,
    path: str,
    *,
    length_mel: int | None = None,
    length_attn: int | None = None,
):
    """Three-panel attention / predicted mel / ground-truth mel figure."""
    plt = pyplot()
    mel = np.asarray(mel)
    mel_gt = np.asarray(mel_gt)
    attn = np.asarray(attn)
    if length_mel is not None:
        mel = mel[:, :length_mel]
        mel_gt = mel_gt[:, :length_mel]
        attn = attn[: max(length_mel, 1)]
    if length_attn is not None:
        attn = attn[:, :length_attn]

    fig, axes = plt.subplots(3, 1, figsize=(8, 9))
    im0 = axes[0].imshow(
        attn.T, aspect="auto", origin="lower", interpolation="none"
    )
    axes[0].set_title("attention")
    fig.colorbar(im0, ax=axes[0])
    im1 = axes[1].imshow(
        mel, aspect="auto", origin="lower", interpolation="none"
    )
    axes[1].set_title("predicted mel")
    fig.colorbar(im1, ax=axes[1])
    im2 = axes[2].imshow(
        mel_gt, aspect="auto", origin="lower", interpolation="none"
    )
    axes[2].set_title("ground-truth mel")
    fig.colorbar(im2, ax=axes[2])
    fig.tight_layout()
    fig.savefig(path if path.endswith(".png") else path + ".png", dpi=100)
    plt.close(fig)
