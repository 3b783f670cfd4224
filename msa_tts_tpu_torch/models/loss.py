"""Tacotron-2 training loss (counterpart of ``msa_tts_tpu/models/loss.py``).

L1 + MSE on both the pre- and the post-net mels plus a BCE stop loss
with a positive-class weight.  The reference's ``"none"`` reduction
weights each valid frame by one over its utterance's length, divides the
mel terms by ``B·n_mel`` and the gate term by ``B``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _bce_with_logits(logits, labels, pos_weight: float):
    """Elementwise BCE with logits and a positive-class weight
    (``torch.nn.BCEWithLogitsLoss`` semantics)."""
    return -(pos_weight * labels * F.logsigmoid(logits)
             + (1.0 - labels) * F.logsigmoid(-logits))


def tacotron2_loss(model_output, targets, mel_lengths, *,
                   n_frames_per_step: int = 1, reduction: str = "none",
                   pos_weight: float = 1.0):
    """The total loss.

    ``model_output``: ``(mel_outputs, mel_outputs_postnet, gate_outputs,
    alignments)``; ``targets``: ``(mel (B, n_mel, T), stop_labels (B,
    T))``; ``mel_lengths``: (B,) valid frames.  ``T`` is already a
    multiple of ``n_frames_per_step`` (the collator pads it so), so the
    valid-frame mask needs no further padding.  Returns a scalar."""
    outputs, postnet_outputs, stop_values, _ = model_output
    mel, stop_labels = targets
    mel_t = mel.transpose(1, 2)
    out_t = outputs.transpose(1, 2)
    post_t = postnet_outputs.transpose(1, 2)

    l1 = (post_t - mel_t).abs() + (out_t - mel_t).abs()
    mse = (post_t - mel_t) ** 2 + (out_t - mel_t) ** 2
    bce = _bce_with_logits(stop_values, stop_labels, pos_weight)

    if reduction == "mean":
        return l1.mean() + mse.mean() + bce.mean()
    if reduction == "sum":
        return l1.sum() + mse.sum() + bce.sum()
    if reduction != "none":
        raise ValueError(f"unknown reduction: {reduction}")

    B, T, n_mel = mel_t.shape
    ids = torch.arange(T, device=mel.device)
    mask = (ids[None, :] < mel_lengths[:, None]).to(torch.float32)
    weights = mask / torch.clamp_min(mask.sum(dim=1, keepdim=True), 1.0)
    # the weights are zero at padded frames: no second mask
    out_weights = (weights / (B * n_mel))[..., None]       # (B, T, 1)
    return ((l1 * out_weights).sum() + (mse * out_weights).sum()
            + (bce * (weights / B)).sum())
