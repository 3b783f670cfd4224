"""Kernel-backend resolution (counterpart of
``msa_tts_tpu/utils/backend.py``): ``cuda`` runs the hand-written CUDA
kernels, ``torch`` their plain PyTorch versions, and ``auto`` picks by
where the tensors live — no platform sniffing."""

from __future__ import annotations

import torch

CHOICES = ("cuda", "torch", "auto")


def resolve_kernel_backend(choice: str | None,
                           device: torch.device | str) -> str:
    """Map a ``cuda`` / ``torch`` / ``auto`` (default) choice to the
    backend for tensors on ``device``: ``"cuda"`` or ``"torch"``.

    ``auto`` is the kernel for CUDA tensors and the plain version for
    CPU tensors.  Asking for ``cuda`` with a non-CUDA device raises, and
    so does any other spelling (a typo must not silently select the
    plain path while the operator believes the kernel runs)."""
    if choice is not None:
        choice = str(choice).lower()
    if choice not in CHOICES + (None,):
        raise ValueError(
            f"unknown kernel backend {choice!r}: expected 'cuda', "
            "'torch' or 'auto'"
        )
    is_cuda = torch.device(device).type == "cuda"
    if choice == "cuda" and not is_cuda:
        raise ValueError(
            f"kernel backend 'cuda' needs CUDA tensors, got device {device}"
        )
    if choice == "torch":
        return "torch"
    return "cuda" if is_cuda else "torch"
