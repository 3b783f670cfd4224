"""Gradient utilities on dictionaries of tensors (counterpart of
``msa_tts_tpu/meta/grad_utils.py``): weighted averaging of task
gradients, the global norm, and elementwise tree arithmetic."""

from __future__ import annotations

import torch

from ..optim import sq_norm_sum


def mix_grads(grad_list: list[dict], weights=None) -> dict:
    """Weighted average of a list of gradient dictionaries (uniform when
    ``weights`` is None; weights are normalised to sum to one)."""
    n = len(grad_list)
    if weights is None:
        weights = [1.0 / n] * n
    else:
        total = sum(weights)
        weights = [w / total for w in weights]
    return {k: sum(w * g[k] for w, g in zip(weights, grad_list))
            for k in grad_list[0]}


def mix_grads_stacked(stacked: dict, weights=None) -> dict:
    """Weighted average over the leading (task) axis of stacked
    gradients, the stacked form of :func:`mix_grads`."""
    if weights is None:
        return {k: g.mean(dim=0) for k, g in stacked.items()}
    w = torch.as_tensor(weights, dtype=torch.float32)
    w = w / w.sum()
    return {k: torch.tensordot(w.to(g.device, g.dtype), g, dims=1)
            for k, g in stacked.items()}


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the float32 sum of squares of every tensor (each sharded
    leaf over all its shards under ``parallel.tp.tp_products``)."""
    return torch.sqrt(sq_norm_sum(tree))


def tree_sub(a: dict, b: dict) -> dict:
    return {k: a[k] - b[k] for k in a}


def tree_add(a: dict, b: dict) -> dict:
    return {k: a[k] + b[k] for k in a}


def tree_scale(a: dict, s) -> dict:
    return {k: v * s for k, v in a.items()}
