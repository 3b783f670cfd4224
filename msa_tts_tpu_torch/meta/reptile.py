"""Reptile, first-order meta-learning (counterpart of
``msa_tts_tpu/meta/reptile.py``).

Per task (speaker): k inner steps from the current weights θ₀ on the
support set, the query loss at the adapted weights θ_T (logged, not
differentiated), and the outer "gradient" θ₀ − θ_T, which the outer
optimizer applies (the clip, where set, acts on it).  Two modes:

  * ``sequential`` (the reference's order): the tasks one after
    another, each from the weights the previous task's outer step left
    and with the batch-norm state of its query pass;
  * ``batched``: every task from the same θ₀, the directions averaged,
    the tasks' batch-norm states merged (``merge_task_states``), one
    outer step.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..optim import Transform, TrainState, apply_updates, clip_by_global_norm
from .grad_utils import global_norm
from .inner_loop import make_adapt_fn
from .maml import _task, merge_task_states


class ReptileMetrics(NamedTuple):
    loss: torch.Tensor          # mean query loss
    task_losses: torch.Tensor   # (K,)
    inner_losses: torch.Tensor  # (K, n_inner)
    grad_norm: torch.Tensor     # mean outer-step gradient norm, unclipped


def make_reptile_step(loss_fn: Callable, inner_tx: Transform,
                      outer_tx: Transform, n_inner: int, *,
                      mode: str = "sequential",
                      clip_thresh: float | None = None, placement=None):
    """Build ``reptile_step(state, support, query, masks) -> (state,
    ReptileMetrics)``; arguments as ``make_maml_step``'s (``masks[k]``:
    task k's ``n_inner`` inner steps', then its query pass's), and so is
    ``placement``, which only the batched mode takes: the sequential
    one's outer update sits between tasks."""
    if mode not in ("sequential", "batched"):
        raise ValueError(f"unknown reptile mode: {mode}")
    pl = placement
    if pl is not None and mode != "batched":
        raise ValueError("only batched Reptile shards its tasks")
    adapt = make_adapt_fn(loss_fn, inner_tx, n_inner,
                          group=pl.shot_group if pl is not None else None)

    def task_direction(params, model_state, sup, qry, masks):
        adapted, ms, inner = adapt(params, model_state, sup, masks[:n_inner])
        with torch.no_grad():
            adapted = {k: v.detach() for k, v in adapted.items()}
            qloss, ms_q = loss_fn(adapted, ms, qry, masks[n_inner])
            # outer grad = −(θ_T − θ₀) = θ₀ − θ_T
            direction = {k: params[k] - adapted[k] for k in params}
        return (direction, qloss.detach(), inner,
                {k: v.detach() for k, v in ms_q.items()})

    @torch.no_grad()
    def apply(grads: dict, state: TrainState):
        if clip_thresh is not None:
            grads, grad_norm = clip_by_global_norm(grads, clip_thresh)
        else:
            grad_norm = global_norm(grads)
        updates, opt_state = outer_tx.update(grads, state.opt_state,
                                             state.params)
        return state._replace(params=apply_updates(state.params, updates),
                              opt_state=opt_state,
                              step=state.step + 1), grad_norm

    def reptile_step(state: TrainState, support: dict, query: dict, masks):
        first = next(iter(support.values()))
        k_loc = first.shape[0]
        if pl is None:
            ids, K, scale = range(k_loc), k_loc, 1.0 / k_loc
        else:
            ids, K = pl.task_ids(k_loc), pl.n_tasks(k_loc)
            scale = 1.0 / (K * pl.shot_parts)
        theta0 = state
        qlosses, inner, norms, directions, states = [], [], [], [], []
        for j, k in enumerate(ids):
            m = masks[k] if pl is None else pl.task_masks(masks[k],
                                                          first.shape[1])
            src = state if mode == "sequential" else theta0
            d, q, i, ms_q = task_direction(
                src.params, src.model_state, _task(support, j),
                _task(query, j), m)
            qlosses.append(q)
            inner.append(i)
            if mode == "sequential":
                state, norm = apply(d, state)
                state = state._replace(model_state=ms_q)
                norms.append(norm)
            else:
                directions.append(d)
                states.append(ms_q)
        with torch.no_grad():
            task_losses, inner = torch.stack(qlosses), torch.stack(inner)
            if mode == "batched":
                # jnp.mean over the task axis: a sum times 1/K
                mean = {n: torch.stack([d[n] for d in directions]).sum(0)
                        for n in directions[0]}
                if pl is not None:
                    mean = pl.sum_grads(mean)
                mean = {n: d * scale for n, d in mean.items()}
                state, norm = apply(mean, state)
                if pl is None:
                    merged = merge_task_states(states, state.model_state)
                else:
                    merged = pl.merge_states(states, state.model_state)
                    task_losses = pl.gather_tasks(pl.shot_mean(task_losses))
                    inner = pl.gather_tasks(inner)
                state = state._replace(model_state=merged)
                norms.append(norm)
            return state, ReptileMetrics(
                task_losses.sum() * (1.0 / K), task_losses, inner,
                torch.stack(norms).sum() * (1.0 / len(norms)))

    return reptile_step
