"""MAML / FOMAML outer step and the meta-test protocol (counterpart of
``msa_tts_tpu/meta/maml.py``).

Per task (speaker): k inner steps on the support set, the query loss,
and the task's gradient with respect to the initial parameters through
the inner steps (second order, ``track_higher_grads: true``) or with
respect to the adapted parameters (FOMAML); the task gradients are
averaged uniformly and the outer optimizer takes one step.

The JAX package vmaps the K tasks and differentiates the mean query loss
once.  Here the tasks run one after another and each adds the gradient
of ``query_loss / K``: the same gradient, with only one task's graph
alive at a time, so the JAX package's ``maml_remat`` has nothing to buy.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..optim import Transform, TrainState, apply_updates, clip_by_global_norm
from .grad_utils import global_norm
from .inner_loop import make_adapt_fn


class MetaMetrics(NamedTuple):
    loss: torch.Tensor          # mean query loss
    task_losses: torch.Tensor   # (K,) per-task query losses
    inner_losses: torch.Tensor  # (K, n_inner) inner-loop losses
    grad_norm: torch.Tensor     # global norm of the mean gradient, unclipped


def merge_task_states(states: list[dict], like: dict) -> dict:
    """The per-task model states after each task's query pass → one
    carried state: floating tensors (batch-norm running statistics) are
    averaged over the tasks in their type, the rest taken from task 0.
    Without it the running statistics would stay at their initial values
    for the whole run, and serving (eval mode) would normalise with
    them."""
    out = {}
    for k, ref in like.items():
        s = states[0][k]
        if s.is_floating_point():
            # a sum times 1/K, as jnp.mean computes it
            s = torch.stack([st[k] for st in states]).sum(dim=0) * (
                1.0 / len(states))
        out[k] = s.detach().to(ref.dtype)
    return out


def _task(batch: dict, k: int) -> dict:
    return {n: v[k] for n, v in batch.items()}


def make_maml_step(loss_fn: Callable, inner_tx: Transform,
                   outer_tx: Transform, n_inner: int, *,
                   second_order: bool = True,
                   clip_thresh: float | None = None, placement=None):
    """Build ``maml_step(state, support, query, masks) -> (state,
    MetaMetrics)``.

    ``support`` / ``query``: batch dictionaries with a leading task axis
    K.  ``masks[k]``: task k's dropout masks for its ``n_inner`` inner
    steps and its query pass (``n_inner + 1`` passes).
    ``loss_fn(params, model_state, batch, masks) -> (loss,
    new_model_state)``.

    ``placement`` (``parallel/shard_meta.py``): the batches are this
    rank's block of the episode and ``masks`` the whole episode's; the
    step runs its tasks, and the placement's reductions make the result
    the whole episode's on every rank."""
    pl = placement
    adapt = make_adapt_fn(loss_fn, inner_tx, n_inner,
                          create_graph=second_order,
                          group=pl.shot_group if pl is not None else None)

    def maml_step(state: TrainState, support: dict, query: dict, masks):
        first = next(iter(support.values()))
        k_loc = first.shape[0]
        if pl is None:
            ids, K, scale = range(k_loc), k_loc, 1.0 / k_loc
        else:
            ids, K = pl.task_ids(k_loc), pl.n_tasks(k_loc)
            scale = 1.0 / (K * pl.shot_parts)
        names = list(state.params)
        theta = {k: p.detach().requires_grad_(second_order)
                 for k, p in state.params.items()}
        grads = {k: torch.zeros_like(p) for k, p in theta.items()}
        qlosses, inner, task_states = [], [], []
        with torch.enable_grad():
            for j, k in enumerate(ids):
                m = masks[k] if pl is None else pl.task_masks(
                    masks[k], first.shape[1])
                adapted, ms, inner_k = adapt(theta, state.model_state,
                                             _task(support, j), m[:n_inner])
                qloss, ms_q = loss_fn(adapted, ms, _task(query, j),
                                      m[n_inner])
                if second_order:
                    # d(qloss_k / K) / d theta, through the inner steps
                    g = torch.autograd.grad(qloss * scale,
                                            [theta[n] for n in names],
                                            allow_unused=True)
                else:
                    # the query gradient at the adapted parameters,
                    # applied at theta (averaged below)
                    g = torch.autograd.grad(qloss,
                                            [adapted[n] for n in names],
                                            allow_unused=True)
                for n, gn in zip(names, g):
                    if gn is not None:
                        grads[n] += gn
                qlosses.append(qloss.detach())
                inner.append(inner_k)
                task_states.append({n: v.detach() for n, v in ms_q.items()})
                del adapted, qloss, g
        with torch.no_grad():
            if pl is not None:
                grads = pl.sum_grads(grads)
            if not second_order:
                grads = {n: g * scale for n, g in grads.items()}
            task_losses, inner = torch.stack(qlosses), torch.stack(inner)
            if pl is None:
                new_ms = merge_task_states(task_states, state.model_state)
            else:
                task_losses = pl.gather_tasks(pl.shot_mean(task_losses))
                inner = pl.gather_tasks(inner)
                new_ms = pl.merge_states(task_states, state.model_state)
            if clip_thresh is not None:
                grads, grad_norm = clip_by_global_norm(grads, clip_thresh)
            else:
                grad_norm = global_norm(grads)
            updates, opt_state = outer_tx.update(grads, state.opt_state,
                                                 state.params)
            new_state = TrainState(
                params=apply_updates(state.params, updates),
                model_state=new_ms, opt_state=opt_state,
                step=state.step + 1)
        return new_state, MetaMetrics(task_losses.sum() * (1.0 / K),
                                      task_losses, inner, grad_norm)

    return maml_step


def make_metatest_fn(loss_fn: Callable, inner_tx: Transform, n_inner: int,
                     *, create_graph: bool = False):
    """Build ``metatest(params, model_state, support, query, masks)``:
    ``masks`` holds ``n_inner + 1`` passes' dropout masks, the inner
    steps' then the query pass's.  Returns ``(query_loss,
    adapted_params, adapted_model_state, inner_losses)``; the query pass
    keeps a graph only with ``create_graph``."""
    adapt = make_adapt_fn(loss_fn, inner_tx, n_inner,
                          create_graph=create_graph)

    def metatest(params, model_state, support, query, masks):
        adapted, ms, inner_losses = adapt(params, model_state, support,
                                          masks[:n_inner])
        with torch.set_grad_enabled(create_graph):
            qloss, _ = loss_fn(adapted, ms, query, masks[n_inner])
        return qloss, adapted, ms, inner_losses

    return metatest
