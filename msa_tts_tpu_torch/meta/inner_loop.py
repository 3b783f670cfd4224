"""Inner-loop adaptation (counterpart of ``msa_tts_tpu/meta/inner_loop.py``).

k steps of gradient descent over a dictionary of parameters with a
functional optimizer (``optim.make_optimizer``): each step evaluates the
loss on the current parameters (the caller's loss runs the model with
``torch.func.functional_call``), takes ``torch.autograd.grad`` of it and
applies the optimizer's update.  The batch-norm state returned by a step is the
next step's, as the JAX package threads it through its scan.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch

from ..ops.rnn import twice_differentiable
from ..optim import Transform, apply_updates


def make_adapt_fn(loss_fn: Callable, inner_tx: Transform, n_steps: int, *,
                  create_graph: bool = False, group=None):
    """Build ``adapt(params, model_state, batch, masks)``.

    ``loss_fn(params, model_state, batch, masks) -> (loss,
    new_model_state)``; ``masks[k]`` is step k's.  Returns
    ``(adapted_params, model_state, losses)``, ``losses`` the per-step
    inner losses (n_steps,).

    ``create_graph=False`` (first order) starts every step from detached
    parameters.  With ``create_graph=True`` the updates keep their
    graph, so the adapted parameters can be differentiated with respect
    to the ``params`` given (second-order meta-learning); those must
    then require grad, and each step's forward runs under
    ``ops.rnn.twice_differentiable``.

    ``group``: a mesh's ``AxisGroup`` (the JAX package's
    ``grad_pmean_axis``) over which each step's gradients and loss are
    averaged, through one differentiable all-reduce: a task whose shots
    are split over the group then adapts to the same parameters on every
    rank of it (``parallel/shard_meta.py``)."""

    def adapt(params: dict, model_state: dict, batch, masks):
        if not create_graph:
            params = {k: p.detach().requires_grad_() for k, p in
                      params.items()}
        opt_state = inner_tx.init(params)
        losses = []
        for k in range(n_steps):
            # a second-order step's backward is differentiated again: its
            # forward must not take cuDNN's RNN (ops/rnn.py)
            with (twice_differentiable() if create_graph
                  else contextlib.nullcontext()):
                loss, new_ms = loss_fn(params, model_state, batch, masks[k])
                grads = torch.autograd.grad(
                    loss, list(params.values()), create_graph=create_graph,
                    allow_unused=True)
            # a parameter the loss does not reach (a freeze_* flag) gets
            # a zero gradient, as under jax.grad
            grads = {n: torch.zeros_like(p) if g is None else g
                     for (n, p), g in zip(params.items(), grads)}
            if group is not None and group.pg is not None:
                grads, loss = _pmean(grads, loss, group)
            updates, opt_state = inner_tx.update(grads, opt_state, params)
            params = apply_updates(params, updates)
            if not create_graph:
                params = {n: p.detach().requires_grad_()
                          for n, p in params.items()}
            # the state is an output of the step, not differentiated
            model_state = {n: v.detach() for n, v in new_ms.items()}
            losses.append(loss.detach())
        return (params, model_state,
                torch.stack(losses) if losses else torch.zeros(0))

    return adapt


def _pmean(grads: dict, loss, group):
    """``grads`` and ``loss`` averaged over ``group`` in one flat,
    differentiable all-reduce."""
    from ..parallel.collectives import pmean

    flat = pmean(torch.cat([g.reshape(-1) for g in grads.values()]
                           + [loss.detach().reshape(1).to(
                               next(iter(grads.values())).dtype)]), group)
    out, off = {}, 0
    for n, g in grads.items():
        out[n] = flat[off: off + g.numel()].view(g.shape)
        off += g.numel()
    return out, flat[off]
