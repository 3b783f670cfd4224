"""Optimizers as functional ``init`` / ``update`` pairs on dictionaries of
tensors (counterpart of ``msa_tts_tpu/optim.py``, which builds optax
chains).

``make_optimizer`` takes the reference's config vocabulary
(``{"optimizer_type": "Adam", "lr": "1e-3", ...}``, torch.optim names,
values possibly stringified) and composes the same chain of transforms
as the JAX package, with optax's arithmetic:

  * Adam's ``weight_decay`` is L2 added to the gradient before the
    scaling; AdamW adds the decay after it;
  * RMSprop divides by ``sqrt(nu + eps)`` (optax's ``eps_in_sqrt``), not
    by ``sqrt(nu) + eps`` as ``torch.optim.RMSprop`` does; ``centered``
    subtracts the squared mean first;
  * the momentum trace is ``g + decay · trace`` (nesterov: ``g + decay ·
    new_trace``).

The transforms are plain tensor arithmetic, so an update can be
differentiated through (second-order meta-learning).  ``torch.optim`` is
not used: it updates in place.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from .config import parse_optim_params
from .ops.nn import tp_active


class TrainState(NamedTuple):
    """A trainer's state: ``params`` (name → float32 tensor, the model's
    parameters under their ``state_dict`` names), ``model_state`` (the
    batch norms' buffers), ``opt_state`` (the optimizer's state) and the
    number of ``step``s taken."""

    params: dict
    model_state: dict
    opt_state: Any
    step: int


class Transform(NamedTuple):
    """``init(params) -> state``; ``update(grads, state, params) ->
    (updates, state)``; parameters, gradients and updates are
    dictionaries of tensors with the same keys."""

    init: Callable
    update: Callable


def _zeros(params):
    return {k: torch.zeros_like(p) for k, p in params.items()}


def _bias_correction(moment, decay: float, count: torch.Tensor):
    # 1 - decay**count in float32, then the division, as optax does
    bc = 1.0 - torch.tensor(decay, dtype=torch.float32,
                            device=count.device) ** count
    return {k: t / bc for k, t in moment.items()}


def add_decayed_weights(weight_decay: float) -> Transform:
    return Transform(
        lambda params: None,
        lambda g, state, params: (
            {k: g[k] + weight_decay * params[k] for k in g}, state),
    )


def scale_by_adam(b1: float, b2: float, eps: float, *,
                  amsgrad: bool = False) -> Transform:
    def init(params):
        device = next(iter(params.values())).device
        state = {"count": torch.zeros((), dtype=torch.int32, device=device),
                 "mu": _zeros(params), "nu": _zeros(params)}
        if amsgrad:
            state["nu_max"] = _zeros(params)
        return state

    def update(g, state, params=None):
        mu = {k: (1 - b1) * g[k] + b1 * state["mu"][k] for k in g}
        nu = {k: (1 - b2) * g[k] ** 2 + b2 * state["nu"][k] for k in g}
        count = state["count"] + 1
        mu_hat = _bias_correction(mu, b1, count)
        nu_hat = _bias_correction(nu, b2, count)
        new = {"count": count, "mu": mu, "nu": nu}
        if amsgrad:
            nu_hat = {k: torch.maximum(state["nu_max"][k], nu_hat[k])
                      for k in g}
            new["nu_max"] = nu_hat
        return ({k: mu_hat[k] / (torch.sqrt(nu_hat[k]) + eps) for k in g},
                new)

    return Transform(init, update)


def scale_by_rms(decay: float, eps: float, *,
                 centered: bool = False) -> Transform:
    """optax's ``scale_by_rms`` (``centered``: ``scale_by_stddev``), both
    with ``eps`` inside the square root."""
    def init(params):
        return {"mu": _zeros(params) if centered else None,
                "nu": _zeros(params)}

    def update(g, state, params=None):
        nu = {k: (1 - decay) * g[k] ** 2 + decay * state["nu"][k]
              for k in g}
        mu = state["mu"]
        if centered:
            mu = {k: (1 - decay) * g[k] + decay * mu[k] for k in g}
            den = {k: nu[k] - mu[k] ** 2 for k in g}
        else:
            den = nu
        return ({k: torch.rsqrt(den[k] + eps) * g[k] for k in g},
                {"mu": mu, "nu": nu})

    return Transform(init, update)


def trace(decay: float, nesterov: bool = False) -> Transform:
    def update(g, state, params=None):
        new = {k: g[k] + decay * state[k] for k in g}
        if nesterov:
            return {k: g[k] + decay * new[k] for k in g}, new
        return new, new

    return Transform(_zeros, update)


def scale(step_size: float) -> Transform:
    return Transform(
        lambda params: None,
        lambda g, state, params=None: (
            {k: step_size * v for k, v in g.items()}, state),
    )


def chain(*transforms: Transform) -> Transform:
    def init(params):
        return [t.init(params) for t in transforms]

    def update(g, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            g, s = t.update(g, s, params)
            new_state.append(s)
        return g, new_state

    return Transform(init, update)


def apply_updates(params: dict, updates: dict) -> dict:
    return {k: p + updates[k] for k, p in params.items()}


def _as_betas(value, default=(0.9, 0.999)):
    return default if value is None else tuple(value)


def make_optimizer(optim_cfg: dict) -> Transform:
    """The optimizer a reference-style config section names; an option
    the JAX package does not take raises (silently dropping it would
    change the training dynamics with no signal)."""
    name, kw = parse_optim_params(optim_cfg)
    name = name.lower()
    lr = float(kw.pop("lr", 1e-3))
    weight_decay = float(kw.pop("weight_decay", 0.0))
    steps = []
    if name in ("adam", "adamw"):
        betas = _as_betas(kw.pop("betas", None))
        adam = scale_by_adam(betas[0], betas[1], float(kw.pop("eps", 1e-8)),
                             amsgrad=bool(kw.pop("amsgrad", False)))
        decay = [add_decayed_weights(weight_decay)] if weight_decay else []
        steps = decay + [adam] if name == "adam" else [adam] + decay
    elif name == "sgd":
        momentum = float(kw.pop("momentum", 0.0))
        nesterov = bool(kw.pop("nesterov", False))
        if weight_decay:
            steps.append(add_decayed_weights(weight_decay))
        if momentum:
            steps.append(trace(momentum, nesterov))
        elif nesterov:
            raise ValueError("SGD nesterov requires momentum > 0")
    elif name == "rmsprop":
        alpha = float(kw.pop("alpha", 0.99))
        eps = float(kw.pop("eps", 1e-8))
        momentum = float(kw.pop("momentum", 0.0))
        centered = bool(kw.pop("centered", False))
        if weight_decay:
            steps.append(add_decayed_weights(weight_decay))
        steps.append(scale_by_rms(alpha, eps, centered=centered))
        if momentum:
            steps.append(trace(momentum))
    else:
        raise ValueError(f"unknown optimizer: {name}")
    if kw:
        raise ValueError(
            f"unsupported {name} optimizer option(s): {sorted(kw)}"
        )
    return chain(*steps, scale(-lr))


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> Transform:
    """``optax.adamw``: Adam's scaling, the decay added after it (kept in
    the chain at a decay of 0, so that the state has optax's three
    entries), then the step of ``-lr``."""
    return chain(scale_by_adam(b1, b2, eps),
                 add_decayed_weights(weight_decay), scale(-lr))


def sq_norm_sum(tree: dict) -> torch.Tensor:
    """The float32 sum of squares of every tensor of ``tree``; under
    ``parallel.tp.tp_products`` a sharded leaf's over all its shards."""
    tp = tp_active()
    if tp is not None:
        return tp.sq_sum(tree)
    return sum((g.to(torch.float32) ** 2).sum() for g in tree.values())


def clip_by_global_norm(grads: dict, max_norm: float):
    """Global-norm clipping: returns ``(clipped, the norm before)``; the
    scale is ``min(1, max_norm / max(norm, 1e-6))``."""
    norm = torch.sqrt(sq_norm_sum(grads))
    s = torch.clamp(max_norm / torch.clamp_min(norm, 1e-6), max=1.0)
    return {k: g * s for k, g in grads.items()}, norm
