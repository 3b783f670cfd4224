"""Loss-landscape analysis on parameter dictionaries (counterpart of
``msa_tts_tpu/analysis/landscapes.py``).

Replaces the reference's vendored loss-landscapes library
(msa_tts/utils/loss_landscapes/: ``random_plane`` 2-D surfaces with
filter/layer/model normalization, ``linear_interpolation``, the
trajectory trackers and the metric library) with direct algebra on
``{name: tensor}`` dictionaries, the port's ``state_dict`` layout: a
"direction" is such a dictionary with the parameters' names and shapes,
and the loss is evaluated by ``loss_fn(params) -> scalar`` on perturbed
copies.

Random draws are torch's, not threefry: every function that draws takes
the draw injected (``directions=``, ``bases=``), so a parity test feeds
both packages the JAX package's draws.  Where a function flattens a
dictionary into one vector it takes the values in sorted-name order, the
order ``jax.tree_util`` gives a dictionary's leaves.

Two choices differ from the JAX package on purpose:

- ``LossPerturbations`` draws fresh directions at every call from a
  generator it keeps (as the reference does); the JAX version reuses one
  key, so every call there draws the same directions.
- ``LossPerturbations`` reads ``alpha`` and ``n_directions`` at each
  call, so changing them after the first call takes effect; the JAX
  version bakes them in when it first traces.

``ExpectedReturn`` keeps the JAX version's uncapped rollout: an episode
runs until the environment says it is done, so an environment that never
ends one must cap it itself (gym's ``TimeLimit`` wrapper does).
"""

from __future__ import annotations

import os
from typing import Callable

import numpy as np
import torch


def _names(tree: dict) -> list:
    return sorted(tree)


def tree_rand_like(generator: torch.Generator | None, tree: dict) -> dict:
    """A standard-normal draw shaped like each tensor of ``tree`` (one
    draw per tensor, in sorted-name order, on ``generator``)."""
    out = {}
    for k in _names(tree):
        v = tree[k]
        out[k] = torch.randn(v.shape, generator=generator, dtype=v.dtype,
                             device=generator.device if generator else None
                             ).to(v.device)
    return {k: out[k] for k in tree}


def _filter_norms(x: torch.Tensor) -> torch.Tensor:
    """Per-filter L2 norm: the norm over all dims except the first
    (per output channel for conv / linear weights)."""
    if x.dim() <= 1:
        return torch.sqrt(torch.sum(x ** 2)).reshape([1] * max(x.dim(), 1))
    return torch.sqrt(torch.sum(x ** 2, dim=tuple(range(1, x.dim())),
                                keepdim=True))


def normalize_direction(direction: dict, params: dict,
                        mode: str = "filter") -> dict:
    """Scale a random direction to match the parameters' norms (the
    loss-landscapes normalization schemes): per filter, per layer, or
    over the whole model."""
    if mode == "filter":
        return {k: d * _filter_norms(params[k])
                / torch.clamp_min(_filter_norms(d), 1e-10)
                for k, d in direction.items()}
    if mode == "layer":
        return {k: d * torch.linalg.norm(params[k].flatten())
                / torch.clamp_min(torch.linalg.norm(d.flatten()), 1e-10)
                for k, d in direction.items()}
    if mode == "model":
        pn = torch.sqrt(sum(torch.sum(params[k] ** 2)
                            for k in _names(params)))
        dn = torch.sqrt(sum(torch.sum(direction[k] ** 2)
                            for k in _names(direction)))
        return {k: d * pn / torch.clamp_min(dn, 1e-10)
                for k, d in direction.items()}
    raise ValueError(f"unknown normalization: {mode}")


def _loss(loss_fn: Callable, params: dict) -> float:
    with torch.no_grad():
        return float(loss_fn(params))


def random_plane(loss_fn: Callable, params: dict, distance: float = 10.0,
                 steps: int = 16, normalization: str = "filter",
                 seed: int = 0, directions: tuple | None = None
                 ) -> np.ndarray:
    """Loss surface on a random 2-D plane through ``params``: a
    ``steps × steps`` grid of offsets spanning ``[-distance/2,
    +distance/2]`` along two directions, each normalized to the
    parameters' norms (``normalization``).

    ``directions``: the two raw (unnormalized) directions ``(d1, d2)``,
    dictionaries like ``params``; without it they are drawn from a
    generator seeded with ``seed``."""
    if directions is None:
        g = torch.Generator().manual_seed(seed)
        directions = (tree_rand_like(g, params), tree_rand_like(g, params))
    d1, d2 = (normalize_direction(
        {k: torch.as_tensor(d[k]).to(params[k]) for k in params}, params,
        normalization) for d in directions)
    alphas = np.linspace(-0.5, 0.5, steps) * distance
    betas = np.linspace(-0.5, 0.5, steps) * distance
    surface = np.zeros((steps, steps))
    for i, a in enumerate(alphas):
        for j, b in enumerate(betas):
            p = {k: p0 + a * d1[k] + b * d2[k] for k, p0 in params.items()}
            surface[i, j] = _loss(loss_fn, p)
    return surface


def linear_interpolation(loss_fn: Callable, params_start: dict,
                         params_end: dict, steps: int = 32) -> np.ndarray:
    """Loss along the line segment between two parameter sets
    (reference main.py:35-92)."""
    out = np.zeros(steps)
    for i, t in enumerate(np.linspace(0.0, 1.0, steps)):
        p = {k: (1.0 - t) * a + t * params_end[k]
             for k, a in params_start.items()}
        out[i] = _loss(loss_fn, p)
    return out


def bezier_path(loss_fn: Callable, params_start: dict, params_end: dict,
                control: dict, steps: int = 32) -> np.ndarray:
    """Loss along a quadratic Bézier curve between two parameter sets
    with one control point."""
    out = np.zeros(steps)
    for i, t in enumerate(np.linspace(0.0, 1.0, steps)):
        a, b, c = (1 - t) ** 2, 2 * (1 - t) * t, t ** 2
        p = {k: a * s + b * control[k] + c * params_end[k]
             for k, s in params_start.items()}
        out[i] = _loss(loss_fn, p)
    return out


def polygon_path(loss_fn: Callable, waypoints: list,
                 steps_per_segment: int = 16) -> np.ndarray:
    """Loss along the piecewise-linear path through ``waypoints``."""
    return np.concatenate([
        linear_interpolation(loss_fn, a, b, steps_per_segment)
        for a, b in zip(waypoints[:-1], waypoints[1:])])


def trajectory_distances(param_history: list) -> np.ndarray:
    """L2 distances of a parameter trajectory from its start."""
    start = param_history[0]
    return np.asarray([
        float(torch.sqrt(sum(torch.sum((p[k] - start[k]) ** 2)
                             for k in _names(p))))
        for p in param_history])


class TrajectoryTracker:
    """Base optimization-trajectory tracker (reference
    contrib/trajectories.py:13): positions are parameter dictionaries,
    stored as flat float32 vectors in sorted-name order."""

    def __getitem__(self, timestep: int) -> np.ndarray:
        raise NotImplementedError

    def get_item(self, timestep: int) -> np.ndarray:
        return self[timestep]

    def get_trajectory(self) -> list:
        raise NotImplementedError

    def save_position(self, params: dict) -> None:
        raise NotImplementedError

    @staticmethod
    def _flatten(params: dict) -> np.ndarray:
        return np.concatenate([
            params[k].detach().to("cpu", torch.float32).numpy().ravel()
            for k in _names(params)])


class FullTrajectoryTracker(TrajectoryTracker):
    """Stores the full parameter vector per timestep, spilled to
    ``directory/<idx>.npy`` (reference contrib/trajectories.py:56).
    Construction saves no position: call ``save_position`` per logged
    step."""

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self.next_idx = 0

    def __getitem__(self, timestep: int) -> np.ndarray:
        if not 0 <= timestep < self.next_idx:
            raise IndexError("Given timestep does not exist.")
        return np.load(os.path.join(self.dir, f"{timestep}.npy"))

    def save_position(self, params: dict) -> None:
        np.save(os.path.join(self.dir, f"{self.next_idx}.npy"),
                self._flatten(params))
        self.next_idx += 1

    def get_trajectory(self) -> list:
        return [self[i] for i in range(self.next_idx)]


class ProjectingTrajectoryTracker(TrajectoryTracker):
    """Projects each position onto ``n_bases`` fixed random directions
    at storage time (least squares; reference
    contrib/trajectories.py:93), so an N-step trajectory of an
    M-parameter model costs N·n_bases floats instead of N·M.

    ``bases``: the (M, k) directions, injected (``n_bases`` is then k);
    without it (M, ``n_bases``) are drawn from a generator seeded with
    ``seed``."""

    def __init__(self, params: dict, seed: int = 0, n_bases: int = 2, *,
                 bases=None):
        n = int(self._flatten(params).size)
        if bases is None:
            bases = torch.randn((n, n_bases), generator=torch.Generator()
                                .manual_seed(seed)).numpy()
        self.A = np.asarray(bases, np.float64)
        if self.A.ndim != 2 or self.A.shape[0] != n:
            raise ValueError(f"bases of shape {self.A.shape}, want "
                             f"({n}, n_bases)")
        self.trajectory: list[np.ndarray] = []

    def __getitem__(self, timestep: int) -> np.ndarray:
        return self.trajectory[timestep]

    def save_position(self, params: dict) -> None:
        b = self._flatten(params).astype(np.float64)
        self.trajectory.append(np.linalg.lstsq(self.A, b, rcond=None)[0])

    def get_trajectory(self) -> list:
        return self.trajectory


# --------------------------------------------------------------------------
# Metric library (reference metrics/{metric,sl_metrics,rl_metrics}.py):
# the live surface is Loss / LossGradient / LossPerturbations
# (sl_metrics.py:18-75) and ExpectedReturnMetric (rl_metrics.py:6-31).  A
# metric is a callable over a parameter dictionary; the supervised ones
# close over ``loss_fn(params) -> scalar`` (inputs and targets inside).
# --------------------------------------------------------------------------

class Metric:
    """A quantity evaluated at a point in parameter space (reference
    metric.py:8-26)."""

    def __call__(self, params: dict):
        raise NotImplementedError


class Loss(Metric):
    """The loss value at ``params`` (reference sl_metrics.py:18-27)."""

    def __init__(self, loss_fn: Callable):
        self._loss = loss_fn

    def __call__(self, params: dict) -> float:
        return _loss(self._loss, params)


class LossGradient(Metric):
    """The loss gradient at ``params`` as one numpy vector, the tensors
    in sorted-name order (reference sl_metrics.py:30-43)."""

    def __init__(self, loss_fn: Callable):
        self._loss = loss_fn

    def __call__(self, params: dict) -> np.ndarray:
        names = _names(params)
        p = {k: params[k].detach().requires_grad_(True) for k in params}
        with torch.enable_grad():
            g = torch.autograd.grad(self._loss(p), [p[k] for k in names],
                                    allow_unused=True)
        return np.concatenate([
            (torch.zeros_like(p[k]) if gk is None else gk).detach()
            .cpu().numpy().ravel() for k, gk in zip(names, g)])


class LossPerturbations(Metric):
    """Loss deltas along ``n_directions`` random directions scaled by
    ``alpha`` (reference sl_metrics.py:46-75, probabilistic curvature
    probing after Schuurmans et al.).

    Each call draws ``n_directions`` fresh directions (each tensor an
    independent standard-normal draw) from the generator the metric
    keeps, seeded with ``seed``, so repeated calls probe new directions
    as the reference does; ``directions=`` injects a call's list of
    direction dictionaries instead.  ``alpha`` and ``n_directions`` are
    read at every call."""

    def __init__(self, loss_fn: Callable, n_directions: int = 8,
                 alpha: float = 1.0, seed: int = 0):
        self._loss = loss_fn
        self.n_directions = int(n_directions)
        self.alpha = float(alpha)
        self._generator = torch.Generator().manual_seed(seed)

    def __call__(self, params: dict, directions: list | None = None
                 ) -> np.ndarray:
        if directions is None:
            directions = [tree_rand_like(self._generator, params)
                          for _ in range(self.n_directions)]
        base = _loss(self._loss, params)
        losses = [_loss(self._loss, {
            k: p0 + self.alpha * torch.as_tensor(d[k]).to(p0)
            for k, p0 in params.items()}) for d in directions]
        return np.asarray(losses) - base


class ExpectedReturn(Metric):
    """Average episodic return of ``policy_fn(params, obs) -> action``
    over ``n_episodes`` rollouts (reference rl_metrics.py:6-31).  The
    environment is duck-typed on the gym step API (``reset() -> obs``,
    ``step(action) -> (obs, reward, done, info)``), so no gym dependency
    is needed.  Each episode runs until the environment reports it done,
    as in the JAX version: the environment caps its own length."""

    def __init__(self, environment, policy_fn: Callable,
                 n_episodes: int = 1):
        self.environment = environment
        self.policy_fn = policy_fn
        self.n_episodes = int(n_episodes)

    def __call__(self, params: dict) -> float:
        returns = []
        for _ in range(self.n_episodes):
            obs = self.environment.reset()
            total, done = 0.0, False
            while not done:
                with torch.no_grad():
                    action = self.policy_fn(params, torch.as_tensor(obs))
                if isinstance(action, torch.Tensor):
                    action = action.detach().cpu().numpy()
                obs, reward, done, _ = self.environment.step(
                    np.asarray(action))
                total += float(reward)
            returns.append(total)
        return sum(returns) / len(returns)
