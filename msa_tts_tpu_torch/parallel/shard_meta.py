"""Task- and shot-sharded meta steps (counterpart of
``msa_tts_tpu/parallel/shard_meta.py``).

Episodes are stacked ``(K tasks, S shots, ...)``.  The JAX package
``shard_map``s its meta step over a ``(dp, task)`` mesh: tasks over
``task``, shots over ``dp``, with three explicit reductions.  Here every
rank runs the port's task loop (``meta/maml.py``, ``meta/reptile.py``)
on its block, and a :class:`Placement` supplies those reductions:

  * inner-loop gradients and losses: averaged over ``dp`` inside the
    differentiated graph (``meta/inner_loop.py``, ``group``), so every
    rank of a task row adapts to the same parameters, and a second-order
    step differentiates through the average;
  * per-task query losses: averaged over ``dp``;
  * outer gradients: each rank adds ``∂(query_loss / (K·dp))`` of its
    own tasks and shots, and one flat all-reduce over the mesh sums them.

Batch norm inside the step is local to the rank, as in JAX's
``shard_map`` body; the carried batch-norm state is the mean over the
mesh of each rank's mean over its tasks.  Each task's dropout masks are
indexed by its global task id and cut to the rank's shots, so the step
sees the single-process run's noise.

The trainers use the 1-D layout, tasks over every rank in (task, dp)
order and no shot split (:func:`task_placement`); the 2-D layout of the
library steps below is :func:`episode_sharding_2d`.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..meta.maml import make_maml_step
from ..meta.reptile import make_reptile_step
from ..models.tacotron2nv import mask_rows
from ..optim import Transform
from . import collectives as C
from .mesh import AXES, Mesh
from .sharding import Layout, task_batch_sharding


class Placement:
    """Where a meta-step's tasks (``task_axes``) and shots
    (``shot_axes``) lie on ``mesh``, and the reductions that follow."""

    def __init__(self, mesh: Mesh, task_axes: tuple, shot_axes: tuple = ()):
        self.mesh = mesh
        self.tasks = Layout(mesh, task_axes)
        self.shots = Layout(mesh, shot_axes)
        self.shot_group = self.shots.group()
        self.all = mesh.group(AXES)

    def task_ids(self, k_loc: int) -> range:
        """The global ids of this rank's ``k_loc`` tasks."""
        i = self.tasks.index
        return range(i * k_loc, (i + 1) * k_loc)

    def n_tasks(self, k_loc: int) -> int:
        return k_loc * self.tasks.parts

    @property
    def shot_parts(self) -> int:
        return self.shots.parts

    def task_masks(self, masks: list, s_loc: int) -> list:
        """One task's per-pass masks cut to this rank's shots."""
        if self.shots.parts == 1:
            return masks
        rows = self.shots.rows(s_loc * self.shots.parts)
        return [mask_rows(m, rows) for m in masks]

    def sum_grads(self, grads: dict) -> dict:
        return dict(zip(grads, C.all_reduce_flat(list(grads.values()),
                                                 self.all)))

    def shot_mean(self, t: torch.Tensor) -> torch.Tensor:
        if self.shots.parts == 1:
            return t
        return C.all_reduce(t, self.shot_group) * (1.0 / self.shots.parts)

    def gather_tasks(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``(k_loc, ...)`` rows as ``(K, ...)`` in global
        task order (ranks of one task block hold the same rows)."""
        if self.tasks.parts == 1:
            return t
        group = self.tasks.group()
        parts = C.all_gather(t, group).chunk(group.size)
        order = [self.tasks.block_of_rank(r) for r in group.ranks]
        return torch.cat([parts[order.index(b)]
                          for b in range(self.tasks.parts)])

    def merge_states(self, states: list, like: dict) -> dict:
        """The sharded ``meta.maml.merge_task_states`` (JAX's
        ``_merge_task_states_sharded``): floating tensors
        average over every rank's tasks, the rest come from this rank's
        first task."""
        names = [k for k in like if states[0][k].is_floating_point()]
        local = [torch.stack([st[k] for st in states]).sum(dim=0)
                 for k in names]
        total = C.all_reduce_flat(local, self.all)
        n = len(states) * self.all.size
        out = {k: states[0][k].detach().to(like[k].dtype) for k in like}
        for k, s in zip(names, total):
            out[k] = (s * (1.0 / n)).to(like[k].dtype)
        return out


def task_placement(mesh: Mesh) -> Placement:
    """The trainers' layout: tasks over every rank in (task, dp) order
    (``sharding.task_batch_sharding``), shots whole."""
    return Placement(mesh, task_batch_sharding(mesh).axes)


def episode_sharding_2d(mesh: Mesh) -> tuple:
    """(K, S, ...) stacked episodes: ``(task layout, shot layout)``,
    tasks over ``task`` and shots over ``dp``."""
    return Layout(mesh, ("task",)), Layout(mesh, ("dp",))


def shard_task_batch_2d(batch: dict, mesh: Mesh) -> dict:
    """This rank's block of stacked episodes, the 2-D layout."""
    tl, sl = episode_sharding_2d(mesh)
    v0 = next(iter(batch.values()))
    rows, cols = tl.rows(v0.shape[0]), sl.rows(v0.shape[1])
    return {k: v[rows][:, cols] for k, v in batch.items()}


def make_sharded_maml_step(loss_fn: Callable, inner_tx: Transform,
                           outer_tx: Transform, n_inner: int, mesh: Mesh, *,
                           second_order: bool = True,
                           clip_thresh: float | None = None):
    """The 2-D sharded ``maml_step(state, support, query, masks)``: the
    contract and math of ``meta.maml.make_maml_step`` (equal up to the
    order of float sums), ``support`` / ``query`` this rank's block from
    :func:`shard_task_batch_2d`, ``masks`` the global ``[K][pass]`` masks
    (``None`` entries for a loss that draws none).  ``K`` must divide by
    the mesh's ``task`` extent and ``S`` by its ``dp``."""
    return make_maml_step(loss_fn, inner_tx, outer_tx, n_inner,
                          second_order=second_order, clip_thresh=clip_thresh,
                          placement=Placement(mesh, ("task",), ("dp",)))


def make_sharded_reptile_step(loss_fn: Callable, inner_tx: Transform,
                              outer_tx: Transform, n_inner: int, mesh: Mesh,
                              *, clip_thresh: float | None = None):
    """The 2-D sharded batched-mode Reptile step (the contract of
    ``meta.reptile.make_reptile_step(mode="batched")``, episodes placed
    by :func:`shard_task_batch_2d`).  Sequential Reptile applies its
    outer update between tasks: only its shots could shard."""
    return make_reptile_step(loss_fn, inner_tx, outer_tx, n_inner,
                             mode="batched", clip_thresh=clip_thresh,
                             placement=Placement(mesh, ("task",), ("dp",)))
