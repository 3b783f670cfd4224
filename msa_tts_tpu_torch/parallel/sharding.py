"""Row layouts, placement and the vocoders' data-parallel kit
(counterpart of ``msa_tts_tpu/parallel/sharding.py``).

Layout policy, as the JAX package's: parameters and optimizer state are
replicated over the data axes (every rank holds all of them, or with
tensor parallelism all of its tp coordinate's shards, ``parallel/tp.py``,
and they stay equal bit for bit because every rank applies the same
reduced gradient); a joint batch
is split on its rows over dp·task; meta-training episodes on their task
axis.  Each JAX ``NamedSharding`` becomes a :class:`Layout`: which
contiguous rows of the global tensor a rank holds.

  * ``P(("dp", "task"))`` — blocks in row-major order over (dp, task),
    so rank ``r`` holds block ``r`` (:func:`batch_sharding`);
  * ``P(("task", "dp"))`` — blocks in (task, dp) order
    (:func:`task_batch_sharding`, 1-D episodes);
  * ``P()`` — every rank holds every row (:func:`replicated`).

``jit_with_mesh`` (XLA's jit with the layouts propagated) is not carried
over: the steps here slice their inputs and reduce explicitly.
"""

from __future__ import annotations

import numpy as np
import torch

from . import collectives as C
from .mesh import ALL, AXES, Mesh, make_mesh


class Layout:
    """Rows over the mesh axes ``axes`` (empty: replicated)."""

    def __init__(self, mesh: Mesh, axes: tuple = ()):
        self.mesh = mesh
        self.axes = tuple(axes)

    @property
    def parts(self) -> int:
        return int(np.prod([self.mesh.shape[a] for a in self.axes]))

    @property
    def index(self) -> int:
        """This rank's block."""
        return self.block_of_rank(self.mesh.rank)

    def block_of_rank(self, rank: int) -> int:
        """The block ``rank`` holds (row-major over ``axes`` of its
        coordinates)."""
        coords = np.argwhere(self.mesh.devices == rank)[0]
        i = 0
        for a in self.axes:
            i = (i * self.mesh.shape[a]
                 + int(coords[self.mesh.axis_names.index(a)]))
        return i

    def rows(self, n: int, index: int | None = None) -> slice:
        """Block ``index`` (default this rank's) of ``n`` rows."""
        if n % self.parts:
            raise ValueError(f"{n} rows do not split into {self.parts} "
                             f"blocks over {self.axes}")
        i = self.index if index is None else index
        b = n // self.parts
        return slice(i * b, (i + 1) * b)

    def group(self) -> C.AxisGroup | None:
        """The group a reduction over the layout's rows runs in."""
        return self.mesh.group(self.axes) if self.axes else None


def replicated(mesh: Mesh) -> Layout:
    return Layout(mesh, ())


def batch_sharding(mesh: Mesh) -> Layout:
    """The leading (batch) axis over dp·task (all ranks)."""
    return Layout(mesh, AXES)


def task_batch_sharding(mesh: Mesh) -> Layout:
    """(K, S, ...) stacked episodes, the task axis over all ranks in
    (task, dp) order: the trainers' meta-step layout."""
    return Layout(mesh, ("task", "dp"))


def take_rows(tree, rows: slice):
    """``tree``'s tensors cut to ``rows`` of their leading axis."""
    if isinstance(tree, dict):
        return {k: take_rows(v, rows) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(take_rows(v, rows) for v in tree)
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return tree[rows]
    return tree


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows of a global batch, the joint layout."""
    n = int(next(iter(batch.values())).shape[0])
    return take_rows(batch, batch_sharding(mesh).rows(n))


def shard_task_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's tasks of stacked (K, S, ...) episodes."""
    n = int(next(iter(batch.values())).shape[0])
    return take_rows(batch, task_batch_sharding(mesh).rows(n))


def _leaves(tree, out: list):
    if isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    elif isinstance(tree, torch.Tensor):
        out.append(tree)
    return out


def _refill(tree, it):
    if isinstance(tree, dict):
        return {k: _refill(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_refill(v, it) for v in tree]
        return (type(tree)(*out) if hasattr(tree, "_fields")
                else type(tree)(out))
    if isinstance(tree, torch.Tensor):
        return next(it)
    return tree


def replicate_state(state, mesh: Mesh):
    """``state`` (any tree of tensors) as the mesh's first rank holds it:
    one broadcast per type over the whole mesh."""
    group = mesh.group(ALL)
    if group.pg is None:
        return state
    return _refill(state, iter(C.broadcast_flat(_leaves(state, []), group)))


class DpShard:
    """Data-parallel kit of the vocoder trainers: one process per rank,
    the parameters and optimizer state replicated, each batch split on
    its rows over dp·task and the gradients summed over the ranks.  Built
    from the ``parallel: {dp: N}`` block the acoustic trainers read;
    ``from_params`` returns None when there is no block."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.layout = batch_sharding(mesh)
        self.group = mesh.group(AXES)
        self._said = False

    @classmethod
    def from_params(cls, params: dict):
        pcfg = params.get("parallel")
        if not pcfg:
            return None
        if int(pcfg.get("tp", 1)) > 1:
            raise NotImplementedError(
                "parallel: {tp: N} is not supported for the vocoder "
                "trainers (DpShard is dp/task only) — tensor "
                "parallelism is an acoustic-trainer/serving feature")
        mesh = make_mesh(dp=pcfg.get("dp"), task=int(pcfg.get("task", 1)))
        if not mesh.member:
            raise ValueError(f"rank {mesh.rank} is outside {mesh}")
        print(f"[parallel] mesh dp={mesh.shape['dp']} "
              f"task={mesh.shape['task']} ({mesh.size} ranks)")
        return cls(mesh)

    @property
    def is_writer(self) -> bool:
        return self.group.index == 0

    def replicate(self, tree):
        return replicate_state(tree, self.mesh)

    def parts_for(self, n: int) -> int:
        """How many blocks a batch of ``n`` rows splits into: the ranks,
        or 1 (replicated) when ``n`` does not divide (printed once)."""
        if n % self.layout.parts == 0:
            return self.layout.parts
        if not self._said:
            print(f"[parallel] a batch of {n} rows does not split over "
                  f"{self.layout.parts} ranks: replicated")
            self._said = True
        return 1

    def put_batch(self, *arrays):
        """Each array cut to this rank's rows (whole where the batch does
        not split)."""
        n = int(arrays[0].shape[0])
        out = arrays if self.parts_for(n) == 1 else tuple(
            a[self.layout.rows(n)] for a in arrays)
        return tuple(out) if len(out) > 1 else out[0]

    def mean_grads(self, grads: dict, n_rows: int) -> dict:
        """``grads`` of each rank's mean loss averaged over the ranks (one
        flat collective): the gradient of the global batch's mean loss.
        Unchanged for a replicated batch, which every rank took whole."""
        parts = self.parts_for(n_rows)
        if parts == 1:
            return grads
        summed = C.all_reduce_flat(list(grads.values()), self.group)
        return {k: g * (1.0 / parts) for k, g in zip(grads, summed)}

    def mean_metrics(self, metrics: dict, n_rows: int) -> dict:
        """Scalar metrics averaged over the ranks (one collective)."""
        if self.parts_for(n_rows) == 1 or not metrics:
            return metrics
        vals = torch.stack([torch.as_tensor(v, dtype=torch.float32)
                            for v in metrics.values()])
        vals = C.all_reduce(vals, self.group) * (1.0 / self.layout.parts)
        return dict(zip(metrics, vals.unbind(0)))

    def barrier(self) -> None:
        C.barrier(self.group)

