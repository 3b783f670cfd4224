"""The mesh: a ``(dp, task)`` grid over the ranks of a
``torch.distributed`` world (training) or over the devices of one
process (serving); counterpart of ``msa_tts_tpu/parallel/mesh.py``.

  * ``dp``   — data parallel (batch / shot axis),
  * ``task`` — task parallel (meta-learning speaker axis).

Training runs one process per device, as ``torchrun`` starts them.  Rank
``r`` sits at ``(r // task, r % task)``, the JAX package's row-major
device order; every rank builds one process group per axis and one for
both (``dist.new_group``), so :func:`make_mesh` is collective: every rank
of the world calls it, in the same order.  A group of one rank gets no
process group (its collectives are the identity), except the group of
both axes when the mesh is the whole world, which is the world's own.

The backend is the device's: NCCL for CUDA, gloo for the CPU, unless the
caller initialized the process group first (then that one is used).
Tensor parallelism (``tp > 1``) is not ported yet.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

AXES = ("dp", "task")
TP_NOT_PORTED = ("parallel: tp > 1 (tensor parallelism) is not ported to "
                 "the PyTorch package yet (ROADMAP.md item 22b)")


@dataclass(frozen=True)
class AxisGroup:
    """The ranks along one axis (or both) that share this rank's other
    coordinates: ``pg`` their process group (None for a group of one
    with no process group), ``ranks`` their global ranks in axis order,
    ``index`` this rank's position among them."""

    pg: object
    ranks: tuple
    index: int

    @property
    def size(self) -> int:
        return len(self.ranks)


class Mesh:
    """A ``(dp, task)`` grid.  ``devices`` holds the global ranks
    (training) or the ``torch.device`` of each shard (serving); ``rank``
    is this process's rank (None on a device mesh or for a rank outside
    the grid), ``coords`` its ``(dp, task)`` position and ``groups`` its
    :class:`AxisGroup` per axis name and for ``("dp", "task")``."""

    axis_names = AXES

    def __init__(self, grid: np.ndarray, *, rank=None, groups=None):
        self.devices = grid
        self.shape = dict(zip(AXES, grid.shape))
        self.size = int(grid.size)
        self.rank = rank
        self.groups = groups or {}
        self.coords = None
        if rank is not None:
            hit = np.argwhere(grid == rank)
            self.coords = tuple(int(i) for i in hit[0]) if len(hit) else None

    @property
    def member(self) -> bool:
        """Whether this rank is one of the grid's."""
        return self.coords is not None

    def group(self, axes) -> AxisGroup:
        """The group along ``axes`` (``"dp"``, ``"task"`` or both)."""
        key = tuple(axes) if not isinstance(axes, str) else (axes,)
        if set(key) == set(AXES):
            key = AXES
        return self.groups[key]

    def __repr__(self):
        kind = "ranks" if self.groups else "devices"
        return (f"Mesh(dp={self.shape['dp']}, task={self.shape['task']}, "
                f"{kind}={self.devices.ravel().tolist()})")


def world() -> tuple[int, int]:
    """``(rank, world size)``: ``(0, 1)`` when no process group is up."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _new_group(members: list, all_ranks: list):
    if len(members) == 1 and len(all_ranks) > 1:
        return None
    if members == all_ranks:
        return dist.group.WORLD
    return dist.new_group(members)


def make_mesh(dp: int | None = None, task: int = 1, tp: int = 1,
              devices=None) -> Mesh:
    """A ``(dp, task)`` mesh; ``dp=None`` takes what is left of the world
    (or of ``devices``).  Without ``devices`` the grid is the world's
    ranks (every rank must call this); with ``devices`` (a list of
    ``torch.device`` or names) it lays out those devices of this process
    for a sharded decode.  A mesh larger than what it lays out raises;
    ``tp > 1`` raises ``NotImplementedError``."""
    tp = int(tp or 1)
    task = int(task)
    if tp > 1:
        raise NotImplementedError(TP_NOT_PORTED)
    if devices is not None:
        items = [torch.device(d) for d in devices]
        rank, n = None, len(items)
    else:
        rank, n = world()
        items = list(range(n))
    if dp is None:
        if n % (task * tp) != 0:
            raise ValueError(
                f"{n} devices not divisible by task={task} x tp={tp}")
        dp = n // (task * tp)
    dp = int(dp)
    if dp * task * tp > n:
        raise ValueError(f"mesh {dp}x{task}x{tp} needs {dp * task * tp} "
                         f"devices, have {n}")
    grid = np.empty(dp * task, dtype=object)
    grid[:] = items[: dp * task]
    grid = grid.reshape(dp, task)
    if devices is not None:
        return Mesh(grid)
    if not (dist.is_available() and dist.is_initialized()):
        single = AxisGroup(None, (0,), 0)
        return Mesh(grid.astype(np.int64), rank=0,
                    groups={("dp",): single, ("task",): single,
                            AXES: single})
    grid = grid.astype(np.int64)
    all_ranks = list(range(n))
    mesh_ranks = grid.ravel().tolist()
    groups = {}
    # every rank creates every group, in one order (new_group is
    # collective); a rank keeps the groups it belongs to
    for t in range(task):
        members = grid[:, t].tolist()
        pg = _new_group(members, all_ranks)
        if rank in members:
            groups[("dp",)] = AxisGroup(pg, tuple(members),
                                        members.index(rank))
    for d in range(dp):
        members = grid[d, :].tolist()
        pg = _new_group(members, all_ranks)
        if rank in members:
            groups[("task",)] = AxisGroup(pg, tuple(members),
                                          members.index(rank))
    pg = (dist.group.WORLD if mesh_ranks == all_ranks
          else dist.new_group(mesh_ranks))
    if rank in mesh_ranks:
        groups[AXES] = AxisGroup(pg, tuple(mesh_ranks),
                                 mesh_ranks.index(rank))
    return Mesh(grid, rank=rank, groups=groups)


def single_device_mesh() -> Mesh:
    return make_mesh(dp=1, task=1)


def init_from_env(device: str | None) -> torch.device | None:
    """Initialize the default process group from ``torchrun``'s variables
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``) when none is up yet, and
    return the rank's device: ``device`` where it names one, else
    ``cuda:LOCAL_RANK`` (also for a bare ``cuda``).  Returns None (and
    initializes nothing) when a group is already up or the variables are
    not set."""
    env = ("RANK", "WORLD_SIZE", "LOCAL_RANK")
    if dist.is_initialized() or not all(k in os.environ for k in env):
        return None
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method="env://")
    return dev
