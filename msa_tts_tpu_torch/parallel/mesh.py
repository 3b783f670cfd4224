"""The mesh: a ``(dp, task)`` grid, or ``(dp, task, tp)`` with a
tensor-parallel degree above 1, over the ranks of a
``torch.distributed`` world (training) or over the devices of one
process (serving); counterpart of ``msa_tts_tpu/parallel/mesh.py``.

  * ``dp``   — data parallel (batch / shot axis),
  * ``task`` — task parallel (meta-learning speaker axis),
  * ``tp``   — tensor parallel (the weights' shards, ``parallel/tp.py``).

Training runs one process per device, as ``torchrun`` starts them.  Rank
``r`` sits at ``(r // (task·tp), (r // tp) % task, r % tp)``, the JAX
package's row-major device order with tp innermost.  Every rank builds
one process group per axis, one for the data axes ``("dp", "task")`` and
one for the whole mesh (``dist.new_group``), so :func:`make_mesh` is
collective: every rank of the world calls it, in the same order.  The
group of an axis holds the ranks that share this rank's other
coordinates; so the data group is one per tp coordinate, and a gradient
summed over it sums shards of one index only.  A group of one rank gets
no process group (its collectives are the identity), except a group that
is the whole world, which is the world's own.

The backend is the device's: NCCL for CUDA, gloo for the CPU, unless the
caller initialized the process group first (then that one is used).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

AXES = ("dp", "task")          # the data axes a batch splits over
ALL = ("dp", "task", "tp")     # the whole mesh


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
    """A ``(dp, task)`` or ``(dp, task, tp)`` grid.  ``devices`` holds the
    global ranks (training) or the ``torch.device`` of each shard
    (serving); ``rank`` is this process's rank (None on a device mesh or
    for a rank outside the grid), ``coords`` its position and ``groups``
    its :class:`AxisGroup` per axis name, for ``("dp", "task")`` and for
    the whole mesh.  ``shape`` names ``tp`` only when the grid has it."""

    def __init__(self, grid: np.ndarray, *, rank=None, groups=None):
        self.devices = grid
        self.axis_names = ALL[: grid.ndim]
        self.shape = dict(zip(self.axis_names, grid.shape))
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

    @property
    def tp(self) -> int:
        return self.shape.get("tp", 1)

    def group(self, axes) -> AxisGroup:
        """The group along ``axes`` (``"dp"``, ``"task"``, ``"tp"``, the
        data axes, or every axis of the mesh: :data:`ALL`)."""
        key = tuple(axes) if not isinstance(axes, str) else (axes,)
        if set(key) >= set(self.axis_names):
            key = ALL if "tp" in self.axis_names else AXES
        elif set(key) == set(AXES):
            key = AXES
        return self.groups[key]

    def __repr__(self):
        kind = "ranks" if self.groups else "devices"
        dims = ", ".join(f"{k}={v}" for k, v in self.shape.items())
        return f"Mesh({dims}, {kind}={self.devices.ravel().tolist()})"


def world() -> tuple[int, int]:
    """``(rank, world size)``: ``(0, 1)`` when no process group is up."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _new_group(members: list, all_ranks: list):
    if members == all_ranks:
        return dist.group.WORLD
    if len(members) == 1:
        return None
    return dist.new_group(members)


def make_mesh(dp: int | None = None, task: int = 1, tp: int = 1,
              devices=None) -> Mesh:
    """A ``(dp, task)`` mesh, or ``(dp, task, tp)`` when ``tp > 1``;
    ``dp=None`` takes what is left of the world (or of ``devices``).
    Without ``devices`` the grid is the world's ranks (every rank must
    call this); with ``devices`` (a list of ``torch.device`` or names) it
    lays out those devices of this process for a sharded decode.  A mesh
    larger than what it lays out raises."""
    tp = int(tp or 1)
    task = int(task)
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
    dims = (dp, task, tp) if tp > 1 else (dp, task)
    grid = np.empty(dp * task * tp, dtype=object)
    grid[:] = items[: dp * task * tp]
    grid = grid.reshape(dims)
    if devices is not None:
        return Mesh(grid)
    names = ALL[: len(dims)]
    if not (dist.is_available() and dist.is_initialized()):
        single = AxisGroup(None, (0,), 0)
        return Mesh(grid.astype(np.int64), rank=0,
                    groups={k: single for k in [("dp",), ("task",), AXES]})
    grid = grid.astype(np.int64)
    all_ranks = list(range(n))
    groups = {}
    # every rank creates every group, in one order (new_group is
    # collective); a rank keeps the groups it belongs to
    for axes in [(a,) for a in names] + [AXES] + ([ALL] if tp > 1 else []):
        kept = [names.index(a) for a in axes if a in names]
        rest = [i for i in range(len(dims)) if i not in kept]
        # the ranks along `kept`, one block per coordinate of `rest`
        blocks = grid.transpose(rest + kept).reshape(
            -1, int(np.prod([dims[i] for i in kept])))
        for members in blocks.tolist():
            pg = _new_group(members, all_ranks)
            if rank in members:
                groups[axes] = AxisGroup(pg, tuple(members),
                                         members.index(rank))
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
