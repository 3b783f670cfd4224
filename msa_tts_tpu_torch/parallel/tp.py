"""Tensor parallelism: Megatron-style 1-D sharded weights and the
products that run on them (counterpart of ``msa_tts_tpu/parallel/tp.py``).

The layout is the JAX package's: every leaf of a parameter, optimizer or
model-state tree splits its largest axis that ``tp`` divides and that is
at least ``min_dim`` (the earliest among equals) into ``tp`` contiguous
blocks, and stays whole where none qualifies (:func:`tp_leaf_spec`).
The port's ``state_dict`` shapes are the JAX leaves' shapes, so the plan
(:func:`tp_shardings`, ``{name: axis | None}``) is the JAX package's leaf
for leaf.  For ``(4H, in)`` LSTM gate blocks and ``(out, in)``
projections that is mostly the output axis (column-parallel); an
attention projection whose input is the wider axis splits that one
(row-parallel).

The JAX package leaves the products to GSPMD.  Here they are explicit,
routed through one context (:func:`tp_products`, as
``ops.nn.synced_batchnorm`` routes batch-norm moments): inside it the
ops of ``ops/nn.py`` and ``ops/rnn.py`` read each weight's shards and
axis from a :class:`TensorParallel` and

  * a weight sharded on its output axis is column-parallel: the input
    goes to every shard (``copy``), each shard's product is local, and
    the outputs are joined (``gather``);
  * a weight sharded on its input axis is row-parallel: each shard takes
    its slice of the input (``scatter``), the partial products are summed
    (``reduce``), the bias is added once after the sum;
  * 1-D leaves (biases, batch-norm scales and statistics) are joined
    where they are used; an updated running statistic is cut back to its
    shard;
  * an LSTM's gates are joined before they split into i, f, g, o: with
    JAX's contiguous blocks the shards of the gate axis do not align
    with the four gates, and the layout is never reordered.

Everything outside the products runs whole on every shard, so a tp rank
differentiates the same loss as the others, and a weight held whole gets
the whole gradient everywhere.  Global norms and sums over the leaves
(:meth:`TensorParallel.sq_sum`, :func:`leaf_sum`) count a sharded leaf
over its shards and a whole one once.

Two transports carry the same products: a process group
(:class:`GroupTransport`, training: one rank per shard, Megatron's
conjugate operators of ``parallel/collectives.py``) and a list of
devices of one process (:class:`DeviceTransport`, serving: the shards'
products run one after another on their devices, and the collectives
are ``.to()``, ``torch.cat`` and a sum on the first device, which
autograd differentiates as it is).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from ..ops import nn as N
from . import collectives as C
from .mesh import Mesh


# ----------------------------------------------------------------- layout

def tp_leaf_spec(shape: tuple, tp: int, min_dim: int = 128):
    """The axis of ``shape`` a ``tp``-way layout splits: the largest one
    that ``tp`` divides and that is at least ``min_dim`` (the earliest
    among equals), or None (the leaf stays whole)."""
    best = None
    for ax, d in enumerate(shape):
        if d % tp == 0 and d >= min_dim:
            if best is None or d > shape[best]:
                best = ax
    return best


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return (type(tree)(*out) if hasattr(tree, "_fields")
                else type(tree)(out))
    return fn(tree, *rest)


def tp_shardings(tree, mesh: Mesh, min_dim: int = 128):
    """``tree`` (a ``state_dict``, an optimizer state, a model state)
    with each tensor replaced by the axis its shards split, None where it
    stays whole; all None on a mesh without a tp axis."""
    tp = mesh.tp

    def one(x):
        if tp == 1 or not isinstance(x, torch.Tensor):
            return None
        return tp_leaf_spec(tuple(x.shape), tp, min_dim)

    return _tree_map(one, tree)


def _tp_devices(mesh: Mesh) -> list:
    return list(mesh.devices.ravel())


def _block(x: torch.Tensor, axis: int, i: int, tp: int) -> torch.Tensor:
    n = x.shape[axis] // tp
    return x.narrow(axis, i * n, n)


def shard_tree_tp(tree, mesh: Mesh, min_dim: int = 128):
    """``tree`` in the tp layout.  On a mesh of ranks each sharded tensor
    becomes this rank's contiguous block (a copy; whole tensors stay);
    on a mesh of devices each tensor becomes the list of its shards, one
    on each device (a whole one: one tensor, on the first device)."""
    plan = tp_shardings(tree, mesh, min_dim)
    if mesh.rank is None:
        devices = _tp_devices(mesh)

        def place(x, ax):
            if not isinstance(x, torch.Tensor):
                return x
            if ax is None:
                return [x.to(devices[0])]
            return [_block(x, ax, i, len(devices)).to(d, copy=True)
                    for i, d in enumerate(devices)]

        return _tree_map(place, tree, plan)
    group = mesh.group("tp")

    def cut(x, ax):
        if ax is None or not isinstance(x, torch.Tensor):
            return x
        return _block(x, ax, group.index, group.size).clone()

    return _tree_map(cut, tree, plan)


def gather_tree_tp(tree, mesh: Mesh, plan):
    """The inverse of :func:`shard_tree_tp` for the ``plan`` it laid out
    (whole trees for checkpoints and voices): on a mesh of ranks an
    all-gather over the tp group (every tp rank must call it), on a mesh
    of devices the shards joined on the first device."""
    if mesh.rank is None:
        first = _tp_devices(mesh)[0]

        def join(ax, x):
            if not isinstance(x, list):
                return x
            if ax is None:
                return x[0].to(first)
            return torch.cat([s.to(first) for s in x], dim=ax)

        # walk the plan: its leaves stand where the tree holds shard lists
        return _tree_map(join, plan, tree)
    group = mesh.group("tp")

    def join(x, ax):
        if ax is None or not isinstance(x, torch.Tensor):
            return x
        return C._gather_dim(x, ax, group) if C._active(group) else x

    return _tree_map(join, tree, plan)


# ------------------------------------------------------------- transports

class GroupTransport:
    """One shard per rank of a tp process group (training)."""

    def __init__(self, group):
        self.group = group
        self.size = group.size
        self.index = group.index

    def copy(self, x):
        return [C.copy_to_tp(x, self.group)]

    def scatter(self, x, dim: int):
        return [C.scatter_to_tp(x, dim, self.group)]

    def gather(self, parts: list, dim: int):
        return C.gather_from_tp(parts[0], dim, self.group)

    def reduce(self, parts: list):
        return C.reduce_from_tp(parts[0], self.group)

    def own(self, full: torch.Tensor, axis: int) -> torch.Tensor:
        """This rank's block of a whole tensor."""
        return _block(full, axis, self.index, self.size)

    def sum_shards(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (a sum over this rank's shards) summed over the ranks,
        differentiably (the identity backward: every rank's loss is the
        same)."""
        return C.reduce_from_tp(x, self.group)


class DeviceTransport:
    """Every shard in this process, shard i on ``devices[i]`` (serving);
    whole tensors and outputs live on the first device."""

    def __init__(self, devices: list):
        self.devices = [torch.device(d) for d in devices]
        self.size = len(self.devices)
        self.first = self.devices[0]

    def copy(self, x):
        return [x.to(d) for d in self.devices]

    def scatter(self, x, dim: int):
        return [c.to(d) for c, d in zip(x.chunk(self.size, dim),
                                        self.devices)]

    def gather(self, parts: list, dim: int):
        return torch.cat([p.to(self.first) for p in parts], dim=dim)

    def reduce(self, parts: list):
        out = parts[0].to(self.first)
        for p in parts[1:]:
            out = out + p.to(self.first)
        return out

    def own(self, full: torch.Tensor, axis: int) -> torch.Tensor:
        """A statistic stays whole (the caller lays it out again)."""
        return full


# ---------------------------------------------------------------- context

class TensorParallel:
    """The partitioned products of one model under one plan.

    ``plan``: ``{state_dict name: axis | None}`` (:func:`tp_shardings`)
    over the parameters and the batch-norm state; ``model``: the module
    whose submodules the ops are handed (its names key the plan).  With
    a :class:`GroupTransport` the shards are the module's own tensors
    (``torch.func.functional_call`` puts this rank's shards there); with
    ``values`` (``{name: [shard, ...]}``, :func:`shard_tree_tp` on a mesh
    of devices) they are read from there, and the module's tensors only
    give their types."""

    def __init__(self, transport, plan: dict, model: torch.nn.Module,
                 values: dict | None = None):
        self.t = transport
        self.plan = plan
        self.values = values
        self._names = {m: p for p, m in model.named_modules()}

    def with_values(self, values: dict) -> "TensorParallel":
        """The same products on other shards (an adapted voice's)."""
        other = object.__new__(TensorParallel)
        other.__dict__.update(self.__dict__, values=values)
        return other

    # ------------------------------------------------------- the shards
    def name(self, mod, attr: str) -> str:
        prefix = self._names[mod]
        return f"{prefix}.{attr}" if prefix else attr

    def _local(self, mod, attr: str, dtype=None):
        """``(axis, [this process's shards])``, ``(None, None)`` for an
        absent tensor (a layer without bias); with ``dtype``, the shards
        at that type (the products run at their input's type: bfloat16
        shards in a float32 product are the float32 view of
        ``models.decoder.compute_view``)."""
        name = self.name(mod, attr)
        if self.values is None:
            v = getattr(mod, attr)
            vs = None if v is None else [v]
        else:
            vs = self.values.get(name)
        if vs is None:
            return None, None
        if dtype is not None and vs[0].dtype != dtype:
            vs = [v.to(dtype) for v in vs]
        return self.plan.get(name), vs

    def full(self, mod, attr: str, dtype=None):
        """The whole tensor ``mod.attr`` (joined where it is sharded)."""
        ax, vs = self._local(mod, attr, dtype)
        if vs is None:
            return None
        return vs[0] if ax is None else self.t.gather(vs, ax)

    def local_state(self, mod, attr: str, full: torch.Tensor):
        """An updated whole statistic cut back to this rank's shard."""
        ax = self.plan.get(self.name(mod, attr))
        return full if ax is None else self.t.own(full, ax)

    # ----------------------------------------------------- the products
    def _row(self, x, ws):
        return self.t.reduce([F.linear(xi, wi)
                              for xi, wi in zip(self.t.scatter(x, -1), ws)])

    def linear(self, mod, x):
        """``mod`` an ``nn.Linear``: ``x @ W.T + b``."""
        ax, ws = self._local(mod, "weight", x.dtype)
        if ax is None:
            return F.linear(x, ws[0], self.full(mod, "bias", x.dtype))
        bax, bs = self._local(mod, "bias", x.dtype)
        if ax == 0 and bax == 0:
            return self.t.gather([F.linear(xi, wi, bi) for xi, wi, bi in
                                  zip(self.t.copy(x), ws, bs)], -1)
        if ax == 0:
            y = self.t.gather([F.linear(xi, wi) for xi, wi in
                               zip(self.t.copy(x), ws)], -1)
        else:
            y = self._row(x, ws)
        b = self.full(mod, "bias")
        return y if b is None else y + b

    def conv1d(self, mod, x, padding: int):
        """``mod`` an ``nn.Conv1d`` on ``(B, C, T)``."""
        ax, ws = self._local(mod, "weight", x.dtype)
        if ax not in (0, 1):       # whole, or split on the kernel axis
            return F.conv1d(x, self.full(mod, "weight", x.dtype),
                            self.full(mod, "bias", x.dtype),
                            padding=padding)
        bax, bs = self._local(mod, "bias", x.dtype)
        if ax == 0 and bax == 0:
            return self.t.gather(
                [F.conv1d(xi, wi, bi, padding=padding) for xi, wi, bi in
                 zip(self.t.copy(x), ws, bs)], 1)
        if ax == 0:
            y = self.t.gather([F.conv1d(xi, wi, padding=padding) for xi, wi
                               in zip(self.t.copy(x), ws)], 1)
        else:
            y = self.t.reduce([F.conv1d(xi, wi, padding=padding) for xi, wi
                               in zip(self.t.scatter(x, 1), ws)])
        b = self.full(mod, "bias")
        return y if b is None else y + b[:, None]

    def embedding(self, mod, ids):
        """``mod`` an ``nn.Embedding``; split on its width, each shard
        looks up its columns."""
        ax, ws = self._local(mod, "weight")
        if ax == 1:
            return self.t.gather([F.embedding(ids.to(w.device), w)
                                  for w in ws], -1)
        return F.embedding(ids, self.full(mod, "weight"))

    # LSTM gates: a projection is the list of its shards' slices of the
    # gate axis (column-parallel) or a whole tensor; both kinds add up
    # shard by shard, and the gates are whole before they split
    def _proj(self, mod, x, attr: str):
        ax, ws = self._local(mod, attr, x.dtype)
        if ax == 0:
            return [xi @ wi.T for xi, wi in zip(self.t.copy(x), ws)]
        if ax == 1:
            return self._row(x, ws)
        return x @ ws[0].T

    def _vec(self, mod, attr: str):
        ax, vs = self._local(mod, attr)
        return vs if ax == 0 else vs[0]

    def _add(self, a, b):
        if isinstance(a, list) and isinstance(b, list):
            return [p + q for p, q in zip(a, b)]
        return self._whole(a) + self._whole(b)

    def _whole(self, a):
        return self.t.gather(a, -1) if isinstance(a, list) else a

    def lstm_gates(self, cell, x, h):
        """``x @ W_ih.T + h @ W_hh.T + b_ih + b_hh`` of an
        ``nn.LSTMCell``, whole."""
        g = self._add(self._proj(cell, x, "weight_ih"),
                      self._proj(cell, h, "weight_hh"))
        g = self._add(g, self._vec(cell, "bias_ih"))
        return self._whole(self._add(g, self._vec(cell, "bias_hh")))

    def lstm_scan_gates(self, lstm, x, suffix: str):
        """One direction of a one-layer ``nn.LSTM`` over ``x`` (B, T, D):
        the input projection hoisted, and ``gates(t, h)``, step t's whole
        gates."""
        xp = self._add(self._add(
            self._proj(lstm, x, f"weight_ih_l0{suffix}"),
            self._vec(lstm, f"bias_ih_l0{suffix}")),
            self._vec(lstm, f"bias_hh_l0{suffix}"))

        def gates(t: int, h):
            xt = ([p[:, t] for p in xp] if isinstance(xp, list)
                  else xp[:, t])
            return self._whole(self._add(
                xt, self._proj(lstm, h, f"weight_hh_l0{suffix}")))

        return gates

    # ------------------------------------------------- sums over leaves
    def _split(self, tree: dict):
        sharded = [k for k in tree if self.plan.get(k) is not None]
        whole = [k for k in tree if self.plan.get(k) is None]
        return sharded, whole

    def leaf_sum(self, terms: dict):
        """``Σ terms`` (one scalar per leaf, keyed by name), a sharded
        leaf's over all its shards: differentiable, the same on every
        rank."""
        sharded, whole = self._split(terms)
        total = None
        if sharded:
            total = self.t.sum_shards(sum(terms[k] for k in sharded))
        for k in whole:
            total = terms[k] if total is None else total + terms[k]
        return total

    def sq_sum(self, tree: dict) -> torch.Tensor:
        """The float32 sum of squares of every tensor of ``tree`` (keyed
        by name), each sharded leaf over all its shards."""
        with torch.no_grad():
            return self.leaf_sum({k: (v.to(torch.float32) ** 2).sum()
                                  for k, v in tree.items()})


@contextlib.contextmanager
def tp_products(tp: TensorParallel | None):
    """Within this context (of the calling thread only) the ops of
    ``ops/nn.py`` and ``ops/rnn.py`` run ``tp``'s partitioned products,
    the norms of ``optim.py`` and ``meta/grad_utils.py`` count its shards
    (nothing changes when ``tp`` is None)."""
    if tp is None:
        yield
        return
    token = N._TP.set(tp)
    try:
        yield tp
    finally:
        N._TP.reset(token)


def leaf_sum(terms: dict):
    """``Σ terms`` over leaves (see :meth:`TensorParallel.leaf_sum`); the
    plain sum outside :func:`tp_products`."""
    tp = N._TP.get()
    if tp is None:
        return sum(terms.values())
    return tp.leaf_sum(terms)
