"""The collectives the sharded steps need, over a mesh's
:class:`~.mesh.AxisGroup` (a group of one, or None, is the identity).

The JAX package gets its reductions from GSPMD and ``shard_map``
(``psum`` / ``pmean``); here they are explicit ``torch.distributed``
calls.  Gradients travel as one flat buffer per step
(:func:`all_reduce_flat`), not one call per tensor.

Differentiation.  :func:`all_reduce_sum` inside a differentiated graph
(batch-norm moments over the data group, the inner gradients of the 2-D
meta step) is an autograd function whose backward is the all-reduce sum
of the cotangents: the exact transpose of the map from every rank's
input to every rank's output.  Each rank differentiates its own share of
the global loss (the shares sum to it), so the sum over ranks of the
ranks' gradients, which the step then all-reduces, is the gradient of
the global loss.  (Differentiating a value that every rank holds
replicated, as if each copy were the loss, would count it once per rank:
``world`` times the gradient.)  The backward builds its own graph, so
a second-order step differentiates through it again.

Tensor parallelism.  Megatron's four conjugate operators over a tp
group (:func:`copy_to_tp`, :func:`reduce_from_tp`, :func:`gather_from_tp`,
:func:`scatter_to_tp`) carry the partitioned products of
``parallel/tp.py``: each is an autograd function whose backward is its
conjugate's forward, through the conjugate's own autograd function, so
that a second-order step differentiates through it again.

The backend takes the tensors where they are: NCCL those on the card,
gloo those on the CPU and, for ranks that share one card, those on it
(gloo's all-reduce, all-gather and broadcast of CUDA tensors, which
chip_smoke phase 16 checks on the card).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import AxisGroup


def _active(group: AxisGroup | None) -> bool:
    return group is not None and group.pg is not None


def all_reduce(t: torch.Tensor, group: AxisGroup | None,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A new tensor: ``t`` reduced over ``group`` (not differentiated)."""
    if not _active(group):
        return t.clone()
    buf = t.detach().clone()
    dist.all_reduce(buf, op=op, group=group.pg)
    return buf


def all_reduce_flat(tensors: list, group: AxisGroup | None) -> list:
    """Sum each of ``tensors`` over ``group`` through one flat buffer per
    type (one collective for a whole gradient)."""
    if not _active(group):
        return list(tensors)
    out = [None] * len(tensors)
    by_type: dict = {}
    for i, t in enumerate(tensors):
        by_type.setdefault(t.dtype, []).append(i)
    for idx in by_type.values():
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        flat = all_reduce(flat, group)
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[off: off + n].view(tensors[i].shape)
            off += n
    return out


def all_gather(t: torch.Tensor, group: AxisGroup | None) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated on axis 0 in the
    group's order."""
    if not _active(group):
        return t
    src = t.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(group.size)]
    dist.all_gather(parts, src, group=group.pg)
    return torch.cat(parts)


def broadcast_flat(tensors: list, group: AxisGroup | None) -> list:
    """``tensors`` as the group's first rank holds them, through one flat
    buffer per type."""
    if not _active(group):
        return list(tensors)
    out = [None] * len(tensors)
    by_type: dict = {}
    for i, t in enumerate(tensors):
        by_type.setdefault(t.dtype, []).append(i)
    for idx in by_type.values():
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        dist.broadcast(flat, src=group.ranks[0], group=group.pg)
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[off: off + n].view(tensors[i].shape).clone()
            off += n
    return out


def barrier(group: AxisGroup | None) -> None:
    if _active(group):
        dist.barrier(group=group.pg)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def all_reduce_sum(t: torch.Tensor, group: AxisGroup | None):
    """Differentiable sum over ``group`` (see the module's docstring)."""
    if not _active(group):
        return t
    return _AllReduceSum.apply(t, group)


def pmean(t: torch.Tensor, group: AxisGroup | None):
    """Differentiable mean over ``group``."""
    if not _active(group):
        return t
    return _AllReduceSum.apply(t, group) * (1.0 / group.size)


# ------------------------------------------------- tensor parallelism

def _gather_dim(t: torch.Tensor, dim: int, group: AxisGroup):
    src = t.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(group.size)]
    dist.all_gather(parts, src, group=group.pg)
    return torch.cat(parts, dim=dim)


def _own_slice(t: torch.Tensor, dim: int, group: AxisGroup):
    n = t.shape[dim] // group.size
    return t.narrow(dim, group.index * n, n).contiguous()


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _ReduceFromTP.apply(grad, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _CopyToTP.apply(grad, ctx.group), None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _ScatterToTP.apply(grad, ctx.dim, ctx.group), None, None


class _ScatterToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _own_slice(x.detach(), dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _GatherFromTP.apply(grad, ctx.dim, ctx.group), None, None


def copy_to_tp(x: torch.Tensor, group: AxisGroup | None):
    """The identity forward; the sum of the cotangents over ``group``
    backward (the input of a column-parallel product)."""
    return x if not _active(group) else _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group: AxisGroup | None):
    """The sum over ``group`` forward; the identity backward (the output
    of a row-parallel product)."""
    return x if not _active(group) else _ReduceFromTP.apply(x, group)


def gather_from_tp(x: torch.Tensor, dim: int, group: AxisGroup | None):
    """The ranks' ``x`` joined along ``dim`` in the group's order forward;
    this rank's slice of the cotangent backward (the output of a
    column-parallel product, a sharded vector used whole)."""
    if not _active(group):
        return x
    return _GatherFromTP.apply(x, dim % x.dim(), group)


def scatter_to_tp(x: torch.Tensor, dim: int, group: AxisGroup | None):
    """This rank's contiguous slice of ``x`` along ``dim`` forward; the
    ranks' cotangents joined backward (the input of a row-parallel
    product)."""
    if not _active(group):
        return x
    return _ScatterToTP.apply(x, dim % x.dim(), group)
