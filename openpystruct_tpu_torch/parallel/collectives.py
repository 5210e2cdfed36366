"""The collectives the port's data parallelism uses, over
``torch.distributed``.

Every function is the identity (or a no-op) when no process group is
initialised, so a one-process run needs no group.  ``group`` None is the
default group.  Tensors go to the backend where it can take them: gloo's
CUDA support covers only all-reduce and broadcast, so on gloo a CUDA tensor
is staged through a host copy for every collective; on NCCL a host tensor
goes to the current card.  The result comes back on the input's device.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}


def active() -> bool:
    """True when a process group is initialised."""
    return dist.is_available() and dist.is_initialized()


def _staged(x: torch.Tensor, group) -> torch.Tensor:
    """A contiguous copy of ``x`` on a device the group's backend takes."""
    backend = dist.get_backend(group)
    if backend == "gloo" and x.is_cuda:
        return x.cpu().contiguous()
    if backend == "nccl" and not x.is_cuda:
        return x.to(torch.device("cuda", torch.cuda.current_device()))
    return x.clone(memory_format=torch.contiguous_format)


def all_reduce(x: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """``x`` reduced over the ranks (``op`` "sum", "min" or "max")."""
    if not active():
        return x
    y = _staged(x, group)
    dist.all_reduce(y, op=_OPS[op], group=group)
    return y.to(x.device)


def broadcast(x: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Rank ``src``'s ``x`` on every rank (same shape and dtype)."""
    if not active():
        return x
    y = _staged(x, group)
    dist.broadcast(y, src=src, group=group)
    return y.to(x.device)


def barrier(group=None) -> None:
    if active():
        dist.barrier(group=group)


def _gather_equal(y: torch.Tensor, group) -> torch.Tensor:
    parts = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, y, group=group)
    return torch.cat(parts)


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's rows of ``x`` (dim 0) concatenated in rank order, on
    every rank.  The row counts may differ: they are gathered first, and
    the rows padded to the largest count and trimmed after."""
    if not active():
        return x
    y = _staged(x, group)
    n = torch.tensor([y.shape[0]], dtype=torch.int64, device=y.device)
    counts = [int(c) for c in _gather_equal(n, group)]
    most = max(counts)
    if most == 0:
        return x
    if most > y.shape[0]:
        y = torch.cat([y, y.new_zeros((most - y.shape[0],)
                                      + tuple(y.shape[1:]))])
    parts = _gather_equal(y, group).split(most)
    return torch.cat([p[:c] for p, c in zip(parts, counts)]).to(x.device)


def tree_map(fn, tree):
    """``tree`` (a dict, list, tuple or dataclass of leaves, nested) with
    ``fn`` applied to every leaf; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    return fn(tree)


def gather_rows(tree, group=None):
    """``tree`` with every tensor of one or more dims replaced by every
    rank's rows in rank order (``all_gather_rows``); 0-dim tensors and
    other leaves are kept."""
    def gather(x):
        if isinstance(x, torch.Tensor) and x.ndim:
            return all_gather_rows(x, group)
        return x

    return tree_map(gather, tree)


class _GatherForLoss(torch.autograd.Function):
    """Forward: every rank's rows (equal counts) in rank order.  Backward:
    this rank's rows of the gradient times the world size.  Every rank
    computes the same loss from the gathered rows, so each holds the same
    gradient of them, and this is its sum over the ranks (the reduce-scatter
    of ``torch.distributed.nn``'s all-gather) without a collective."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.world = dist.get_world_size(group)
        ctx.first = dist.get_rank(group) * x.shape[0]
        ctx.rows = x.shape[0]
        return _gather_equal(_staged(x, group), group).to(x.device)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.first:ctx.first + ctx.rows] * ctx.world, None


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the gradient of each rank's input is the sum of
    the ranks' output gradients (``torch.distributed.nn``'s all-reduce)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, "sum", group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, "sum", ctx.group), None


def gather_for_loss(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable ``all_gather_rows`` of equal row counts, for a loss
    every rank computes alike from the gathered rows; the gradients it
    leaves are the world size times the rank's share, which the caller's
    gradient all-reduce divides back."""
    return _GatherForLoss.apply(x, group) if active() else x


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable sum over the ranks."""
    return _AllReduceSum.apply(x, group) if active() else x
