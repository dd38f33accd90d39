"""Differentiable collectives over one process group, the pieces the mesh,
tensor, sequence and pipeline parallelism are built from.

A tensor is *replicated* over a group when every member holds the same
value and computes the same gradient for it, *split* when each member
holds its own slice.  The four moves between the two, with the backward
each needs so that every member ends with the gradient of the one loss:

- ``reduce_sum``: partial sums -> replicated; backward the identity.
- ``grad_sum``: replicated input of split work; forward the identity,
  backward sums the members' partial gradients.
- ``split``: replicated -> this member's slice; backward all-gathers.
- ``gather(partial_grad)``: slices -> the whole.  With
  ``partial_grad=False`` the whole is consumed replicated, so the
  backward keeps this member's slice of the (identical) gradient; with
  ``True`` each member consumes it differently (attention keys, a batch
  statistic), so the backward sums the members' gradients first.

Each is the identity on a group of one (``group=None``), so a size-1 axis
costs nothing, as in the JAX package.  Every member must call the same
collectives in the same order: the callers take their branches on values
that agree across the group.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_gather_cat(x: torch.Tensor, axis: int, group) -> torch.Tensor:
    """The members' ``x`` concatenated along ``axis`` (no autograd)."""
    parts: List[torch.Tensor] = [torch.empty_like(x) for _ in range(group_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=axis)


def all_reduce_(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce (no autograd); the identity on a group of one."""
    if group_size(group) > 1:
        dist.all_reduce(x, op=op, group=group)
    return x


def _slice(x: torch.Tensor, axis: int, group) -> torch.Tensor:
    n = x.shape[axis] // group_size(group)
    return x.narrow(axis, group_rank(group) * n, n)


class _ReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GradSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, group):
        ctx.axis, ctx.group = axis, group
        return _slice(x, axis, group).clone()

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g, ctx.axis, ctx.group), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, group, partial_grad):
        ctx.axis, ctx.group, ctx.partial = axis, group, partial_grad
        return all_gather_cat(x, axis, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            g = all_reduce_(g.clone(), ctx.group)
        return _slice(g, ctx.axis, ctx.group).clone(), None, None, None


def reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _ReduceSum.apply(x, group)


def grad_sum(x: torch.Tensor, group) -> torch.Tensor:
    if group_size(group) == 1 or not x.requires_grad:
        return x
    return _GradSum.apply(x, group)


def split(x: torch.Tensor, axis: int, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _Split.apply(x, axis, group)


def gather(x: torch.Tensor, axis: int, group, partial_grad: bool = False) -> torch.Tensor:
    return x if group_size(group) == 1 else _Gather.apply(x, axis, group, partial_grad)


def local_slice(x: torch.Tensor, axis: Optional[int], index: int, parts: int) -> torch.Tensor:
    """Slice ``index`` of ``parts`` equal slices of ``x`` along ``axis``
    (``x`` itself when ``axis`` is None or ``parts`` is 1)."""
    if axis is None or parts == 1:
        return x
    n = x.shape[axis] // parts
    return x.narrow(axis, index * n, n)
