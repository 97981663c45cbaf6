"""Differentiable collectives for tensor parallelism and cross-rank statistics.

Megatron's pair of region boundaries, written as autograd functions:

- :func:`copy_to_group` — identity forward, all-reduce of the gradient
  backward: the input of a column-parallel layer, which every rank of the
  model group reads whole;
- :func:`reduce_from_group` — all-reduce (sum) forward, identity backward:
  the output of a row-parallel layer, whose partial products sum to the
  whole;
- :func:`gather_from_group` — all-gather along the last dimension forward,
  this rank's slice of the gradient backward: a column-parallel output that
  a replicated layer reads (``encoder_hid_proj``).

:func:`all_reduce_sum` is the plain differentiable sum (forward and
backward both all-reduce): BatchNorm's batch statistics over the data group,
where every rank's loss reads the summed statistics.

Sums of low-precision tensors are taken in float32 and rounded back once.
With a group of one rank every function returns its input.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["all_reduce_sum", "copy_to_group", "gather_from_group", "reduce_from_group"]


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    acc = x.to(torch.promote_types(x.dtype, torch.float32)).contiguous()
    dist.all_reduce(acc, group=group)
    return acc.to(x.dtype)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return g.chunk(n, dim=-1)[r].contiguous(), None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if _size(group) == 1 else _Copy.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if _size(group) == 1 else _Reduce.apply(x, group)


def gather_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if _size(group) == 1 else _Gather.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return x if _size(group) == 1 else _AllReduce.apply(x, group)
