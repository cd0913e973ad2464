"""Collectives with the gradients the explicit local regions need
(``activations.local_region``): the port's counterparts of ``jax.lax``'s
``psum`` / ``all_gather`` inside ``shard_map``, over one mesh axis or a tuple
of them (applied one axis at a time, minor axis first for gathers)."""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.distributed as dist

Axes = Union[str, Tuple[str, ...]]


def _axes(axes: Axes) -> Tuple[str, ...]:
    return tuple(axes) if isinstance(axes, (tuple, list)) else (axes,)


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    if n == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    if n == 1:
        return x
    parts = [c.contiguous() for c in torch.chunk(x, n, dim=dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    return out


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    if dist.get_world_size(group) == 1:
        return x
    x = x.clone()
    dist.all_reduce(x, group=group)
    return x


class _PsumIdBwd(torch.autograd.Function):
    """Megatron's "g": forward a sum over the group, backward the identity
    (the cotangent is already the same on every rank of the group)."""

    @staticmethod
    def forward(ctx, x, groups):
        for g in groups:
            x = _all_reduce(x, g)
        return x

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _GatherRsBwd(torch.autograd.Function):
    """All-gather along ``dim``; backward a reduce-scatter (the sum of every
    rank's partial gradient, each rank keeping its slice): an FSDP weight
    gather."""

    @staticmethod
    def forward(ctx, x, dim, groups):
        ctx.dim, ctx.groups = dim, groups
        for g in reversed(groups):
            x = _all_gather(x, dim, g)
        return x

    @staticmethod
    def backward(ctx, dy):
        for g in ctx.groups:
            dy = _reduce_scatter(dy, ctx.dim, g)
        return dy, None, None


class _GatherSliceBwd(torch.autograd.Function):
    """All-gather along ``dim``; backward this rank's slice of the cotangent
    (which every rank holds whole): the exit of a row-parallel region."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.n = dim, x.shape[dim]
        ctx.rank = dist.get_rank(group)
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, dy):
        return dy.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None


def groups(mesh, axes: Axes) -> Sequence:
    return [mesh.get_group(a) for a in _axes(axes)]


def psum_id_bwd(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """Sum over ``axes`` forward, identity backward."""
    return _PsumIdBwd.apply(x, groups(mesh, axes))


def fsdp_gather(x: torch.Tensor, dim: int, mesh, axes: Axes) -> torch.Tensor:
    """The whole of a weight sharded along ``dim`` over ``axes``; its
    gradient is reduce-scattered back onto the shards."""
    return _GatherRsBwd.apply(x, dim, groups(mesh, axes))


def gather_rows(x: torch.Tensor, dim: int, mesh, axis: str) -> torch.Tensor:
    """Every rank's ``x`` over ``axis`` concatenated along ``dim``; the
    gradient is this rank's slice of the (replicated) cotangent."""
    return _GatherSliceBwd.apply(x, dim, mesh.get_group(axis))
