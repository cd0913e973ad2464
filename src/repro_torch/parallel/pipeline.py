"""GPipe-style pipeline parallelism over a "pipe" process group.

For depth-dominated models, the layer stack is split into ``n_stages``
contiguous groups, one a rank of the group; microbatches stream through with
the classic GPipe schedule (fill + steady + drain = n_stages + n_micro - 1
ticks).  Activations hop stages with a neighbour send / receive
(``batch_isend_irecv``, both directions posted at once, so the ring's wrap
cannot deadlock): the JAX package's ``ppermute``.  The last stage collects
the outputs and broadcasts them to the group (the JAX package's masked
``psum``).

Forward only: the JAX package differentiates its pipeline through
``shard_map``; the port's send / receive carry no gradient.  Numerics are
held against the unpipelined ``reference_apply``.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.models.common import tree_leaves, tree_map


def _layer(stacked_params, i: int):
    return tree_map(lambda x: x[i], stacked_params)


def pipeline_apply(layer_fn: Callable, stacked_params, x: torch.Tensor,
                   group=None) -> torch.Tensor:
    """Run ``n_layers`` (= n_stages × layers_per_stage) over microbatches.

    ``layer_fn(params_for_one_layer, x) -> x``; ``stacked_params`` a tree
    whose leaves hold all ``n_layers`` layers on a leading axis (the same on
    every rank; each rank uses its stage's contiguous slice); ``x``
    [n_micro, mb, ...], the same on every rank.  ``group``: the pipe's
    process group (its ranks in stage order); None is the default group, or
    one stage where no group is initialised.  Returns the final activations
    [n_micro, mb, ...] on every rank of the group."""
    if dist.is_initialized():
        n_stages = dist.get_world_size(group)
        stage = dist.get_rank(group)
    else:
        n_stages, stage = 1, 0
    n_layers = tree_leaves(stacked_params)[0].shape[0]
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers over {n_stages} stages")
    per = n_layers // n_stages
    mine = [_layer(stacked_params, stage * per + j) for j in range(per)]
    n_micro = x.shape[0]

    def run_stage(h):
        for lp in mine:
            h = layer_fn(lp, h)
        return h

    def peer(s):
        return s if group is None else dist.get_global_rank(group, s)

    buf = torch.zeros_like(x[0])                    # in-flight microbatch
    outs = torch.zeros_like(x)                      # collected at the last stage
    for t in range(n_stages + n_micro - 1):
        if stage == 0 and t < n_micro:
            buf = x[t]                              # stage 0 ingests microbatch t
        # stage s holds microbatch t - s; ticks outside the schedule carry
        # nothing that is collected, so they are not computed
        h = run_stage(buf) if 0 <= t - stage < n_micro else buf
        if stage == n_stages - 1 and t >= n_stages - 1:
            outs[t - n_stages + 1] = h
        if n_stages == 1:
            buf = h
            continue
        # shift: stage i's output becomes stage i+1's input
        recv = torch.empty_like(h)
        ops = [dist.P2POp(dist.isend, h.contiguous(), peer((stage + 1) % n_stages), group),
               dist.P2POp(dist.irecv, recv, peer((stage - 1) % n_stages), group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        buf = recv
    if n_stages > 1:
        dist.broadcast(outs, peer(n_stages - 1), group=group)
    return outs


def reference_apply(layer_fn: Callable, stacked_params, x: torch.Tensor) -> torch.Tensor:
    """Unpipelined oracle: all layers over each microbatch."""
    n_layers = tree_leaves(stacked_params)[0].shape[0]
    layers = [_layer(stacked_params, i) for i in range(n_layers)]
    outs = []
    for h in x:
        for lp in layers:
            h = layer_fn(lp, h)
        outs.append(h)
    return torch.stack(outs)
