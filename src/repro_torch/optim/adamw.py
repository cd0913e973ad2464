"""AdamW with cosine schedule, written out as the JAX package's
``optim/adamw.py`` is, so the two compare line for line (no ``torch.optim``).

Optimizer state mirrors the param tree, with fp32 moments regardless of param
dtype: the standard mixed-precision recipe (bf16 params / fp32 m, v).
Global-norm clipping runs in fp32.  The step count and every schedule
quantity are fp32 tensors on the params' device, so a step never waits on the
host.  Unlike the JAX package, which returns new trees, ``adamw_update``
updates the params and the moments in place: at tinyllama-1.1b's size a
second copy of the moments alone would cost 8.8 GB.  On a device mesh the
params, grads and moments are DTensors of the same placements; the update
runs on each rank's shards, and only the global norm communicates.  The
norm and the update of every leaf are K4's (``kernels/adamw``): one launch
each on the card, the plain version on the CPU.  The update runs in the span
``optimizer``, its global norm in ``optimizer.norm`` (``repro_torch.spans``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch import spans
from repro_torch.kernels.adamw import ops
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.parallel.activations import is_dtensor


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = torch.as_tensor(step).float()
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    scale = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * scale


def adamw_init(params) -> Dict[str, Any]:
    """{"m", "v": fp32 zeros in the params' structure, "step": int32 0}."""
    def zeros(p):
        # zeros_like: a DTensor param (a mesh) gets moments on its shards
        return tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32), p)
    device = tree_leaves(params)[0].device
    return {"m": zeros(params), "v": zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every element's square.  On a mesh (DTensor
    leaves) each leaf's local sum is taken on its shard and summed over the
    mesh axes it is sharded on, so a replicated leaf counts once and a
    sharded one across its shards; the result is a plain tensor, the same
    on every rank."""
    leaves = tree_leaves(tree)
    with spans.span("optimizer.norm"):
        if leaves and is_dtensor(leaves[0]):
            return torch.sqrt(_mesh_sum_of_squares(leaves))
        return ops.sum_of_squares(leaves)[1]


def _mesh_sum_of_squares(leaves) -> torch.Tensor:
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard
    mesh = leaves[0].device_mesh
    by_axes = {}
    for x in leaves:
        if any(not isinstance(p, (Shard, Replicate)) for p in x.placements):
            raise ValueError(f"a leaf with placements {x.placements}: reduce "
                             f"partial sums before the norm")
        axes = tuple(i for i, p in enumerate(x.placements) if isinstance(p, Shard))
        by_axes.setdefault(axes, []).append(x.to_local())
    total = None
    for axes in sorted(by_axes):
        part = ops.sum_of_squares(by_axes[axes])[0]
        for i in axes:
            dist.all_reduce(part, group=mesh.get_group(i))
        total = part if total is None else total + part
    return total


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state) -> Tuple[Any, Dict]:
    """Returns (params, new_state).  Grads may be bf16; math is fp32.  The
    params and the moments are updated in place: the returned trees hold the
    same tensors, and ``step`` is a new one."""
    with spans.span("optimizer"):
        return _update(cfg, params, grads, state)


def _update(cfg: AdamWConfig, params, grads, state) -> Tuple[Any, Dict]:
    step = state["step"] + 1
    t = step.float()
    lr = cosine_lr(cfg, t)
    gnorm = _global_norm(grads)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9), 1.0)

    b1t = 1.0 - cfg.b1 ** t
    b2t = 1.0 - cfg.b2 ** t

    leaves = []
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state["m"]), tree_leaves(state["v"])):
        if is_dtensor(p):
            # elementwise: each rank updates its own shards
            if not (g.placements == m.placements == v.placements == p.placements):
                raise ValueError(f"placements differ: param {p.placements}, "
                                 f"grad {g.placements}")
            p, g, m, v = (x.to_local() for x in (p, g, m, v))
        leaves.append((p, g, m, v))
    ops.adamw_update(*map(list, zip(*leaves)), scale=scale, lr=lr, b1t=b1t, b2t=b2t,
                     b1=cfg.b1, b2=cfg.b2, eps=cfg.eps, weight_decay=cfg.weight_decay)
    return params, {"m": state["m"], "v": state["v"], "step": step}
