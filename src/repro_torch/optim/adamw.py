"""AdamW with cosine schedule, written out as the JAX package's
``optim/adamw.py`` is, so the two compare line for line (no ``torch.optim``).

Optimizer state mirrors the param tree, with fp32 moments regardless of param
dtype: the standard mixed-precision recipe (bf16 params / fp32 m, v).
Global-norm clipping runs in fp32.  The step count and every schedule
quantity are fp32 tensors on the params' device, so a step never waits on the
host.  Unlike the JAX package, which returns new trees, ``adamw_update``
updates the params and the moments in place: at tinyllama-1.1b's size a
second copy of the moments alone would cost 8.8 GB.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch.models.common import tree_leaves, tree_map


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
        return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                              device=x.device), p)
    device = tree_leaves(params)[0].device
    return {"m": zeros(params), "v": zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state) -> Tuple[Any, Dict]:
    """Returns (params, new_state).  Grads may be bf16; math is fp32.  The
    params and the moments are updated in place: the returned trees hold the
    same tensors, and ``step`` is a new one."""
    step = state["step"] + 1
    lr = cosine_lr(cfg, step)
    gnorm = _global_norm(grads)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9), 1.0)

    b1t = 1.0 - cfg.b1 ** step.float()
    b2t = 1.0 - cfg.b2 ** step.float()

    def upd(p, g, m, v):
        g = g.float() * scale
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(g))
        mh = m / b1t
        vh = v / b2t
        p32 = p.float()
        p32 = p32 - lr * (mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p32)
        p.copy_(p32.to(p.dtype))

    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state["m"]), tree_leaves(state["v"])):
        upd(p, g, m, v)
    return params, {"m": state["m"], "v": state["v"], "step": step}
