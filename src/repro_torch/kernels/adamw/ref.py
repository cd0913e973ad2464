"""Plain PyTorch version of AdamW's global norm and update (K4's plain
version): the optimizer's arithmetic as ``optim/adamw.py`` wrote it leaf by
leaf, each expression a pass of its own.  This is what the CPU runs and what
the CUDA kernels (``csrc/adamw.cu``) are held against on the card; the update
kernel computes the same fp32 expression in the same order, so given the same
scalars the two agree bit for bit.  The kernels' norm sums in its own order.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch


def sum_of_squares_ref(grads: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the sum of the squares of every element of ``grads`` in fp32, its
    square root)."""
    total = sum(torch.sum(torch.square(x.float())) for x in grads)
    return total, torch.sqrt(total)


def adamw_update_ref(params, grads, ms, vs, *, scale: torch.Tensor, lr: torch.Tensor,
                     b1t: torch.Tensor, b2t: torch.Tensor, b1: float, b2: float,
                     eps: float, weight_decay: float) -> None:
    """One AdamW step of every leaf, in place: the gradient times ``scale``
    (the clip), fp32 moments, bias corrections ``b1t`` and ``b2t``, decoupled
    weight decay, the param rounded back to its type."""
    for p, g, m, v in zip(params, grads, ms, vs):
        g = g.float() * scale
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * torch.square(g))
        mh = m / b1t
        vh = v / b2t
        p32 = p.float()
        p32 = p32 - lr * (mh / (torch.sqrt(vh) + eps) + weight_decay * p32)
        p.copy_(p32.to(p.dtype))
