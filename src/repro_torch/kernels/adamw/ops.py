"""Public wrapper for AdamW's norm and update: the CUDA kernels (K4) for CUDA
tensors, the plain version for CPU tensors."""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch import spans
from repro_torch.kernels.adamw.kernel import (adamw_update_cuda, check_grads,
                                              check_update, sum_of_squares_cuda)
from repro_torch.kernels.adamw.ref import adamw_update_ref, sum_of_squares_ref


def sum_of_squares(grads: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the sum of the squares of every element of ``grads`` in fp32, its
    square root), 0-dim tensors on their device.  CUDA leaves go to
    ``adamw_sumsq``, which launches or raises; CPU leaves to the plain
    version."""
    check_grads(grads)
    if grads[0].device.type == "cpu":
        return sum_of_squares_ref(grads)
    return sum_of_squares_cuda(grads)


def adamw_update(params, grads, ms, vs, *, scale: torch.Tensor, lr: torch.Tensor,
                 b1t: torch.Tensor, b2t: torch.Tensor, b1: float, b2: float, eps: float,
                 weight_decay: float) -> None:
    """One AdamW step of every leaf in place (``ref.adamw_update_ref`` says
    what it computes).  The four scalars are fp32 tensors on the leaves'
    device.  CUDA leaves go to ``adamw_update``, which launches or raises;
    CPU leaves to the plain version.  The counter ``kernel.adamw`` of
    ``repro_torch.spans`` counts the calls that launched the kernel."""
    check_update(params, grads, ms, vs, (scale, lr, b1t, b2t))
    kw = dict(scale=scale, lr=lr, b1t=b1t, b2t=b2t, b1=b1, b2=b2, eps=eps,
              weight_decay=weight_decay)
    if grads[0].device.type == "cpu":
        adamw_update_ref(params, grads, ms, vs, **kw)
        return
    adamw_update_cuda(params, grads, ms, vs, **kw)
    spans.count("kernel.adamw")
