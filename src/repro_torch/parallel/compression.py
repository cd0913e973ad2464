"""Gradient compression for cross-pod reduction (int8 + error feedback).

At 2 pods the "pod" axis all-reduce moves full fp32/bf16 gradients between
pods; int8 block-quantization with error feedback cuts wire bytes 4x (vs
fp32) while keeping convergence (the residual carries quantization error to
the next step).  ``compressed_psum`` reduces over a process group: every
rank sends its int8 codes and fp32 block scales (an all-gather), and each
rank sums the dequantized values of all ranks in rank order, so every rank
holds the same bits.

The arithmetic is the JAX package's: blocks of 256, scale max|block| / 127
floored at 1e-12, the division ``blocks / scale`` in fp32 and rounded half
to even (``torch.round``, as ``jnp.round``), so the codes are the same.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.models.common import tree_leaves, tree_unflatten

BLOCK = 256


def _blockify(x: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, ...], int]:
    flat = x.reshape(-1).float()
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.reshape(-1, BLOCK), tuple(x.shape), pad


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block symmetric int8.  Returns (q [nb, BLOCK] int8, scale [nb])."""
    blocks, _, _ = _blockify(x)
    scale = torch.clamp_min(blocks.abs().amax(dim=1) / 127.0, 1e-12)
    q = torch.clamp(torch.round(blocks / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape, pad: int) -> torch.Tensor:
    flat = (q.float() * scale[:, None]).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape)


def compressed_psum(x: torch.Tensor, group=None,
                    residual: torch.Tensor = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback compressed all-reduce of ``x`` over ``group`` (the
    default group when None; no group initialised: one rank).  Returns
    (the sum over ranks of each rank's dequantized ``x + residual``, in x's
    type; this rank's new residual, fp32)."""
    x_c = x.float() + (0.0 if residual is None else residual)
    q, scale = quantize_int8(x_c)
    _, shape, pad = _blockify(x_c)
    new_residual = x_c - dequantize_int8(q, scale, shape, pad)
    n = dist.get_world_size(group) if dist.is_initialized() else 1
    if n == 1:
        qs, scales = [q], [scale]
    else:
        qs = [torch.empty_like(q) for _ in range(n)]
        scales = [torch.empty_like(scale) for _ in range(n)]
        dist.all_gather(qs, q.contiguous(), group=group)
        dist.all_gather(scales, scale.contiguous(), group=group)
    summed = dequantize_int8(qs[0], scales[0], shape, pad)
    for qi, si in zip(qs[1:], scales[1:]):
        summed = summed + dequantize_int8(qi, si, shape, pad)
    return summed.to(x.dtype), new_residual


def compress_tree(grads):
    """Tree version of quantize: returns (quantized leaves, scales, metas,
    the tree, whose structure ``decompress_tree`` rebuilds)."""
    qs, scales, metas = [], [], []
    for leaf in tree_leaves(grads):
        _, shape, pad = _blockify(leaf)
        q, s = quantize_int8(leaf)
        qs.append(q)
        scales.append(s)
        metas.append((shape, pad))
    return qs, scales, metas, grads


def decompress_tree(qs: List, scales: List, metas: List, treedef):
    leaves = [dequantize_int8(q, s, shape, pad)
              for q, s, (shape, pad) in zip(qs, scales, metas)]
    return tree_unflatten(treedef, leaves)


def wire_bytes_ratio() -> float:
    """int8 payload + fp32 scale per block vs fp32 baseline."""
    return (BLOCK * 1 + 4) / (BLOCK * 4)
