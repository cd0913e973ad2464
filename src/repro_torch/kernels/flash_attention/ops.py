"""Public wrapper for the flash-attention kernels (GQA-aware), with autograd."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.kernel import (flash_attention_bwd,
                                                        flash_attention_fwd)
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_ref


class FlashAttention(torch.autograd.Function):
    """Attention whose backward is the hand-written backward kernel (its plain
    version for CPU tensors).  The forward keeps q, k, v, its output and the
    per-row log-sum-exp; under ``torch.utils.checkpoint`` the forward runs
    again in the backward pass, and the tensors it saves then are the ones the
    backward reads."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int]):
        if q.device.type == "cpu":
            out, lse = attention_ref(q, k, v, causal=causal, window=window,
                                     return_lse=True)
        else:
            out, lse = flash_attention_fwd(q, k, v, causal=causal,
                                           window=window, return_lse=True)
            flash_attention.launches += 1
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv = attention_bwd_ref(q, k, v, out, lse, do,
                                           causal=ctx.causal, window=ctx.window)
        else:
            dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do,
                                             causal=ctx.causal, window=ctx.window)
            flash_attention.bwd_launches += 1
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,            # [B, Hq, Sq, D]
    k: torch.Tensor,            # [B, Hkv, Skv, D]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """GQA flash attention.  A CUDA tensor goes to the CUDA kernels, which
    launch or raise; a CPU tensor goes to the plain versions.  When grad mode
    is on and an input requires grad, the call goes through
    ``FlashAttention``, whose backward is the backward kernel.  The tile sizes
    are the kernels' own constants, so the JAX wrapper's ``q_block``,
    ``kv_block`` and ``interpret`` have no counterpart here.

    ``flash_attention.launches`` counts the forward kernel's launches,
    ``flash_attention.bwd_launches`` the backward's."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, window)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    out = flash_attention_fwd(q, k, v, causal=causal, window=window)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
flash_attention.bwd_launches = 0
