"""Public wrapper for the flash-attention kernels (GQA-aware), with autograd."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import spans
from repro_torch.kernels.flash_attention.kernel import (flash_attention_bwd,
                                                        flash_attention_fwd)
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_ref


class FlashAttention(torch.autograd.Function):
    """Attention whose backward is the hand-written backward kernel (its plain
    version for CPU tensors): dq and dk at q's head dim, dv at v's.  The
    forward keeps q, k, v, its output and the per-row log-sum-exp; under
    ``torch.utils.checkpoint`` the forward runs again in the backward pass,
    and the tensors it saves then are the ones the backward reads."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int]):
        if q.device.type == "cpu":
            out, lse = attention_ref(q, k, v, causal=causal, window=window,
                                     return_lse=True)
        else:
            out, lse = flash_attention_fwd(q, k, v, causal=causal,
                                           window=window, return_lse=True)
            spans.count("kernel.fa_fwd")
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
            spans.count("kernel.fa_bwd")
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,            # [B, Hq, Sq, D]
    k: torch.Tensor,            # [B, Hkv, Skv, D]
    v: torch.Tensor,            # [B, Hkv, Skv, Dv]
    *,
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """GQA flash attention -> [B, Hq, Sq, Dv].  A CUDA tensor goes to the
    CUDA kernels, which launch or raise (they take the (D, Dv) pairs of
    ``kernel.HEAD_DIM_PAIRS``); a CPU tensor goes to the plain versions,
    which take any.  When grad mode
    is on and an input requires grad, the call goes through
    ``FlashAttention``, whose backward is the backward kernel.  The tile sizes
    are the kernels' own constants, so the JAX wrapper's ``q_block``,
    ``kv_block`` and ``interpret`` have no counterpart here.

    The counters ``kernel.fa_fwd`` and ``kernel.fa_bwd`` of
    ``repro_torch.spans`` count the forward kernel's launches and the
    backward's."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, window)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    out = flash_attention_fwd(q, k, v, causal=causal, window=window)
    spans.count("kernel.fa_fwd")
    return out
