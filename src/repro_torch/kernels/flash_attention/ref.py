"""Plain PyTorch versions of the flash-attention kernels, forward and backward.

Naive full-materialization attention: what the CPU tests run and what the
CUDA kernels are held against on the card.  q and k have head dim D, v and
the output Dv, any pair (the kernels take those of
``kernel.HEAD_DIM_PAIRS``); the scale is 1 / sqrt(D).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

# the masked logit of the kernels and of the JAX package; also the log-sum-exp
# of a row that sees no key
NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def _mask(sq: int, skv: int, causal: bool, window: Optional[int],
          device) -> torch.Tensor:
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= qpos - kpos < window
    return mask


def attention_ref(
    q: torch.Tensor,            # [B, Hq, Sq, D]
    k: torch.Tensor,            # [B, Hkv, Skv, D]
    v: torch.Tensor,            # [B, Hkv, Skv, Dv]
    *,
    causal: bool = True,
    window: Optional[int] = None,
    return_lse: bool = False,
):
    """softmax(q kᵀ / √D + mask) v in q's type; a row that sees no key gives 0.

    With ``return_lse`` also returns the log-sum-exp of each row's scaled
    logits, ``[B, Hq, Sq]`` fp32.  A row that sees no key has no finite one:
    it gets ``NEG_INF`` (-0.7 · float32 max, the masked logit), which is what
    the kernels write where their running sum ``l`` stays 0, and what the JAX
    package's blocked forward gives (its ``m`` stays at the masked logit and
    ``log(1e-30)`` vanishes in the rounding).  The backward masks such rows,
    so their value never reaches a gradient."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, Sq, D).float()
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float())
    logits = logits * (1.0 / math.sqrt(D))
    logits = logits.masked_fill(~_mask(Sq, Skv, causal, window, q.device),
                                float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    probs = torch.nan_to_num(probs, nan=0.0)   # a row that sees no key gives 0
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, v.float())
    out = out.reshape(B, Hq, Sq, v.shape[-1]).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.logsumexp(logits, dim=-1).reshape(B, Hq, Sq)
    return out, torch.where(torch.isfinite(lse), lse, NEG_INF)


def attention_bwd_ref(
    q: torch.Tensor,            # [B, Hq, Sq, D]
    k: torch.Tensor,            # [B, Hkv, Skv, D]
    v: torch.Tensor,            # [B, Hkv, Skv, Dv]
    out: torch.Tensor,          # [B, Hq, Sq, Dv], the forward's output
    lse: torch.Tensor,          # [B, Hq, Sq] fp32, the forward's log-sum-exp
    do: torch.Tensor,           # [B, Hq, Sq, Dv]
    *,
    causal: bool = True,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients (dq, dk, dv) of attention, in the inputs' type: the
    JAX package's blocked backward (``models/flash.py`` ``_flash_bwd_impl``)
    written densely in fp32.  delta = rowsum(dO·O); p = exp(s·scale − lse)
    under the mask; dS = p·(dP − delta)·scale; dk and dv are summed over the
    Hq / Hkv query heads of each KV head by index.  dq and dk have D
    columns, dv Dv."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)

    def grouped(x):                  # [B, Hq, Sq, ...] -> [B, Hkv, G, Sq, ...]
        return x.float().reshape(B, Hkv, G, Sq, *x.shape[3:])

    qg, og, dog, lse_g = grouped(q), grouped(out), grouped(do), grouped(lse)
    kf, vf = k.float(), v.float()
    delta = torch.sum(dog * og, dim=-1)                          # [B,Hkv,G,Sq]
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kf) * scale
    mask = _mask(Sq, Skv, causal, window, q.device)
    p = torch.where(mask, torch.exp(s - lse_g[..., None]), 0.0)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dog, vf)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, kf).reshape(B, Hq, Sq, D)
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qg)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, dog)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
