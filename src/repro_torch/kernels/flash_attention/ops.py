"""Public wrapper for the flash-attention kernel (GQA-aware)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
from repro_torch.kernels.flash_attention.ref import attention_ref


def flash_attention(
    q: torch.Tensor,            # [B, Hq, Sq, D]
    k: torch.Tensor,            # [B, Hkv, Skv, D]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """GQA flash attention.  A CUDA tensor goes to the CUDA kernel, which
    launches or raises; a CPU tensor goes to the plain version.  The tile
    sizes are the kernel's own constants, so the JAX wrapper's ``q_block``,
    ``kv_block`` and ``interpret`` have no counterpart here.

    ``flash_attention.launches`` counts the kernel's launches."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    out = flash_attention_fwd(q, k, v, causal=causal, window=window)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
