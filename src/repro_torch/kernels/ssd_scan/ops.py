"""Public wrapper for the SSD-scan kernel (adds the D skip term)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.ssd_scan.kernel import ssd_scan_fwd
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref


def ssd(
    x: torch.Tensor,            # [B, S, H, P]
    dt: torch.Tensor,           # [B, S, H]
    A: torch.Tensor,            # [H]
    B_: torch.Tensor,           # [B, S, G, N]
    C: torch.Tensor,            # [B, S, G, N]
    D: Optional[torch.Tensor] = None,             # [H]
    *,
    chunk: int = 128,
    init_state: Optional[torch.Tensor] = None,    # [B, H, P, N] fp32
    return_state: bool = False,
):
    """Mamba-2 SSD scan: y [B,S,H,P] in x's type, and with ``return_state``
    also the final state [B,H,P,N] fp32.  A CUDA tensor goes to the CUDA
    kernel, which launches or raises; a CPU tensor goes to the plain chunked
    version.  The JAX wrapper's ``interpret`` has no counterpart here.

    ``ssd.launches`` counts the kernel's launches."""
    if x.device.type == "cpu":
        y, state = ssd_chunked_ref(x, dt, A, B_, C, chunk=chunk,
                                   init_state=init_state)
    else:
        y, state = ssd_scan_fwd(x, dt, A, B_, C, chunk=chunk,
                                init_state=init_state)
        ssd.launches += 1
    if D is not None:
        y = y + (x.float() * D.float()[None, None, :, None]).to(y.dtype)
    return (y, state) if return_state else y


ssd.launches = 0
