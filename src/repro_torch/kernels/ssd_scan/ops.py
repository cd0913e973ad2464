"""Public wrapper for the SSD-scan kernels (adds the D skip term), with
autograd."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import spans
from repro_torch.kernels.ssd_scan.kernel import ssd_scan_bwd, ssd_scan_fwd
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_bwd_ref, ssd_chunked_ref


def _scan(x, dt, A, B_, C, init_state, chunk):
    """(y, final state): the CUDA kernel for a CUDA tensor, counted in
    ``kernel.ssd_fwd``; the plain chunked version for a CPU tensor."""
    if x.device.type == "cpu":
        return ssd_chunked_ref(x, dt, A, B_, C, chunk=chunk, init_state=init_state)
    out = ssd_scan_fwd(x, dt, A, B_, C, chunk=chunk, init_state=init_state)
    spans.count("kernel.ssd_fwd")
    return out


class SsdScan(torch.autograd.Function):
    """The scan whose backward is the hand-written backward kernel (its plain
    version for CPU tensors).  The forward keeps its inputs; under
    ``torch.utils.checkpoint`` it runs again in the backward pass, and the
    tensors it saves then are the ones the backward reads."""

    @staticmethod
    def forward(ctx, x, dt, A, B_, C, init_state, chunk: int):
        y, state = _scan(x, dt, A, B_, C, init_state, chunk)
        ctx.save_for_backward(x, dt, A, B_, C, init_state)
        ctx.chunk = chunk
        # an output nobody read gets None, not a tensor of zeros to read back
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, d_state):
        x, dt, A, B_, C, init_state = ctx.saved_tensors
        # y unread: its gradient is 0; the final state's None goes to the
        # kernel as a null pointer (a zero gradient)
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        d_state = None if d_state is None else d_state.contiguous()
        if x.device.type == "cpu":
            grads = ssd_chunked_bwd_ref(x, dt, A, B_, C, init_state, dy, d_state,
                                        chunk=ctx.chunk)
        else:
            grads = ssd_scan_bwd(x, dt, A, B_, C, dy, chunk=ctx.chunk,
                                 init_state=init_state, d_final_state=d_state)
            spans.count("kernel.ssd_bwd")
        dx, ddt, dA, dB, dC, d_init = grads
        return (dx, ddt, dA, dB, dC, None if init_state is None else d_init,
                None)


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
    kernels, which launch or raise; a CPU tensor goes to the plain chunked
    versions.  When grad mode is on and an input requires grad, the call goes
    through ``SsdScan``, whose backward is the backward kernel; the D skip term
    is added in torch ops outside it, so D's gradient comes from autograd.
    The JAX wrapper's ``interpret`` has no counterpart here.

    The counters ``kernel.ssd_fwd`` and ``kernel.ssd_bwd`` of
    ``repro_torch.spans`` count the calls that went to the forward's CUDA
    kernels and to the backward's, one per call whatever the
    variant: the bf16 serving variant launches two CUDA kernels a call, the
    backward five (``kernel.VARIANT_KERNELS``, ``VARIANT_KERNELS_BWD``)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, dt, A, B_, C, init_state)):
        y, state = SsdScan.apply(x, dt, A, B_, C, init_state, chunk)
    else:
        y, state = _scan(x, dt, A, B_, C, init_state, chunk)
    if D is not None:
        y = y + (x.float() * D.float()[None, None, :, None]).to(y.dtype)
    return (y, state) if return_state else y
