"""Plain PyTorch versions of the Mamba-2 SSD scan.

* ``ssd_ref``: the sequential recurrence, O(S) steps, the ground truth
      h_t = h_{t-1} * exp(dt_t * A) + dt_t * B_t (x) x_t
      y_t = C_t . h_t + D * x_t
* ``ssd_chunked_ref``: the chunked (state-space duality) form of
  arXiv:2405.21060 section 6 that the CUDA kernel evaluates: the CPU path of
  ``ops.ssd`` and what the kernel is held against on the card.

Both are fp32 inside and return ``y`` in ``x.dtype`` and the state in fp32.
Groups are broadcast to heads by index ``g = h // (H // G)``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def _heads(t: torch.Tensor, H: int) -> torch.Tensor:
    """[..., G, N] -> [..., H, N]: each group serves H // G consecutive heads."""
    return torch.repeat_interleave(t, H // t.shape[-2], dim=-2)


def ssd_ref(
    x: torch.Tensor,                    # [B, S, H, P]
    dt: torch.Tensor,                   # [B, S, H]   (> 0, post-softplus)
    A: torch.Tensor,                    # [H]         (negative)
    B_: torch.Tensor,                   # [B, S, G, N]
    C: torch.Tensor,                    # [B, S, G, N]
    D: Optional[torch.Tensor] = None,   # [H]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y [B,S,H,P], final state [B,H,P,N])."""
    Bsz, S, H, P = x.shape
    N = B_.shape[-1]
    xf, dtf, Af = x.float(), dt.float(), A.float()
    Bh, Ch = _heads(B_.float(), H), _heads(C.float(), H)   # [B,S,H,N]
    h = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t] * Af[None])             # [B,H]
        h = h * decay[..., None, None] + torch.einsum(
            "bhp,bhn,bh->bhpn", xf[:, t], Bh[:, t], dtf[:, t])
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ch[:, t]))
    y = torch.stack(ys, dim=1)
    if D is not None:
        y = y + xf * D.float()[None, None, :, None]
    return y.to(x.dtype), h


def _segsum(cs: torch.Tensor) -> torch.Tensor:
    """L[..., i, j] = sum_{k=j+1..i} x[..., k] for i >= j, -inf above the
    diagonal, from the cumulative sum ``cs`` of x.  cs: [..., Q] -> [..., Q, Q].

    The JAX original takes the cumulative sum itself; here it is taken once,
    in order along the chunk, and shared with the chunk states, so that every
    decay of the chunk comes from the same sums (the CUDA kernel sums in the
    same order)."""
    Q = cs.shape[-1]
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=cs.device))
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked_ref(
    x: torch.Tensor,                    # [B, S, H, P]
    dt: torch.Tensor,                   # [B, S, H]   (already softplus'd, > 0)
    A: torch.Tensor,                    # [H]         (negative)
    B_: torch.Tensor,                   # [B, S, G, N]
    C: torch.Tensor,                    # [B, S, G, N]
    *,
    chunk: int,
    init_state: Optional[torch.Tensor] = None,   # [B, H, P, N]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y [B,S,H,P] in x.dtype, final_state [B,H,P,N] fp32)."""
    Bsz, S, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    rep = H // G
    pad = (-S) % chunk
    if pad:       # zero rows: dt = 0 there, so they add no state
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    nc = x.shape[1] // chunk

    f32 = torch.float32
    xc = x.reshape(Bsz, nc, chunk, H, P).to(f32)
    dtc = dt.reshape(Bsz, nc, chunk, H).to(f32)
    Bc = B_.reshape(Bsz, nc, chunk, G, N).to(f32)
    Cc = C.reshape(Bsz, nc, chunk, G, N).to(f32)

    dA = dtc * A.to(f32)[None, None, None, :]                  # [B,nc,Q,H]
    dA_cum = torch.cumsum(dA, dim=2)                            # within-chunk
    dA_total = dA_cum[:, :, -1]                                 # [B,nc,H]

    # intra-chunk (dual quadratic form); C.B^T once per group
    Lmat = torch.exp(_segsum(dA_cum.permute(0, 1, 3, 2)))       # [B,nc,H,Q,Q]
    CB = torch.einsum("bcqgn,bckgn->bcgqk", Cc, Bc)             # [B,nc,G,Q,Q]
    CB = torch.repeat_interleave(CB, rep, dim=2)                # [B,nc,H,Q,Q]
    xdt = xc * dtc[..., None]                                   # [B,nc,Q,H,P]
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", CB * Lmat, xdt)

    # chunk states
    decay_to_end = torch.exp(dA_total[:, :, None, :] - dA_cum)  # [B,nc,Q,H]
    Bh = torch.repeat_interleave(Bc, rep, dim=3)                # [B,nc,Q,H,N]
    states = torch.einsum("bcqhn,bcqhp,bcqh->bchpn", Bh, xdt, decay_to_end)

    # inter-chunk scan: the state before each chunk
    h = (torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device)
         if init_state is None else init_state.to(f32))
    h_before = []
    for c in range(nc):
        h_before.append(h)
        h = h * torch.exp(dA_total[:, c])[:, :, None, None] + states[:, c]
    h_before = torch.stack(h_before, dim=1)                     # [B,nc,H,P,N]

    Ch = torch.repeat_interleave(Cc, rep, dim=3)                # [B,nc,Q,H,N]
    y_inter = torch.einsum("bcqhn,bchpn,bcqh->bcqhp",
                           Ch, h_before, torch.exp(dA_cum))
    y = (y_intra + y_inter).reshape(Bsz, nc * chunk, H, P)[:, :S]
    return y.to(x.dtype), h
