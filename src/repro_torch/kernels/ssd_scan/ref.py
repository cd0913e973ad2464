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


def ssd_chunked_bwd_ref(
    x: torch.Tensor,                    # [B, S, H, P]
    dt: torch.Tensor,                   # [B, S, H]
    A: torch.Tensor,                    # [H]
    B_: torch.Tensor,                   # [B, S, G, N]
    C: torch.Tensor,                    # [B, S, G, N]
    init_state: Optional[torch.Tensor],           # [B, H, P, N] or None
    dy: torch.Tensor,                   # [B, S, H, P], the gradient of y
    d_final_state: Optional[torch.Tensor],        # [B, H, P, N] or None (0)
    *,
    chunk: int,
    round_operands: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """The gradient of ``ssd_chunked_ref``: (dx, ddt, dA, dB, dC,
    d_init_state), fp32 inside (float64 for float64 inputs, to measure the
    fp32 version against); dx, dB and dC in the inputs' types, the rest in
    the inside type.  ``d_init_state`` is the gradient of the initial state
    (of a zero one when ``init_state`` is None).

    Written out pass by pass in the order the backward kernel computes it,
    for one chunk c of Q rows, u_j = dt_j x_j, cum the in-order cumsum of
    dt A, h_c the state before the chunk and dh_{c+1} the gradient of the
    state after it, L_ij = exp(cum_i - cum_j) for i >= j (0 above):

    1. the chunk's terms of the two recurrences: sum_j exp(cum_last - cum_j)
       u_j (x) B_j and sum_i exp(cum_i) dy_i (x) C_i;
    2. the forward recurrence h_c, then the reverse one
       dh_c = exp(cum_last) dh_{c+1} + sum_i exp(cum_i) dy_i (x) C_i, from
       ``d_final_state`` down to ``d_init_state``;
    3. per chunk, with M = L o (C B^T) and G = L o (dy u^T):
       du = M^T dy + exp(cum_last - cum_j) B dh^T, dC = G B + exp(cum_i) dy h,
       dB = G^T C + exp(cum_last - cum_j) u dh, and the gradient of each
       cum that a term reads;
    4. ddA = the reverse in-chunk cumsum of dcum: ddt = x . du + A ddA,
       dA = sum dt ddA;
    5. dB and dC summed over each group's heads.

    A ragged last chunk is padded with dt = 0 rows, as the forward pads, and
    the padded rows' gradients are dropped.

    ``round_operands`` rounds to bf16 exactly what the wgmma variant of the
    backward kernel (``ssd_bwd_wgmma``) rounds, each where it is the operand
    of a bf16 product and nowhere else: M in du, G in dC and dB, h_c in dC's
    term from the state and in exp(cum_last) <h_c, dh_{c+1}>, dh_{c+1} in
    du's and dB's terms from the state.  The chunks' terms of the two
    recurrences stay in the inside type (the kernel keeps some 16 bits of
    each, in two bf16 parts), as do dS and every sum."""
    Bsz, S, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    rep = H // G
    pad = (-S) % chunk
    if pad:
        x, dy = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, dy))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_, C = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (B_, C))
    nc = x.shape[1] // chunk
    Q = chunk

    f32 = torch.float64 if x.dtype == torch.float64 else torch.float32

    def op(t: torch.Tensor) -> torch.Tensor:
        """t as the operand of a product: bf16 under round_operands."""
        return t.to(torch.bfloat16).to(f32) if round_operands else t

    xc = x.reshape(Bsz, nc, Q, H, P).to(f32)
    dyc = dy.reshape(Bsz, nc, Q, H, P).to(f32)
    dtc = dt.reshape(Bsz, nc, Q, H).to(f32)
    Bc = B_.reshape(Bsz, nc, Q, G, N).to(f32)
    Cc = C.reshape(Bsz, nc, Q, G, N).to(f32)
    Bh = torch.repeat_interleave(Bc, rep, dim=3)                # [B,nc,Q,H,N]
    Ch = torch.repeat_interleave(Cc, rep, dim=3)
    Af = A.to(f32)

    cum = torch.cumsum(dtc * Af[None, None, None, :], dim=2)    # [B,nc,Q,H]
    cum_last = cum[:, :, -1]                                    # [B,nc,H]
    u = xc * dtc[..., None]                                     # [B,nc,Q,H,P]
    to_end = torch.exp(cum_last[:, :, None, :] - cum)           # [B,nc,Q,H]
    from_start = torch.exp(cum)

    # 1. the chunk's terms of the forward and the reverse recurrence
    states = torch.einsum("bcqhn,bcqhp,bcqh->bchpn", Bh, u, to_end)
    d_local = torch.einsum("bcqhn,bcqhp,bcqh->bchpn", Ch, dyc, from_start)

    # 2. h_c in fp32 (recomputed: the forward keeps no fp32 copy), then dh
    #    from the last chunk down, with exp(cum_last) <h_c, dh_{c+1}>
    h = (torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device)
         if init_state is None else init_state.to(f32))
    h_before = []
    for c in range(nc):
        h_before.append(h)
        h = h * torch.exp(cum_last[:, c])[:, :, None, None] + states[:, c]
    dh = (torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device)
          if d_final_state is None else d_final_state.to(f32))
    dh_after, h_dh = [None] * nc, [None] * nc
    for c in reversed(range(nc)):
        dh_after[c] = dh
        decay = torch.exp(cum_last[:, c])                       # [B,H]
        h_dh[c] = decay * (op(h_before[c]) * dh).sum((-2, -1))
        dh = dh * decay[:, :, None, None] + d_local[:, c]
    d_init = dh
    h_before = torch.stack(h_before, dim=1)                     # [B,nc,H,P,N]
    dh_after = torch.stack(dh_after, dim=1)
    h_dh = torch.stack(h_dh, dim=1)                             # [B,nc,H]

    # 3. the chunk gradients, within the chunk (i rows, j columns) and from
    #    the states at its two ends
    Lmat = torch.exp(_segsum(cum.permute(0, 1, 3, 2)))          # [B,nc,H,Q,Q]
    CB = torch.einsum("bcign,bcjgn->bcgij", Cc, Bc)
    CB = torch.repeat_interleave(CB, rep, dim=2)                # [B,nc,H,Q,Q]
    YU = torch.einsum("bcihp,bcjhp->bchij", dyc, u)
    M = Lmat * CB
    Gm = Lmat * YU
    dS = M * YU
    du_inter = to_end[..., None] * torch.einsum("bcjhn,bchpn->bcjhp", Bh, op(dh_after))
    du = torch.einsum("bchij,bcihp->bcjhp", op(M), dyc) + du_inter
    dC_inter = from_start[..., None] * torch.einsum("bcihp,bchpn->bcihn", dyc,
                                                    op(h_before))
    dC = torch.einsum("bchij,bcjhn->bcihn", op(Gm), Bh) + dC_inter
    dB = (torch.einsum("bchij,bcihn->bcjhn", op(Gm), Ch)
          + to_end[..., None] * torch.einsum("bcjhp,bchpn->bcjhn", u, op(dh_after)))
    # the decays: dS_ij moves cum_i up and cum_j down; dy_i . y_inter_i is
    # C_i . dC_inter_i; s_j = exp(cum_last - cum_j) <u_j (x) B_j, dh_{c+1}>
    # moves cum_j down and cum_last up, as does exp(cum_last) <h_c, dh_{c+1}>
    s = (u * du_inter).sum(-1)                                  # [B,nc,Q,H]
    dcum = (dS.sum(-1) - dS.sum(-2)).permute(0, 1, 3, 2) \
        + (Ch * dC_inter).sum(-1) - s
    dcum[:, :, -1] += s.sum(2) + h_dh

    # 4. the gradient of dt A is the reverse in-chunk cumsum of dcum
    ddA = torch.flip(torch.cumsum(torch.flip(dcum, (2,)), dim=2), (2,))
    ddt = (xc * du).sum(-1) + Af * ddA
    # dA = sum_k dt_k ddA_k = sum_m dcum_m cum_m / A, taken term by term: each
    # pair's dS_ij with cum_i - cum_j and each s_j with cum_last - cum_j, not
    # dcum_m with cum_m (which reaches some -200 at chunk 256 and would
    # multiply the rounding of dcum's cancelling sums by as much)
    dcum_cum = ((dS * (cum.permute(0, 1, 3, 2)[..., :, None]
                       - cum.permute(0, 1, 3, 2)[..., None, :])).sum((-2, -1))
                + (s * (cum_last[:, :, None, :] - cum)).sum(2)
                + ((Ch * dC_inter).sum(-1) * cum).sum(2)
                + h_dh * cum_last)                              # [B,nc,H]
    dA = dcum_cum.sum((0, 1)) / Af
    dx = dtc[..., None] * du

    # 5. a group's B and C serve its heads: their gradients are the sums
    dB = dB.reshape(Bsz, nc, Q, G, rep, N).sum(4)
    dC = dC.reshape(Bsz, nc, Q, G, rep, N).sum(4)
    Sp = nc * Q
    return (dx.reshape(Bsz, Sp, H, P)[:, :S].to(x.dtype),
            ddt.reshape(Bsz, Sp, H)[:, :S],
            dA,
            dB.reshape(Bsz, Sp, G, N)[:, :S].to(B_.dtype),
            dC.reshape(Bsz, Sp, G, N)[:, :S].to(C.dtype),
            d_init)
