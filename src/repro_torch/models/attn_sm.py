"""Row-parallel attention: explicit (batch x head)-parallel flash attention
on a mesh, the port of the JAX package's ``shard_map`` attention.

For head-misaligned tensor parallelism (llama3.2: 24 q-heads / 8 kv-heads
on a model axis that divides neither), heads cannot be cut over tp.  Here:

  * enter a local region with q, k, v replicated over tp (one boundary
    gather) and the batch over dp;
  * repeat KV to the query heads, flatten the local (B_local x Hq) rows, pad
    them to a multiple of tp; each tp rank runs the flash-attention kernel
    (K1; its plain version on the CPU) on its own rows, as [rows, 1, S, D];
  * all-gather the output rows over tp once at exit.

Under autograd the backward is the backward kernel (K1b) on the local rows;
the gather's backward is this rank's slice of the (replicated) cotangent,
and each input's gradient is a partial sum over tp (each tp rank holds the
gradient of its own rows).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.ops import flash_attention


def applicable(B: int, Hq: int, Sq: int, Skv: int) -> bool:
    from repro_torch.parallel.activations import _STATE as _ACT
    if _ACT["mesh"] is None or _ACT["dp"] is None or _ACT["tp"] is None:
        return False
    if _ACT["tp_size"] <= 1 or B % _ACT["dp_size"] != 0:
        return False
    return Sq == Skv


def rows_layout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                rank: int, size: int):
    """(q, k, v) [B, H, S, D] of one rank -> its rows of the flattened
    layout: the B x Hq rows, KV repeated to the query heads, zero-padded to
    a multiple of ``size``; rank ``rank`` of ``size`` takes the ``rank``-th
    slice, each as [rows_per_rank, 1, S, D]."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    rows = B * Hq
    rpl = -(-rows // size)
    rep = Hq // Hkv
    kr = torch.repeat_interleave(k, rep, dim=1).reshape(rows, Skv, D)
    vr = torch.repeat_interleave(v, rep, dim=1).reshape(rows, Skv, Dv)
    qf = q.reshape(rows, Sq, D)
    pad = rpl * size - rows
    if pad:
        qf, kr, vr = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (qf, kr, vr))
    sl = slice(rank * rpl, (rank + 1) * rpl)
    return qf[sl, None], kr[sl, None], vr[sl, None]


def rows_attention(q, k, v, causal: bool, window: Optional[int],
                   rank: int = 0, size: int = 1) -> torch.Tensor:
    """This rank's rows of the flattened layout through the kernel ->
    [rows_per_rank, Sq, Dv]."""
    qs, ks, vs = rows_layout(q, k, v, rank, size)
    return flash_attention(qs, ks, vs, causal=causal, window=window)[:, 0]


def flash_attention_shard_map(q, k, v, causal: bool, window: Optional[int]):
    """q [B, Hq, S, D], k / v [B, Hkv, S, D] DTensors -> [B, Hq, S, Dv], the
    batch over dp and replicated over tp."""
    from repro_torch.parallel import activations as A
    from repro_torch.parallel.collectives import gather_rows
    from repro_torch.parallel.sharding import PartitionSpec as P

    mesh, dp, tp = A._STATE["mesh"], A._STATE["dp"], A._STATE["tp"]
    tp_size = A._STATE["tp_size"]
    B, Hq, Sq, _ = q.shape
    Dv = v.shape[-1]
    B_l = B // A._STATE["dp_size"]
    rows = B_l * Hq

    def body(ql, kl, vl):
        r = mesh.get_local_rank(tp)
        out_l = rows_attention(ql, kl, vl, causal, window, r, tp_size)
        out = gather_rows(out_l, 0, mesh, tp)
        return out[:rows].reshape(B_l, Hq, Sq, Dv)

    spec = P(dp)
    grad = A.with_partial(spec, tp)
    return A.local_region(body, (q, k, v), (spec,) * 3, spec, (grad,) * 3)
