"""Activation layouts on a device mesh.

The launcher declares the intended activation layout here; model code calls
``shard_acts`` at layer boundaries.  On a mesh the model runs on DTensors
(``torch.distributed.tensor``), and each of these functions is a
``redistribute`` of its DTensor argument to the layout the JAX package's
sharding constraint names.  A plain tensor (one device, no mesh) and any call
while the state is unset come back unchanged.

Layout convention for [B, S, D] activations:
  dim 0 (batch)     -> dp entry ("data" or ("pod","data"))
  dim 1 (sequence)  -> sp entry (sequence parallelism, optional)
  dim 2 (hidden)    -> None (materialized fully per shard between matmuls)
Logits [B, S, V] additionally shard V over tp (set by ``shard_logits``).

``local_region`` is the port's ``shard_map``: a function of plain tensors run
on each rank's shards, its outputs DTensors again.  The hand-written kernels
always run inside one.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from repro_torch.parallel.sharding import PartitionSpec as P
from repro_torch.parallel.sharding import placements

_STATE = {"dp": None, "dp_size": 1, "sp": None, "sp_size": 1,
          "tp": None, "tp_size": 1, "mesh": None, "fsdp": None}


def set_activation_sharding(dp=None, dp_size=1, sp=None, sp_size=1,
                            tp=None, tp_size=1, mesh=None, fsdp=None) -> None:
    _STATE.update(dp=dp, dp_size=dp_size, sp=sp, sp_size=sp_size,
                  tp=tp, tp_size=tp_size, mesh=mesh, fsdp=fsdp)


def clear() -> None:
    set_activation_sharding()


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _active(x) -> bool:
    return _STATE["dp"] is not None and _STATE["mesh"] is not None and is_dtensor(x)


def _entry(name, dim_size):
    e, size = _STATE[name], _STATE[name + "_size"]
    if e is None or size <= 1 or dim_size % size != 0:
        return None
    return e


def constrain(x, spec: P):
    """``x`` redistributed to ``spec`` on the state's mesh (the port's
    ``with_sharding_constraint``)."""
    mesh = _STATE["mesh"]
    return x.redistribute(mesh, placements(spec, mesh))


def shard_embed_out(x):
    """Stage the vocab-sharded-gather output towards the activation layout:
    (dp, None, tp) first, then ``shard_acts``."""
    if not _active(x) or x.ndim != 3:
        return x
    spec = [_entry("dp", x.shape[0]), None, _entry("tp", x.shape[2])]
    if any(s is not None for s in spec):
        x = constrain(x, P(*spec))
    return shard_acts(x)


def shard_acts(x):
    """Constrain [B, ...] activations: batch over dp, seq over sp."""
    if not _active(x) or x.ndim < 2:
        return x
    spec = [_entry("dp", x.shape[0])]
    if x.ndim >= 3:
        spec.append(_entry("sp", x.shape[1]))
    if all(s is None for s in spec):
        return x
    return constrain(x, P(*spec))


def shard_attn_qkv(q, k, v):
    """Attention-interior layout ([B, H, S, D] each): batch over dp, and
    heads over tp when both Hq and Hkv divide it (classic TP).

    The JAX package shards the *sequence* over tp otherwise; the port's
    attention kernel takes whole sequences, so there the heads stay whole on
    every tp rank (the row-parallel ``attn_sm`` path is the port's answer to
    misaligned heads)."""
    if not _active(q) or q.ndim != 4:
        return q, k, v
    dp = _entry("dp", q.shape[0])
    tp, tps = _STATE["tp"], _STATE["tp_size"]
    heads_ok = (tp is not None and tps > 1 and q.shape[1] % tps == 0
                and k.shape[1] % tps == 0)
    spec = P(dp, tp if heads_ok else None)
    return constrain(q, spec), constrain(k, spec), constrain(v, spec)


def bh_flat_entry(b: int, h: int):
    """Joint (batch*heads) sharding over dp×tp for the flattened-attention
    layout; None when the product doesn't divide."""
    if _STATE["dp"] is None:
        return None
    dp, tp = _STATE["dp"], _STATE["tp"]
    total = _STATE["dp_size"] * _STATE["tp_size"]
    if tp is None or total <= 1 or (b * h) % total != 0:
        return None
    return (dp if isinstance(dp, tuple) else (dp,)) + (tp,)


def shard_bh(x):
    """x: [B*H, 1, S, D] — constrain dim0 over dp×tp."""
    if not _active(x):
        return x
    entry = bh_flat_entry(x.shape[0], 1)
    if entry is None:
        return x
    return constrain(x, P(entry))


def shard_logits(x):
    """[B, S, V]: batch over dp, vocab over tp."""
    if not _active(x) or x.ndim != 3:
        return x
    spec = [_entry("dp", x.shape[0]), _entry("sp", x.shape[1]),
            _entry("tp", x.shape[2])]
    if all(s is None for s in spec):
        return x
    return constrain(x, P(*spec))


def local_region(fn: Callable, args: Sequence, in_specs: Sequence,
                 out_specs, grad_specs: Optional[Sequence] = None):
    """The port's ``shard_map``: ``fn`` on each rank's local shards.

    Each DTensor of ``args`` whose spec is not None is redistributed to it
    and passed as its local tensor; its gradient is taken to have the
    placements of ``grad_specs`` (default: its spec's).  Other args pass as
    they are.  ``fn``'s outputs (a tensor or a tuple) become DTensors with
    ``out_specs``.  A spec is a ``PartitionSpec`` or DTensor placements
    (``with_partial`` marks a partial sum over an axis: the gradient of an
    input replicated over an axis whose ranks each use a part of it)."""
    from torch.distributed.tensor import DTensor
    mesh = _STATE["mesh"]
    grad_specs = grad_specs or [None] * len(args)
    local = []
    for a, spec, gspec in zip(args, in_specs, grad_specs):
        if spec is None or not isinstance(a, DTensor):
            local.append(a)
            continue
        a = a.redistribute(mesh, _placements(spec, mesh))
        local.append(a.to_local(grad_placements=_placements(
            spec if gspec is None else gspec, mesh)))
    out = fn(*local)
    single = not isinstance(out, tuple)
    outs = (out,) if single else out
    specs = (out_specs,) if single else out_specs
    res = tuple(DTensor.from_local(o, mesh, _placements(s, mesh), run_check=False)
                for o, s in zip(outs, specs))
    return res[0] if single else res


def with_partial(spec: P, axis: str) -> tuple:
    """The placements of ``spec`` with a partial sum over mesh axis
    ``axis`` (which ``spec`` leaves unsharded)."""
    from torch.distributed.tensor import Partial
    mesh = _STATE["mesh"]
    out = list(placements(spec, mesh))
    out[tuple(mesh.mesh_dim_names).index(axis)] = Partial()
    return tuple(out)


def _placements(spec, mesh) -> tuple:
    return placements(spec, mesh) if isinstance(spec, P) else tuple(spec)


def _slice_of(mesh, axes, n: int):
    """(start, width) of this rank's contiguous slice of a dim of ``n``
    sharded over mesh dims ``axes`` (major first)."""
    width, lo = n, 0
    for i in axes:
        width //= mesh.size(i)
        lo += mesh.get_local_rank(i) * width
    return lo, width


def _as_dtensor(x, mesh):
    from torch.distributed.tensor import Replicate, distribute_tensor
    if is_dtensor(x):
        return x
    return distribute_tensor(x, mesh, [Replicate()] * mesh.ndim)


def gather_last(x, idx):
    """``torch.gather(x, -1, idx[..., None])[..., 0]`` for a DTensor ``x``
    whose last dim (a vocabulary) may be sharded: each rank picks the
    entries that fall in its slice and the ranks' picks are summed, so no
    rank gathers the whole last dim.  ``idx`` is a plain tensor or a DTensor
    of ``x``'s leading shape."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = x.device_mesh
    last = x.ndim - 1
    x_pl = tuple(x.placements)
    vocab_axes = [i for i, p in enumerate(x_pl) if isinstance(p, Shard) and p.dim == last]
    idx_pl = tuple(Replicate() if i in vocab_axes else p for i, p in enumerate(x_pl))
    out_pl = tuple(Partial() if i in vocab_axes else p for i, p in enumerate(x_pl))
    idx = _as_dtensor(idx, mesh).redistribute(mesh, idx_pl).to_local()
    lo, width = _slice_of(mesh, vocab_axes, x.shape[last])
    mine = (idx >= lo) & (idx < lo + width)
    picked = torch.gather(x.to_local(), -1,
                          torch.where(mine, idx - lo, 0)[..., None].long())[..., 0]
    if vocab_axes:
        picked = torch.where(mine, picked, torch.zeros_like(picked))
    return DTensor.from_local(picked, mesh, out_pl, run_check=False)


def embedding(table, tokens):
    """``table[tokens]`` for a DTensor ``table`` [V, d] whose rows (the
    vocabulary) may be sharded: the vocab-parallel lookup.  The table's
    other dim is gathered, each rank looks up the tokens of its batch rows
    that fall in its vocabulary slice, and the output is a partial sum over
    the vocabulary's axes; the table's gradient is a scatter-add on each
    rank's slice, a partial sum over the axes the tokens' batch is split
    on."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    tokens = _as_dtensor(tokens, mesh)
    vocab_axes = [i for i, p in enumerate(table.placements)
                  if isinstance(p, Shard) and p.dim == 0]
    tok_pl = tuple(Replicate() if i in vocab_axes else p
                   for i, p in enumerate(tokens.placements))
    batch_axes = [i for i, p in enumerate(tok_pl) if isinstance(p, Shard)]
    tab_pl = tuple(Shard(0) if i in vocab_axes else Replicate()
                   for i in range(mesh.ndim))
    grad_pl = tuple(Partial() if i in batch_axes else p for i, p in enumerate(tab_pl))
    out_pl = tuple(Partial() if i in vocab_axes else p for i, p in enumerate(tok_pl))
    lo, width = _slice_of(mesh, vocab_axes, table.shape[0])

    def lookup(tab, tok):
        mine = (tok >= lo) & (tok < lo + width)
        rows = torch.nn.functional.embedding(torch.where(mine, tok - lo, 0), tab)
        if vocab_axes:
            rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
        return rows

    return local_region(lookup, (table, tokens), (tab_pl, tok_pl), out_pl,
                        grad_specs=(grad_pl, None))
