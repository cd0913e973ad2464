"""Sharding rules for every model family, with divisibility fallbacks.

The JAX package's rules, on the port's trees.  The policy maps parameter
leaf *names* to logical roles and assigns mesh axes per role:

* ``tp``   ("model")          — tensor-parallel dim (heads / ffn / vocab / experts-f)
* ``fsdp`` ("data", optional) — ZeRO-3 style parameter sharding; gathered
  where a layer needs the whole weight, gradients reduce-scattered back
* ``dp``   ("data" [+ "pod"]) — batch dim of activations / caches

Every assignment checks divisibility; a dim that does not divide its axis
size falls back to the next candidate (or replication).  This is what lets
one rule-set cover kv_heads ∈ {2..32}, experts ∈ {8, 64}, batch ∈ {1..256}.

A spec is a ``PartitionSpec``: one entry a tensor dim (an axis name, a tuple
of axis names, or ``None``), trailing ``None`` entries dropped.  The port
keeps ``layers`` as a list of per-layer dicts where the JAX package stacks
them ``[L, ...]``, so a port leaf's spec is the JAX package's without its
leading (always ``None``) layer entry.  ``placements`` turns a spec into
``torch.distributed.tensor`` placements on a ``DeviceMesh``:
``Shard(dim)`` on each mesh axis a dim names, ``Replicate()`` elsewhere.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Sequence, Tuple

import torch

from repro_torch.launch.mesh import axis_sizes
from repro_torch.models.common import ModelConfig


class PartitionSpec(tuple):
    """The JAX package's ``PartitionSpec`` with trailing ``None``s dropped:
    ``PartitionSpec("data", None) == PartitionSpec("data")``."""

    def __new__(cls, *entries):
        out = [tuple(e) if isinstance(e, list) else e for e in entries]
        while out and out[-1] is None:
            out.pop()
        return super().__new__(cls, out)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(e) for e in self) + ")"


P = PartitionSpec


@dataclass(frozen=True)
class ShardingPolicy:
    """Axis assignment for one launch configuration."""
    tp_axis: str = "model"
    fsdp: bool = True
    fsdp_axes: Tuple[str, ...] = ("data",)          # can be ("pod","data")
    dp_axes: Tuple[str, ...] = ("data",)            # ("pod","data") multi-pod

    def fsdp_entry(self):
        if not self.fsdp:
            return None
        return self.fsdp_axes if len(self.fsdp_axes) > 1 else self.fsdp_axes[0]

    def dp_entry(self):
        return self.dp_axes if len(self.dp_axes) > 1 else self.dp_axes[0]


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _axsize(mesh, entry) -> int:
    sizes = axis_sizes(mesh)
    n = 1
    for a in _axes(entry):
        n *= sizes[a]
    return n


def _fit(mesh, shape: Tuple[int, ...], wants: Sequence[Any]) -> PartitionSpec:
    """Build a PartitionSpec keeping only divisible assignments, never using
    one mesh axis twice."""
    used = set()
    out = []
    for dim, cand in zip(shape, wants):
        picked = None
        for entry in (cand if isinstance(cand, list) else [cand]):
            if entry is None:
                continue
            axes = _axes(entry)
            if any(a in used for a in axes):
                continue
            if dim % _axsize(mesh, entry) == 0 and _axsize(mesh, entry) > 1:
                picked = entry
                used.update(axes)
                break
        out.append(picked)
    return PartitionSpec(*out)


# ---------------------------------------------------------------------------
# Trees: dicts and lists, leaves anything else
# ---------------------------------------------------------------------------


def _map_named(fn: Callable[[str, Any], Any], tree, name: str = ""):
    """``fn(leaf name, leaf)`` over a tree of dicts and lists; the name is the
    last dict key on the leaf's path (list indices do not name)."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, str(k)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_named(fn, v, name) for v in tree]
    return fn(name, tree)


def spec_leaves(tree) -> List[Any]:
    """The leaves of a tree of specs (or of anything), in ``tree_leaves``
    order: dict keys sorted, lists in order; a ``PartitionSpec`` is a leaf."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in spec_leaves(tree[k])]
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in spec_leaves(v)]
    return [tree]


def map_specs(fn: Callable, tree, *rest):
    """``fn(leaf, *leaves of rest)`` over a tree whose leaves are specs,
    tensors or anything not a dict or list; a tree of the results."""
    if isinstance(tree, dict):
        return {k: map_specs(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, list):
        return [map_specs(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


# ---------------------------------------------------------------------------
# Parameter rules
# ---------------------------------------------------------------------------

# name -> (expected trailing ndim, wants builder)
def _param_rules(pol: ShardingPolicy):
    tp, fs = pol.tp_axis, pol.fsdp_entry()
    return {
        # [in, out(tp)]
        "wq": (2, [fs, tp]), "wk": (2, [fs, tp]), "wv": (2, [fs, tp]),
        "w_gate": (2, [fs, tp]), "w_up": (2, [fs, tp]),
        "w_z": (2, [fs, tp]), "w_x": (2, [fs, tp]),
        "in_proj": (2, [fs, tp]),
        "lm_head": (2, [fs, tp]),
        # [in(tp), out]
        "wo": (2, [tp, fs]), "w_down": (2, [tp, fs]), "w_out": (2, [tp, fs]),
        # embeddings: vocab on tp (row-parallel gather + AR)
        "tok": (2, [tp, fs]),
        "pos_embed": (2, [None, fs]),
        # small projections
        "w_B": (2, [fs, None]), "w_C": (2, [fs, None]), "w_dt": (2, [fs, None]),
        "w_dkv": (2, [fs, None]),
        "w_uk": (2, [None, tp]), "w_uv": (2, [None, tp]),
        "router": (2, [None, None]),
        # conv kernels [K, channels(tp)]
        "conv_x": (2, [None, tp]), "conv_B": (2, [None, tp]),
        "conv_C": (2, [None, tp]),
        # vectors
        "scale": (1, [None]), "bias": (1, [None]),
        "A_log": (1, [None]), "D": (1, [None]), "dt_bias": (1, [None]),
        # zamba lora [napp, d, r] / [napp, r, f]
        "lora_a": (3, [None, fs, None]), "lora_b": (3, [None, None, tp]),
    }


def make_param_specs(cfg: ModelConfig, params_shapes, mesh, pol: ShardingPolicy):
    """params_shapes: the port's parameter tree, of tensors or of anything
    with a ``shape`` (meta tensors from ``launch.specs.params_shapes``).
    Expert tensors [E, d, f] take the rules of their 2-D names on their
    trailing dims."""
    rules = _param_rules(pol)

    def spec(name, leaf):
        shape = tuple(leaf.shape)
        if name not in rules:
            return PartitionSpec()
        nd, wants = rules[name]
        extra = len(shape) - nd
        if extra < 0:
            return PartitionSpec()
        return _fit(mesh, shape, [None] * extra + list(wants))

    return _map_named(spec, params_shapes)


def make_opt_specs(param_specs):
    """AdamW state mirrors params; step is replicated."""
    return {"m": param_specs, "v": param_specs, "step": PartitionSpec()}


# ---------------------------------------------------------------------------
# Batch / cache rules
# ---------------------------------------------------------------------------


def make_batch_specs(cfg: ModelConfig, batch_shapes, mesh, pol: ShardingPolicy):
    """Batch dim first everywhere; shard it over dp (fall back to nothing)."""
    dp = pol.dp_entry()

    def spec(name, leaf):
        shape = tuple(leaf.shape)
        return _fit(mesh, shape, [dp] + [None] * (len(shape) - 1))

    return _map_named(spec, batch_shapes)


def make_cache_specs(cfg: ModelConfig, cache_shapes, mesh, pol: ShardingPolicy):
    """KV/state caches: [L?, B, heads?, S, ...] — batch over dp, heads over
    tp when divisible, otherwise sequence over tp (flash-decode style); for
    batch=1 long-context cells the sequence dim picks up dp as well.  The
    cache's ``len`` (a Python int in the port) is replicated."""
    dp, tp = pol.dp_entry(), pol.tp_axis

    def spec(name, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        if name == "len" or len(shape) == 0:
            return PartitionSpec()
        if name in ("k", "v", "attn_k", "attn_v", "cross_k", "cross_v"):
            # [L, B, H, S, hd]
            return _fit(mesh, shape, [None, dp, tp, [tp, dp], None])
        if name in ("c_kv", "k_rope"):
            # [L, B, S, r]
            return _fit(mesh, shape, [None, dp, [tp, dp], None])
        if name == "ssm":
            # [L, B, H, P, N]
            return _fit(mesh, shape, [None, dp, tp, None, None])
        if name.startswith("conv_"):
            # [L, B, K-1, channels]
            return _fit(mesh, shape, [None, dp, None, tp])
        return _fit(mesh, shape, [None, dp] + [None] * (len(shape) - 2))

    return _map_named(spec, cache_shapes)


# ---------------------------------------------------------------------------
# Specs on a device mesh
# ---------------------------------------------------------------------------


def placements(spec: PartitionSpec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh``):
    ``Shard(dim)`` on each mesh axis that tensor dim ``dim`` names,
    ``Replicate()`` on the others.  A dim over several axes names them in
    the mesh's order, major first, as the JAX package's meshes do."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"{spec}: axes {axes} out of the mesh's order {names}")
        for i in pos:
            out[i] = Shard(dim)
    return tuple(out)


def local_shape(shape: Sequence[int], spec: PartitionSpec, mesh) -> Tuple[int, ...]:
    """The shape of one rank's shard of a ``shape`` tensor under ``spec``."""
    out = list(shape)
    for dim, entry in enumerate(spec):
        out[dim] //= _axsize(mesh, entry)
    return tuple(out)


def distribute_params(params, specs, mesh):
    """Every leaf of ``params`` (the same full tensors on every rank) as a
    DTensor on ``mesh`` with its spec's placements; each rank keeps its
    shard."""
    from torch.distributed.tensor import distribute_tensor
    return map_specs(lambda x, s: distribute_tensor(x, mesh, placements(s, mesh)),
                     params, specs)


def shard_batch(x: torch.Tensor, spec: PartitionSpec, mesh):
    """A DTensor of ``x`` (the same full tensor on every rank) with ``spec``'s
    placements, each rank keeping its own slice: no communication."""
    from torch.distributed.tensor import DTensor, Shard
    pl = placements(spec, mesh)
    local = x
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            local = torch.chunk(local, mesh.size(i), dim=p.dim)[mesh.get_local_rank(i)]
    return DTensor.from_local(local.contiguous(), mesh, pl, run_check=False)


def gather_params(tree):
    """Full tensors of a tree of DTensors (every rank gets them: for
    checkpoints and tests); a plain tensor is returned as it is."""
    from torch.distributed.tensor import DTensor
    return map_specs(lambda x: x.full_tensor() if isinstance(x, DTensor) else x,
                     tree)


@dataclass(frozen=True)
class ShardedShape:
    """A leaf's global shape and type with its spec and one shard's shape:
    the port's ``ShapeDtypeStruct`` with a sharding, for the dry-run."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    spec: PartitionSpec
    local_shape: Tuple[int, ...]


def attach(mesh, shapes, specs):
    """A tree of (meta) tensors + its spec tree -> a tree of
    ``ShardedShape``s on ``mesh`` (an ``AbstractMesh`` or a ``DeviceMesh``)."""
    return map_specs(lambda s, p: ShardedShape(
        tuple(s.shape), s.dtype, p, local_shape(s.shape, p, mesh)), shapes, specs)


def abstract_with_sharding(fn, mesh, pol, cfg, *args):
    """``fn(*args)`` run on the meta device (it must build its tensors on
    ``meta``; nothing is allocated) -> (its ``attach``ed shapes, its param
    specs)."""
    shapes = fn(*args)
    specs = make_param_specs(cfg, shapes, mesh, pol)
    return attach(mesh, shapes, specs), specs
