"""Per-device FLOPs and collective wire bytes of a step: the port's
counterpart of the JAX package's ``analysis/hlo.py``.

That module parses XLA's optimized HLO because ``cost_analysis`` visits a
``while`` body once and under-counts a scan over layers by about L x.  The
port runs eagerly (layers are a Python loop), so there is no loop to
under-count and nothing to parse:

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` counts every matrix
  product (``mm``, ``bmm``, ``addmm``, ``baddbmm``, attention) and
  convolution of a step run on ``meta`` tensors, which allocate nothing.
* Collective wire bytes per device come from the sharding specs
  (``parallel.sharding``), with the JAX package's ring model:
    all-gather      (g-1)/g · out_bytes
    reduce-scatter  (g-1)   · out_bytes          (= (g-1)/g · in_bytes)
    all-reduce      2(g-1)/g · bytes
    all-to-all      (g-1)/g · bytes
    collective-permute  bytes

``StepSummary.to_json()`` has ``HloSummary.to_json()``'s keys, so the roofline
reads either package's records.  Its ``hbm_bytes`` is 0 and
``unknown_trip_loops`` 0: a meta run moves no bytes and has no loops to trip.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.launch.mesh import axis_sizes

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# the 2-D product weights by the rule of ``parallel.sharding`` that puts the
# model axis on their input (row-parallel) or output (column-parallel) dim
ROW_PARALLEL = {"wo", "w_down", "w_out", "tok"}
COLUMN_PARALLEL = {"wq", "wk", "wv", "w_gate", "w_up", "w_z", "w_x", "in_proj",
                   "lm_head", "w_uk", "w_uv"}


@dataclass
class StepSummary:
    dot_flops: float = 0.0
    conv_flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: Dict[str, float] = field(default_factory=dict)
    collective_counts: Dict[str, int] = field(default_factory=dict)
    unknown_trip_loops: int = 0
    per_collective: List[Dict] = field(default_factory=list)

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    @property
    def total_flops(self) -> float:
        return self.dot_flops + self.conv_flops

    def to_json(self) -> Dict:
        return {
            "dot_flops": self.dot_flops,
            "conv_flops": self.conv_flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": dict(self.collective_bytes),
            "collective_counts": dict(self.collective_counts),
            "total_collective_bytes": self.total_collective_bytes,
            "unknown_trip_loops": self.unknown_trip_loops,
        }

    def add_collective(self, op: str, nbytes: float, group: int,
                       mult: float = 1.0, what: str = "") -> None:
        """One collective of ``nbytes`` (its output; all-reduce: its
        buffer) over a group of ``group`` devices, ``mult`` times a step."""
        if op not in COLLECTIVES:
            raise ValueError(f"unknown collective {op!r}")
        if group <= 1 or nbytes <= 0 or mult <= 0:
            return
        wire = wire_bytes(op, nbytes, group)
        self.collective_bytes[op] = self.collective_bytes.get(op, 0.0) + mult * wire
        self.collective_counts[op] = self.collective_counts.get(op, 0) + 1
        self.per_collective.append({"op": op, "what": what, "bytes": nbytes,
                                    "group": group, "mult": mult,
                                    "wire_bytes": mult * wire})


def wire_bytes(op: str, nbytes: float, group: int) -> float:
    """Bytes one device sends for one collective, by the ring model."""
    g = max(group, 1)
    if op == "all-gather":
        return nbytes * (g - 1) / g
    if op == "reduce-scatter":
        return nbytes * (g - 1)
    if op == "all-reduce":
        return 2 * nbytes * (g - 1) / g
    if op == "all-to-all":
        return nbytes * (g - 1) / g
    return nbytes


def count_flops(fn: Callable, *args, **kwargs) -> Tuple[float, float]:
    """(dot FLOPs, convolution FLOPs) of ``fn(*args, **kwargs)``, as
    ``FlopCounterMode`` counts them; run it on meta tensors to count a step
    of any size."""
    with FlopCounterMode(display=False) as mode:
        fn(*args, **kwargs)
    dot = conv = 0.0
    for op, flops in mode.get_flop_counts()["Global"].items():
        if "convolution" in str(op):
            conv += flops
        else:
            dot += flops
    return dot, conv


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _group(sizes: Dict[str, int], axes: Iterable[str]) -> int:
    g = 1
    for a in axes:
        g *= sizes.get(a, 1)
    return g


def _nbytes(shape, dtype: torch.dtype) -> float:
    n = 1
    for d in shape:
        n *= d
    return float(n) * dtype.itemsize


def sharded_leaves(tree, prefix: str = ""):
    """(path, leaf) of every ``ShardedShape`` of a tree of dicts and lists,
    dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from sharded_leaves(tree[k], f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from sharded_leaves(v, f"{prefix}/{i}" if prefix else str(i))
    else:
        yield prefix, tree


def param_collectives(summary: StepSummary, params, mesh, *, fsdp_axes, dp_axes,
                      tp_axis: str, kind: str, microbatches: int = 1,
                      forward_passes: int = 1, tokens: float = 0.0,
                      compute_dtype: torch.dtype = torch.bfloat16) -> None:
    """Add a step's collectives, read from its params' ``ShardedShape``s
    (``parallel.sharding.attach``), to ``summary``:

    * each leaf sharded over FSDP axes is all-gathered over them (in the
      compute dtype) before each forward pass of each microbatch;
    * train: each leaf's fp32 gradient is reduce-scattered onto its FSDP
      shards, or all-reduced over the data axes it is not sharded on, once a
      microbatch;
    * a 2-D product weight (``ROW_PARALLEL``: the output projections and the
      vocab-parallel embedding) whose contracted dim is over ``tp_axis``
      all-reduces its output over it, ``tokens`` rows of its output width,
      each forward pass; one (``COLUMN_PARALLEL``) whose output dim is over
      ``tp_axis`` all-reduces its input's gradient in each backward.

    The MoE layers' expert weights (3-D) and their dispatch (all-to-all),
    and a pipeline's collective-permutes, are not modelled."""
    sizes = axis_sizes(mesh)
    fsdp_set, dp_set = set(fsdp_axes), set(dp_axes)
    tp = sizes.get(tp_axis, 1)
    act = compute_dtype.itemsize
    for path, leaf in sharded_leaves(params):
        entries = tuple(leaf.spec) + (None,) * (len(leaf.shape) - len(leaf.spec))
        used = [a for e in entries for a in _axes(e)]
        g_fsdp = _group(sizes, [a for a in used if a in fsdp_set])
        gathered = [d * _group(sizes, [a for a in _axes(e) if a in fsdp_set])
                    for d, e in zip(leaf.local_shape, entries)]
        summary.add_collective("all-gather", _nbytes(gathered, compute_dtype), g_fsdp,
                               microbatches * forward_passes, f"{path}: fsdp gather")
        if kind == "train":
            summary.add_collective("reduce-scatter",
                                   _nbytes(leaf.local_shape, torch.float32), g_fsdp,
                                   microbatches, f"{path}: grad reduce-scatter")
            rest = _group(sizes, [a for a in dp_set if a not in used])
            summary.add_collective("all-reduce", _nbytes(leaf.local_shape, torch.float32),
                                   rest, microbatches, f"{path}: grad all-reduce")
        name = path.rsplit("/", 1)[-1]
        if len(leaf.shape) != 2 or tp <= 1:
            continue
        d_in, d_out = leaf.shape
        if name in ROW_PARALLEL and tp_axis in _axes(entries[0]):
            summary.add_collective("all-reduce", tokens * d_out * act, tp,
                                   microbatches * forward_passes,
                                   f"{path}: row-parallel output")
        if name in COLUMN_PARALLEL and tp_axis in _axes(entries[1]) and kind == "train":
            summary.add_collective("all-reduce", tokens * d_in * act, tp,
                                   microbatches, f"{path}: column-parallel input grad")
