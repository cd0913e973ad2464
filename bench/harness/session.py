"""What every mode shares: the card's description, the spans and readers of
the cell's per-layer metrics, the judgement of ``correct``, quantiles."""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional, Tuple

import torch

from bench.harness import cells
from bench.harness.trace import Reading, Spans, profiled, reduce_trace

GIB = float(1 << 30)


def device_info(chips: int, peak_bytes: int, device) -> dict:
    if torch.device(device).type != "cuda":     # the CPU tests' runs
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(peak_bytes)}


def reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def peak_bytes(device) -> int:
    return torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0


def free(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def readers(cell: cells.Cell) -> Dict[str, object]:
    return {m["name"]: cells.metric_module(m["name"]) for m in cell.per_layer}


def spans(cell: cells.Cell) -> Spans:
    """The union of the spans that the cell's per-layer metrics read."""
    union: Dict[str, list] = {}
    for reader in readers(cell).values():
        for region, targets in getattr(reader, "SPANS", {}).items():
            union.setdefault(region, [])
            union[region] += [t for t in targets if t not in union[region]]
    return Spans(union)


def traced(cell: cells.Cell, fn, units_fn, model_flops_fn) -> Tuple[dict, dict, dict]:
    """Run ``fn`` under the cell's spans and the profiler; read each per-layer
    metric from it.  ``units_fn()`` and ``model_flops_fn()`` give the steps or
    batches that ``fn`` completed and their analytic operations.  Returns
    (metrics, the ``device`` additions, the breakdown)."""
    sp = spans(cell)
    with sp.active():
        events, window_s = profiled(fn)
    summary = reduce_trace(events)
    del events
    reading = Reading(mode=cell.mode, window_s=window_s, units=units_fn(),
                      model_flops=model_flops_fn(), summary=summary, calls=dict(sp.calls))
    metrics, rd = {}, readers(cell)
    for m in cell.per_layer:
        value = rd[m["name"]].read(reading)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return (metrics, {"busy_s": summary.busy_s, "window_s": window_s},
            {"device_ops": summary.device_ops, "idle_gaps": summary.idle_gaps})


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, dict]:
    """``correct`` and each number compared beside its limit.  A number that
    is missing or not finite fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name, math.nan)
        passed = math.isfinite(value) and value <= limit
        ok &= passed
        checks[name] = {"value": value, "limit": limit}
    return ok, checks


def p95(values: List[float]) -> float:
    """The 95th percentile, as ``statistics.quantiles`` (exclusive) gives it."""
    if len(values) < 2:
        return values[0] if values else math.nan
    return statistics.quantiles(values, n=100)[94]


def rel_gap(a: float, b: float, floor: float) -> float:
    return abs(a - b) / max(abs(b), floor, 1e-30)


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              counted: Optional[List[str]] = None) -> Dict[str, float]:
    """Each leaf's gap between the program's norm and the reference's,
    against the reference's norm of that leaf or of the median leaf,
    whichever is larger."""
    names = list(ref) if counted is None else counted
    med = statistics.median(ref[n] for n in names)
    return {n: rel_gap(prog[n], ref[n], med) for n in names}


def leaf_errors(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                counted: List[str]) -> Dict[str, float]:
    """Each leaf's norm of the difference between the program's elements and
    the reference's, against the norm of the reference's of that leaf or of
    the median leaf, whichever is larger."""
    norms = {n: float(ref[n].float().norm()) for n in counted}
    med = statistics.median(norms.values())
    return {n: float((prog[n].float() - ref[n].float()).norm()) / max(norms[n], med, 1e-30)
            for n in counted}
