#!/usr/bin/env python3
"""The fluid surrogate's sweep throughput on the card (the port's counterpart
of ``benchmarks/bench_surrogate.py``).

    PYTHONPATH=src python3 scripts/bench_torch_surrogate.py [--quick] [--device cuda]

Runs the same fleet-scale grid as the JAX package's benchmark — the
heavy_tail preset on a 200-machine x 2-VM fleet with replication 2, every
surrogate-lowerable policy, 200 paired seeds (1000 cells; ``--quick``: 20
seeds, 100 cells) — through the port: the cells are built on the host once
per (trace, seed) and shared across the policy columns, as ``run_surrogate``
shares them, then integrated in one ``run_batch`` call (on the card one
launch of the fluid-scan kernel for the grid's one bucket).  A warm-up batch
of one cell builds and loads the kernel first; that time is reported apart.

Prints one JSON object: the build / integrate split in seconds (host clock,
the integration ending in a synchronize), the kernel's own time by CUDA
events, cells/s end to end (build + integrate), the steps the cells
integrated before their early exit, the card's name and power limit, and the
commit.  It times no event engine and writes no file.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO_ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO_ROOT / "src"))

from repro_torch.core.types import ClusterSpec                          # noqa: E402
from repro_torch.experiments.runner import ExperimentSpec, TraceRef     # noqa: E402
from repro_torch.kernels.fluid_scan import ops as fluid_ops             # noqa: E402
from repro_torch.simcluster.surrogate import (SURROGATE_ENGINE_ID,      # noqa: E402
                                              build_cell, lower_policy,
                                              run_batch)

POLICIES = ("proposed", "fair", "fifo", "delay", "edf_nopark")


def git_commit() -> str:
    """Short HEAD hash, ``-dirty`` when the tree has uncommitted changes."""
    try:
        commit = subprocess.run(
            ["git", "-C", str(REPO_ROOT), "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, check=True, timeout=10).stdout.strip()
        status = subprocess.run(
            ["git", "-C", str(REPO_ROOT), "status", "--porcelain"],
            capture_output=True, text=True, check=True, timeout=10).stdout
        return commit + ("-dirty" if status.strip() else "")
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def sweep_spec(n_seeds: int) -> ExperimentSpec:
    return ExperimentSpec(
        name="bench-surrogate-fleet",
        traces=(TraceRef(preset="heavy_tail"),),
        clusters=(ClusterSpec(num_machines=200, vms_per_machine=2, replication=2),),
        schedulers=POLICIES,
        seeds=tuple(range(n_seeds)))


def build_inputs(spec: ExperimentSpec) -> list:
    """Every cell's inputs, built once per (trace, seed, cluster) and shared
    across the policy columns."""
    resolved: dict = {}
    base: dict = {}
    inputs = []
    for cell in spec.cells():
        tkey = (id(cell.trace), cell.seed)
        if tkey not in resolved:
            resolved[tkey] = cell.trace.resolve(cell.seed)
        trace = resolved[tkey]
        bkey = (id(trace), id(cell.cluster), cell.seed)
        if bkey not in base:
            base[bkey] = build_cell(trace, cell.cluster, cell.scheduler, cell.seed)
            inputs.append(base[bkey])
        else:
            inputs.append(dataclasses.replace(
                base[bkey], policy=lower_policy(cell.scheduler)))
    return inputs


def timed_launches(device: torch.device, into: list):
    """``fluid_ops.fluid_scan`` with each call timed by CUDA events."""
    scan = fluid_ops.fluid_scan

    def timed(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = scan(*args, **kwargs)
        end.record()
        into.append((start, end))
        return out

    return timed if device.type == "cuda" else scan


def bench(n_seeds: int, device: torch.device) -> dict:
    spec = sweep_spec(n_seeds)
    t0 = time.perf_counter()
    inputs = build_inputs(spec)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_batch(inputs[:1], device=device)          # builds and loads the kernel
    warmup_s = time.perf_counter() - t0
    events: list = []
    scan = fluid_ops.fluid_scan
    fluid_ops.fluid_scan = timed_launches(device, events)
    try:
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = run_batch(inputs, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize()
        integrate_s = time.perf_counter() - t0
    finally:
        fluid_ops.fluid_scan = scan
    kernel_ms = sum(s.elapsed_time(e) for s, e in events) if events else None
    steps = [r.steps_integrated for r in results]
    return {
        "engine_id": SURROGATE_ENGINE_ID,
        "description": ("heavy_tail trace x 200x2 fleet (replication 2) x "
                        f"{len(POLICIES)} policies x {n_seeds} seeds, all cells "
                        "in one run_batch call"),
        "device": str(device),
        "card": card() if device.type == "cuda" else None,
        "git_commit": git_commit(),
        "cells": len(inputs),
        "buckets": sorted({(c.padded_jobs(), c.n_steps()) for c in inputs}),
        "build_time_s": build_s,
        "warmup_s": warmup_s,
        "integrate_time_s": integrate_s,
        "cells_per_sec": len(inputs) / (build_s + integrate_s),
        "kernel_launches": len(events) if events else None,
        "kernel_ms": kernel_ms,
        "steps_integrated_max": max(steps),
        "steps_integrated_total": sum(steps),
        "us_per_integrated_step": (kernel_ms * 1e3 / max(steps)) if kernel_ms else None,
        "jobs_finished": sum(r.jobs_finished for r in results),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--quick", action="store_true", help="100 cells (20 seeds)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernel, the default) or cpu (the plain version)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("bench_torch_surrogate: no CUDA device is available", file=sys.stderr)
        return 1
    entry = bench(20 if args.quick else 200, device)
    entry["mode"] = "quick" if args.quick else "full"
    print(json.dumps(entry))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
