"""Declarative sweep runner with on-disk result caching.

An ``ExperimentSpec`` is a grid: traces x cluster shapes x schedulers x sim
seeds.  ``run_experiment`` materializes every cell, serves the ones already
on disk from the cache, fans the missing ones out over a ``multiprocessing``
pool, and returns the merged ``RunRecord`` list plus simulated/cached
counts — re-running a finished sweep performs **zero** new simulations, and
a partially-extended grid only simulates the new cells.

Cache layout (``<cache_dir>/``)::

    <cell_hash>/meta.json      # the cell descriptor that produced the hash
    <cell_hash>/seed<k>.json   # one RunRecord per sim seed

``cell_hash`` is sha256 over the canonical-JSON cell descriptor: trace
identity (file content hash for path traces; config + seed for generated
ones), ``ClusterSpec.to_dict()``, scheduler name, sim parameters and a
cache-format version.  The sim seed stays out of the hash so a sweep that
adds seeds reuses the same cell directory.

This is the port's own copy of the JAX package's ``experiments/runner.py``:
the descriptors are the original's byte for byte, so a cache either package
wrote is re-served by the other (tests hold both).  Pool workers import
no ``torch``: they run only the event engine, pure Python on the host.
The fluid surrogate's sweeps are
``repro_torch.experiments.surrogate.run_surrogate``.
"""
from __future__ import annotations

import hashlib
import json
import multiprocessing
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple, Union

from repro_torch.core.policies import PolicyError, PolicySpec
from repro_torch.core.types import ClusterSpec
from repro_torch.experiments.metrics import RunRecord, run_record_from_result
from repro_torch.simcluster.sim import ClusterSim
from repro_torch.simcluster.traces import (PRESETS, Trace, TraceConfig, _dumps,
                                           generate_trace, paper_trace,
                                           trace_from_rows)

CACHE_VERSION = 1
# the canonical preset names (kept for compatibility; the scheduler axis
# accepts any registered PolicySpec — see repro_torch.core.policies)
SCHEDULERS = ("proposed", "adaptive", "fair", "fifo")


@dataclass(frozen=True)
class TraceRef:
    """Reference to a trace: a JSONL file, a named preset, an inline
    ``TraceConfig``, or explicit ``rows`` (a hand-built mix, as accepted by
    ``trace_from_rows``).  ``seed`` pins the trace seed; ``None`` couples it
    to each cell's sim seed (fresh placements per replication — the paper
    evaluation re-rolls placement every trial)."""

    path: Optional[str] = None
    preset: Optional[str] = None
    config: Optional[TraceConfig] = None
    rows: Optional[Tuple[Tuple[str, float, float, float], ...]] = None
    name: str = "rows"                  # trace name for the rows kind
    seed: Optional[int] = None

    def __post_init__(self) -> None:
        given = sum(x is not None for x in (self.path, self.preset,
                                            self.config, self.rows))
        if given != 1:
            raise ValueError(
                "exactly one of path / preset / config / rows must be given")
        if self.preset is not None and self.preset != "paper" \
                and self.preset not in PRESETS:
            raise ValueError(f"unknown preset {self.preset!r}; available: "
                             f"paper, {', '.join(sorted(PRESETS))}")

    def resolve(self, sim_seed: int) -> Trace:
        tseed = self.seed if self.seed is not None else sim_seed
        if self.path is not None:
            return Trace.load(self.path)
        if self.preset == "paper":
            return paper_trace(tseed)
        if self.preset is not None:
            return generate_trace(PRESETS[self.preset], tseed)
        if self.rows is not None:
            return trace_from_rows(self.name, self.rows, seed=tseed)
        return generate_trace(self.config, tseed)

    def descriptor(self) -> Dict[str, object]:
        """Content identity for cache hashing (path traces hash the bytes,
        so an edited trace file invalidates its cells)."""
        if self.path is not None:
            digest = hashlib.sha256(Path(self.path).read_bytes()).hexdigest()
            return {"kind": "path", "sha256": digest}
        seed = self.seed if self.seed is not None else "=sim_seed"
        if self.preset is not None:
            return {"kind": "preset", "preset": self.preset, "seed": seed}
        if self.rows is not None:
            return {"kind": "rows", "name": self.name,
                    "rows": [list(r) for r in self.rows], "seed": seed}
        return {"kind": "config", "config": self.config.to_dict(),
                "seed": seed}


@dataclass(frozen=True)
class Cell:
    """One grid point; fully picklable so pool workers can simulate it.

    ``scheduler`` is a ``PolicySpec``.  Its cache descriptor collapses to
    the bare policy name when the spec carries no parameter overrides —
    byte-identical to the pre-policy string descriptors, so existing cache
    cells keep hitting."""

    trace: TraceRef
    cluster: ClusterSpec
    scheduler: PolicySpec
    seed: int
    straggler_prob: float
    straggler_factor: float
    speculative: bool
    speculation_threshold: float

    def descriptor(self) -> Dict[str, object]:
        return {
            "version": CACHE_VERSION,
            "trace": self.trace.descriptor(),
            "cluster": self.cluster.to_dict(),
            "scheduler": self.scheduler.cache_descriptor(),
            "sim": {
                "straggler_prob": self.straggler_prob,
                "straggler_factor": self.straggler_factor,
                "speculative": self.speculative,
                "speculation_threshold": self.speculation_threshold,
            },
        }

    def cache_hash(self) -> str:
        return hashlib.sha256(_dumps(self.descriptor()).encode()).hexdigest()[:16]


@dataclass(frozen=True)
class ExperimentSpec:
    """The declarative sweep: every combination of the four axes is a cell."""

    name: str
    traces: Tuple[TraceRef, ...]
    clusters: Tuple[ClusterSpec, ...]
    # policy values: PolicySpec instances, registered names, or policy dicts
    # (normalized to PolicySpec on construction; unknown names raise)
    schedulers: Tuple[Union[str, PolicySpec], ...] = ("proposed", "fair")
    seeds: Tuple[int, ...] = (0,)
    straggler_prob: float = 0.03
    straggler_factor: float = 3.0
    speculative: bool = True
    speculation_threshold: float = 2.0

    def __post_init__(self) -> None:
        try:
            specs = tuple(PolicySpec.parse(s) for s in self.schedulers)
        except PolicyError as e:
            raise ValueError(f"unknown scheduler: {e}") from e
        object.__setattr__(self, "schedulers", specs)
        labels = [s.label for s in specs]
        if len(set(labels)) != len(labels):
            raise ValueError(f"duplicate scheduler policies: {labels}")
        if not (self.traces and self.clusters and self.schedulers and self.seeds):
            raise ValueError("every grid axis needs at least one value")

    def cells(self) -> Iterator[Cell]:
        for trace in self.traces:
            for cluster in self.clusters:
                for sched in self.schedulers:
                    for seed in self.seeds:
                        yield Cell(
                            trace=trace, cluster=cluster, scheduler=sched,
                            seed=seed,
                            straggler_prob=self.straggler_prob,
                            straggler_factor=self.straggler_factor,
                            speculative=self.speculative,
                            speculation_threshold=self.speculation_threshold)

    def n_cells(self) -> int:
        return (len(self.traces) * len(self.clusters) * len(self.schedulers)
                * len(self.seeds))


@dataclass
class SweepReport:
    spec_name: str
    records: List[RunRecord]
    simulated: int
    cached: int

    def by_scheduler(self) -> Dict[str, List[RunRecord]]:
        out: Dict[str, List[RunRecord]] = {}
        for r in self.records:
            out.setdefault(r.scheduler, []).append(r)
        return out


def simulate_cell(cell: Cell) -> Dict[str, object]:
    """Run one grid cell; module-level so pool workers can pickle it."""
    trace = cell.trace.resolve(cell.seed)
    spec = cell.cluster
    jobs = trace.job_specs(spec)
    sched = cell.scheduler.build(spec)
    sim = ClusterSim(spec, sched, seed=cell.seed,
                     straggler_prob=cell.straggler_prob,
                     straggler_factor=cell.straggler_factor,
                     speculative=cell.speculative,
                     speculation_threshold=cell.speculation_threshold)
    t0 = time.perf_counter()
    result = sim.run(jobs)
    wall = time.perf_counter() - t0
    record = run_record_from_result(
        result, trace=trace, cluster_dict=spec.to_dict(),
        scheduler=cell.scheduler.label, seed=cell.seed, wall_time_s=wall,
        policy=cell.scheduler.to_dict())
    return record.to_dict()


def _cell_paths(cache_dir: Path, cell: Cell) -> Tuple[Path, Path]:
    cell_dir = cache_dir / cell.cache_hash()
    return cell_dir, cell_dir / f"seed{cell.seed}.json"


def run_experiment(spec: ExperimentSpec,
                   cache_dir: Union[str, Path],
                   *, workers: int = 0,
                   progress=None) -> SweepReport:
    """Run (or re-serve from cache) every cell of ``spec``.

    ``workers=0``/``1`` simulates inline; ``workers>1`` fans the missing
    cells out over a ``multiprocessing`` pool.  Cache files are written by
    the parent only, after each result arrives."""
    cache_dir = Path(cache_dir)
    cache_dir.mkdir(parents=True, exist_ok=True)
    records: List[RunRecord] = []
    todo: List[Cell] = []
    for cell in spec.cells():
        _, result_path = _cell_paths(cache_dir, cell)
        if result_path.exists():
            records.append(RunRecord.from_dict(
                json.loads(result_path.read_text())))
        else:
            todo.append(cell)
    if progress:
        progress(f"[{spec.name}] {spec.n_cells()} cells: "
                 f"{len(records)} cached, {len(todo)} to simulate")

    if todo:
        if workers > 1 and len(todo) > 1:
            # spawn, not fork: the parent may hold jax/threading state (e.g.
            # under pytest), and the worker import chain is jax-free and cheap
            ctx = multiprocessing.get_context("spawn")
            with ctx.Pool(processes=min(workers, len(todo))) as pool:
                results = pool.map(simulate_cell, todo)
        else:
            results = [simulate_cell(cell) for cell in todo]
        for cell, rec_dict in zip(todo, results):
            cell_dir, result_path = _cell_paths(cache_dir, cell)
            cell_dir.mkdir(parents=True, exist_ok=True)
            meta_path = cell_dir / "meta.json"
            if not meta_path.exists():
                meta_path.write_text(
                    json.dumps(cell.descriptor(), indent=2, sort_keys=True)
                    + "\n")
            result_path.write_text(_dumps(rec_dict) + "\n")
            records.append(RunRecord.from_dict(rec_dict))
            if progress:
                progress(f"  simulated {cell.scheduler.label} seed={cell.seed} "
                         f"({rec_dict['events_processed']} events, "
                         f"{rec_dict['wall_time_s']:.2f}s)")

    records.sort(key=lambda r: (r.trace_name, r.trace_seed,
                                _dumps(r.cluster),
                                r.scheduler, r.seed))
    return SweepReport(spec_name=spec.name, records=records,
                       simulated=len(todo),
                       cached=spec.n_cells() - len(todo))
