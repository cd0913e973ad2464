"""Declarative sweep grids and their on-disk cache layout, as the port's own
copy of the JAX package's ``experiments/runner.py``.

An ``ExperimentSpec`` is a grid: traces x cluster shapes x schedulers x sim
seeds.  Cache layout (``<cache_dir>/``)::

    <cell_hash>/meta.json      # the cell descriptor that produced the hash
    <cell_hash>/seed<k>.json   # one RunRecord per sim seed

``cell_hash`` is sha256 over the canonical-JSON cell descriptor: trace
identity (file content hash for path traces; config + seed for generated
ones), ``ClusterSpec.to_dict()``, scheduler name, sim parameters and a
cache-format version.  The sim seed stays out of the hash so a sweep that
adds seeds reuses the same cell directory.  The descriptors are the
original's byte for byte (a test holds them equal); ``simulate_cell`` and
``run_experiment``, which run the event engine, wait for the port's event
engine.  The fluid surrogate's sweeps are
``repro_torch.experiments.surrogate.run_surrogate``.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple, Union

from repro_torch.core.policies import PolicyError, PolicySpec
from repro_torch.core.types import ClusterSpec
from repro_torch.experiments.metrics import RunRecord
from repro_torch.simcluster.traces import (PRESETS, Trace, TraceConfig, _dumps,
                                           generate_trace, paper_trace,
                                           trace_from_rows)

CACHE_VERSION = 1


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


def _cell_paths(cache_dir: Path, cell: Cell) -> Tuple[Path, Path]:
    cell_dir = cache_dir / cell.cache_hash()
    return cell_dir, cell_dir / f"seed{cell.seed}.json"

