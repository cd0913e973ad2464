"""Surrogate sweeps behind the experiments cache, on the card.

The port of the experiments-layer face of the fluid surrogate (the JAX
package's ``experiments/surrogate.py``): the same declarative
``ExperimentSpec`` grids, every cell integrated by the batched fluid engine
(``repro_torch.simcluster.surrogate``), all cache-missing cells of a sweep in
one ``run_batch`` call — on the card one kernel launch a (jobs, steps)
bucket.

**Cache namespace.**  Surrogate results use the event runner's content-hash
cache layout (``<cell_hash>/meta.json`` + ``seed<k>.json``); the descriptor
carries an extra ``"engine": SURROGATE_ENGINE_ID`` key, which the event
engine's descriptors never have and whose value differs from the JAX
package's, so the port's cells hash apart from both.

**Calibration gate.**  ``CALIBRATED`` is the original's allowlist: the
(preset, fleet shape) pairs and policies whose policy-vs-fair throughput
gain the surrogate reproduces inside the event oracle's paired-bootstrap CI
on identical (trace, seed) cells.  ``calibrate`` recomputes the comparison
on demand: the port's own event engine (``repro_torch.simcluster.sim``,
pure Python on the host) is the oracle, and the surrogate side runs on
``device`` (the card unless the caller names another).  The ``surrogate``
CLI verb prints it next to every sweep.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.experiments.metrics import JobRecord, RunRecord
from repro_torch.experiments.regimes import regime_spec
from repro_torch.experiments.runner import (Cell, ExperimentSpec, SweepReport,
                                            run_experiment)
from repro_torch.experiments.stats import PairedComparison, compare_throughput
from repro_torch.simcluster.surrogate import (SURROGATE_ENGINE_ID,
                                              SurrogateResult, _device,
                                              build_cell, lower_policy,
                                              run_batch)
from repro_torch.simcluster.traces import _dumps

#: the differential wall's verdict, pinned: (preset, fleet shape) → the
#: policy labels whose policy-vs-fair gain the surrogate reproduces inside
#: the event oracle's 95% paired-bootstrap CI (4 paired seeds).  The walls
#: in tests/test_surrogate.py, tests/test_torch_surrogate.py and
#: tests/test_torch_calibration.py re-derive this table from live runs and
#: fail loudly on any drift — growing it requires re-calibration, not an
#: edit here.
CALIBRATED: Dict[Tuple[str, str], Tuple[str, ...]] = {
    ("heavy_tail", "20x2"): ("proposed", "delay", "edf_nopark"),
    ("diurnal", "20x2"): ("proposed", "delay", "fifo", "edf_nopark"),
    ("bursty", "20x2"): ("fifo", "edf_nopark"),
    ("shuffle_heavy", "20x2"): ("delay", "fifo", "edf_nopark"),
    ("saturated", "20x2"): ("fifo", "edf_nopark"),
}
#: seeds the wall calibrates over (paired across engines per cell)
CALIBRATION_SEEDS: Tuple[int, ...] = (0, 1, 2, 3)


def surrogate_descriptor(cell: Cell) -> Dict[str, object]:
    """The event cell descriptor plus the engine-id key — the *only*
    difference, so one grid maps to two parallel hash families."""
    d = cell.descriptor()
    d["engine"] = SURROGATE_ENGINE_ID
    return d


def surrogate_hash(cell: Cell) -> str:
    return hashlib.sha256(
        _dumps(surrogate_descriptor(cell)).encode()).hexdigest()[:16]


def _cell_paths(cache_dir: Path, cell: Cell) -> Tuple[Path, Path]:
    cell_dir = cache_dir / surrogate_hash(cell)
    return cell_dir, cell_dir / f"seed{cell.seed}.json"


def _record(cell: Cell, res: SurrogateResult, trace_name: str,
            trace_seed: int, wall_time_s: float) -> RunRecord:
    jobs = [JobRecord(
        job_id=j.job_id, workload=j.workload, input_gb=j.input_gb,
        submit_time=j.submit_time, deadline=j.deadline,
        finish_time=j.finish_time, completion_time=j.completion_time,
        deadline_met=j.deadline_met,
        local_map_launches=j.local_map_launches,
        remote_map_launches=j.remote_map_launches,
        # the fluid model folds park wins into the local flow; it does
        # not attribute them separately per job
        reconfig_map_launches=0.0) for j in res.jobs]
    return RunRecord(
        trace_name=trace_name, trace_seed=trace_seed,
        cluster=cell.cluster.to_dict(), scheduler=cell.scheduler.label,
        seed=cell.seed, makespan=res.makespan,
        throughput_jph=res.throughput_jobs_per_hour(),
        jobs_total=res.jobs_total, jobs_finished=res.jobs_finished,
        deadlines_met=res.deadlines_met, locality_rate=res.locality_rate,
        speculative_launches=0, events_processed=0,
        wall_time_s=wall_time_s,
        reconfig_stats={"latched_steps": res.latched_steps},
        jobs=jobs, policy=cell.scheduler.to_dict())



def run_surrogate(spec: ExperimentSpec, cache_dir: Union[str, Path],
                  *, progress=None, device="cuda") -> SweepReport:
    """Run (or re-serve from cache) every cell of ``spec`` through the
    batched fluid engine.

    Mirrors ``run_experiment``'s contract — same cache layout, same
    ``SweepReport`` — but all cache-missing cells integrate in one
    ``run_batch`` call on ``device`` (the card unless the caller names
    another; grouped by padded shape, one kernel launch a bucket).  Every
    policy in the grid must lower;
    :class:`SurrogateUnsupported` propagates *before* any cell runs, so a
    grid with an unmodelable policy never half-completes.
    """
    for sched in spec.schedulers:
        lower_policy(sched)          # raises SurrogateUnsupported
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
        progress(f"[{spec.name}] {spec.n_cells()} surrogate cells: "
                 f"{len(records)} cached, {len(todo)} to integrate")
    if todo:
        t0 = time.perf_counter()
        resolved: Dict[Tuple[int, int], object] = {}
        for cell in todo:
            key = (id(cell.trace), cell.seed)
            if key not in resolved:
                resolved[key] = cell.trace.resolve(cell.seed)
        traces = [resolved[(id(cell.trace), cell.seed)] for cell in todo]
        # the expensive per-job compilation (block placements, jitter) is
        # policy-independent: build once per (trace, seed, cluster) and
        # swap only the lowered policy across the grid's policy columns
        base: Dict[Tuple[int, int, int], object] = {}
        inputs = []
        for cell, trace in zip(todo, traces):
            key = (id(trace), id(cell.cluster), cell.seed)
            if key not in base:
                base[key] = build_cell(trace, cell.cluster,
                                       cell.scheduler, cell.seed)
                inputs.append(base[key])
            else:
                inputs.append(dataclasses.replace(
                    base[key], policy=lower_policy(cell.scheduler)))
        results = run_batch(inputs, device=device)
        per_cell = (time.perf_counter() - t0) / len(todo)
        for cell, trace, res in zip(todo, traces, results):
            rec = _record(cell, res, trace.name, trace.seed, per_cell)
            cell_dir, result_path = _cell_paths(cache_dir, cell)
            cell_dir.mkdir(parents=True, exist_ok=True)
            meta_path = cell_dir / "meta.json"
            if not meta_path.exists():
                meta_path.write_text(json.dumps(
                    surrogate_descriptor(cell), indent=2, sort_keys=True)
                    + "\n")
            result_path.write_text(_dumps(rec.to_dict()) + "\n")
            records.append(rec)
        if progress:
            progress(f"  integrated {len(todo)} cells in "
                     f"{per_cell * len(todo):.2f}s "
                     f"({1.0 / per_cell:.0f} cells/s)")
    records.sort(key=lambda r: (r.trace_name, r.trace_seed,
                                _dumps(r.cluster), r.scheduler, r.seed))
    return SweepReport(spec_name=spec.name, records=records,
                       simulated=len(todo),
                       cached=spec.n_cells() - len(todo))


# ---------------------------------------------------------------------------
# differential calibration
# ---------------------------------------------------------------------------

@dataclass
class PolicyCalibration:
    """One (policy vs fair) differential: oracle CI vs surrogate mean."""

    policy: str
    oracle: PairedComparison
    surrogate_gain_pct: float
    allowlisted: bool

    @property
    def inside(self) -> bool:
        return (self.oracle.ci_lo_pct <= self.surrogate_gain_pct
                <= self.oracle.ci_hi_pct)


@dataclass
class CalibrationReport:
    preset: str
    shape: str
    seeds: Tuple[int, ...]
    policies: List[PolicyCalibration] = field(default_factory=list)

    @property
    def wall_green(self) -> bool:
        """Every allowlisted policy's surrogate gain inside the oracle CI."""
        return all(p.inside for p in self.policies if p.allowlisted)


def calibrate(preset: str, shape: str, cache_dir: Union[str, Path],
              *, seeds: Sequence[int] = CALIBRATION_SEEDS,
              policies: Optional[Sequence[str]] = None,
              workers: int = 0, progress=None,
              device="cuda") -> CalibrationReport:
    """Run surrogate and event engine on identical (trace, seed) cells and
    compare each policy's throughput-vs-fair gain against the oracle's
    paired-bootstrap CI.

    ``policies`` defaults to every surrogate-lowerable policy under test
    (the allowlisted set plus any extra being evaluated for promotion);
    ``fair`` is always added as the shared baseline.  Both engines read
    and write ``cache_dir`` — their cells hash into disjoint namespaces.
    The oracle runs on the host (``workers`` > 1: a ``spawn`` pool); the
    surrogate on ``device``, which is checked before the oracle runs.
    """
    _device(device)                  # no card and no fallback: raise now
    allow = CALIBRATED.get((preset, shape), ())
    pols = tuple(policies) if policies is not None else allow
    pols = tuple(p for p in pols if p != "fair")
    base = regime_spec(preset, shape, seeds=tuple(seeds))
    spec = ExperimentSpec(name=f"surrogate-cal-{preset}-{shape}",
                          traces=base.traces, clusters=base.clusters,
                          schedulers=pols + ("fair",),
                          seeds=tuple(seeds))
    oracle = run_experiment(spec, cache_dir, workers=workers,
                            progress=progress)
    sur = run_surrogate(spec, cache_dir, progress=progress, device=device)
    o_by = oracle.by_scheduler()
    s_by = sur.by_scheduler()
    report = CalibrationReport(preset=preset, shape=shape,
                               seeds=tuple(seeds))
    for pol in pols:
        oc = compare_throughput(o_by["fair"], o_by[pol])
        sc = compare_throughput(s_by["fair"], s_by[pol])
        report.policies.append(PolicyCalibration(
            policy=pol, oracle=oc, surrogate_gain_pct=sc.mean_gain_pct,
            allowlisted=pol in allow))
    return report
