"""Regime atlas: where does the reconfiguration mechanism actually win?

The paper's headline (~12% throughput over Fair) is one point: one 20-machine
cluster, one job mix.  This module sweeps the atlas policy columns —
``proposed``, ``adaptive``, ``adaptive_ra`` (reduce-aware overload latch)
and the ``delay``-scheduling baseline against ``fair`` and ``fifo``, all
registry presets (see ``repro_torch.core.policies``) — over the synthetic
workload regimes (heavy-tailed sizes, diurnal arrivals, flash-crowd bursts,
shuffle-heavy mixes, the saturated closed mix) crossed with cluster shapes
from the paper's 20x2 up to fleet scale, with ≥8 paired seeds per cell,
and emits a machine-readable *regime report*: per-regime throughput-gain
CIs, win rates, and locality/deadline deltas.  Extra axes re-run every
preset on the first shape: network fabrics (``FABRICS``) and HDFS
replication (``replications``).

Job counts scale with the fleet (num_jobs × machines/20) so a 100-machine
cell faces proportional load, and every (trace seed, placement, jitter) draw
is shared by all three schedulers — the comparisons isolate pure policy.

Everything runs through the cached sweep runner: re-running a finished atlas
performs zero new simulations, and `--quick` is a sub-grid of the full atlas
so a later full run reuses its cells.

CLI::

    PYTHONPATH=src python -m repro_torch.experiments regimes --quick
    PYTHONPATH=src python -m repro_torch.experiments regimes --workers 4 \
        --markdown EXPERIMENTS.md

This is the port's own copy of the JAX package's ``experiments/regimes.py``
(pure Python on the host; the surrogate's calibration builds its cells
here too): a test holds every descriptor, report, table and line of text
to the original's, and a cache either package wrote serves the other.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Sequence, Tuple, Union

from repro_torch.core.types import (FaultConfig, MachineClass, ServeConfig,
                                    ServiceSpec)
from repro_torch.experiments.runner import (ExperimentSpec, TraceRef,
                                            run_experiment)
from repro_torch.experiments.stats import (PairedComparison, compare_serve_p99,
                                           compare_throughput)
from repro_torch.simcluster.largescale import FLEET_SHAPES, fleet_shape
from repro_torch.simcluster.traces import PRESETS, Trace

REGIME_PRESETS: Tuple[str, ...] = ("heavy_tail", "diurnal", "bursty",
                                   "shuffle_heavy", "saturated")
FULL_SHAPES: Tuple[str, ...] = ("20x2", "50x2", "100x2")
QUICK_SHAPES: Tuple[str, ...] = ("20x2", "50x2")
FULL_SEEDS: Tuple[int, ...] = tuple(range(8))
QUICK_SEEDS: Tuple[int, ...] = (0, 1)
# atlas policy columns (all default-spec registry presets, so the cell
# descriptors stay plain strings and pre-policy cache cells keep hitting):
# adaptive_ra = the reduce-aware overload latch, delay = delay scheduling
SCHEDULERS: Tuple[str, ...] = ("proposed", "adaptive", "adaptive_ra",
                               "delay", "fair", "fifo")
# remote-penalty calibration of the network fabric: at 1.0 a non-local map
# pays the full 2012-era shared-1GbE remote-read penalty; faster fabrics
# scale it down (~linear in link speed) — the axis answers "at what fabric
# speed does the reconfiguration mechanism stop paying?"
FABRICS: Dict[str, float] = {"1GbE": 1.0, "10GbE": 0.25, "40GbE": 0.0625}
BASE_FABRIC = "1GbE"
FULL_FABRICS: Tuple[str, ...] = ("10GbE", "40GbE")   # extra cells, 20x2 only
QUICK_FABRICS: Tuple[str, ...] = ()
# HDFS replication axis: the calibrated paper setting is replication 1
# (per-VM virtual disks); replication 3 is the HDFS default — three times
# the locality opportunities, so parking should matter *less*
BASE_REPLICATION = 1
FULL_REPLICATIONS: Tuple[int, ...] = (3,)            # extra cells, 20x2 only
QUICK_REPLICATIONS: Tuple[int, ...] = ()
# fault-injection axis: crash-rate x heterogeneity profiles (see
# repro_torch.core.types.FaultConfig).  churn_lo/churn_hi vary the per-machine
# crash MTBF; churn_hetero adds a 3:1 new/old machine mix where the "old"
# quartile is 40% slower, pays a 25% stiffer remote penalty, and crashes
# twice as often.  Fault cells sweep every preset over FAULT_SHAPES —
# the axis answers "which policy column degrades gracefully under churn?"
HETERO_MIX: Tuple[MachineClass, ...] = (
    MachineClass(name="new", weight=3),
    MachineClass(name="old", weight=1, speed=1.4, fabric=1.25,
                 mtbf_scale=0.5),
)
FAULT_PROFILES: Dict[str, FaultConfig] = {
    "none": FaultConfig(),
    "churn_lo": FaultConfig(enabled=True, crash_mtbf=3600.0,
                            crash_mttr=120.0, rereplicate_after=60.0),
    "churn_hi": FaultConfig(enabled=True, crash_mtbf=1200.0,
                            crash_mttr=120.0, rereplicate_after=60.0),
    "churn_hetero": FaultConfig(enabled=True, crash_mtbf=1200.0,
                                crash_mttr=120.0, rereplicate_after=60.0,
                                machine_classes=HETERO_MIX),
}
BASE_FAULTS = "none"
FULL_FAULTS: Tuple[str, ...] = ("churn_lo", "churn_hi", "churn_hetero")
QUICK_FAULTS: Tuple[str, ...] = ()
FAULT_SHAPES: Tuple[str, ...] = ("20x2", "50x2")
# serving axis: co-located latency-SLO services (ServeConfig) crossed with
# the batch atlas — service:batch core mix x SLO tightness x spike
# amplitude, each cell pairing the `harvest` policy against its no-harvest
# `adaptive` twin on identical inputs.  Replica counts scale with the
# fleet (4 per 20 machines); 2-vCPU replicas pin a whole VM, so the
# harvest question is "how much pinned capacity can the batch side
# recover without breaching the p99 SLO?"
_SERVE_BASES: Dict[str, ServiceSpec] = {
    # 1-core replicas: nothing harvestable (a replica keeps its last
    # core) — the control cell where harvest must equal adaptive
    "svc_light_loose": ServiceSpec(name="web", vcpus=1, base_rps=12.0,
                                   diurnal_amplitude=0.3,
                                   slo_p99_ms=500.0),
    # 2-core replicas at low utilization with a loose SLO: the
    # harvest-win cell (idle pinned cores, headroom to lend)
    "svc_heavy_loose": ServiceSpec(name="api", vcpus=2, base_rps=15.0,
                                   diurnal_amplitude=0.3,
                                   slo_p99_ms=600.0),
    # 2-core replicas near the knee with a tight SLO: borrowing pushes
    # p99 toward the bar, so preemptive returns must do the work
    "svc_heavy_tight": ServiceSpec(name="api", vcpus=2, base_rps=35.0,
                                   diurnal_amplitude=0.2,
                                   slo_p99_ms=300.0),
    # flash-crowd riders on a quiet baseline: load spikes arrive faster
    # than the diurnal EWMA drifts — exercises util_spike/p99_pressure
    "svc_spiky": ServiceSpec(name="feed", vcpus=2, base_rps=10.0,
                             diurnal_amplitude=0.2, burst_prob=0.05,
                             burst_size_mean=12.0, slo_p99_ms=500.0),
}
SERVE_PROFILES: Tuple[str, ...] = tuple(_SERVE_BASES)
SERVE_SHAPES: Tuple[str, ...] = ("20x2", "50x2")
FULL_SERVE: Tuple[str, ...] = SERVE_PROFILES
QUICK_SERVE: Tuple[str, ...] = ()
# the serving cells pair the harvest column against its no-harvest twin
SERVE_SCHEDULERS: Tuple[str, ...] = ("adaptive", "harvest")
# batch workload under the services: the saturated closed mix keeps a
# standing map backlog, so harvested cores always have work to absorb
SERVE_PRESET = "saturated"


def serve_profile(name: str, machines: int) -> ServeConfig:
    """The named serving profile scaled to a fleet: replica count grows
    with the machine count (4 per 20 machines, minimum 2)."""
    if name not in _SERVE_BASES:
        raise ValueError(f"unknown serve profile {name!r}; available: "
                         f"{', '.join(_SERVE_BASES)}")
    base = _SERVE_BASES[name]
    replicas = max(2, round(4 * machines / 20))
    return ServeConfig(enabled=True, services=(
        dataclasses.replace(base, replicas=replicas),))
# real-trace columns: imported SWIM/Facebook-format cluster logs committed
# as repro-trace/v1 fixtures (see data/swim_fb_sample.log for the raw log
# and the import provenance).  Path traces hash their file bytes into the
# cell descriptor, so editing a fixture invalidates exactly its cells.
_DATA_DIR = Path(__file__).resolve().parent / "data"
SWIM_TRACES: Dict[str, Path] = {
    "swim_fb": _DATA_DIR / "swim_fb_sample.jsonl",
}
FULL_SWIM: Tuple[str, ...] = ("swim_fb",)
QUICK_SWIM: Tuple[str, ...] = ()
REPORT_VERSION = 4


def scaled_jobs(preset: str, machines: int) -> int:
    """Scale a preset's job count with the fleet (baseline: 20 machines).
    Imported SWIM traces are fixed arrival logs — their job count does not
    scale."""
    if preset in SWIM_TRACES:
        return len(Trace.load(SWIM_TRACES[preset]).jobs)
    base = PRESETS[preset].num_jobs
    return max(base, round(base * machines / 20))


def regime_spec(preset: str, shape: str,
                seeds: Sequence[int] = FULL_SEEDS,
                fabric: str = BASE_FABRIC,
                replication: int = BASE_REPLICATION,
                faults: str = BASE_FAULTS) -> ExperimentSpec:
    """One atlas cell as a sweep spec: scaled preset trace x shape x every
    atlas policy column, trace seed coupled to the sim seed (every
    replication re-rolls arrivals and placements for *all* schedulers
    alike).  ``fabric`` calibrates the remote-read penalty via
    ``ClusterSpec.remote_penalty_scale``; ``replication`` sets the HDFS
    replica count; ``faults`` names a ``FAULT_PROFILES`` entry (crash
    churn / heterogeneity).  ``preset`` may also name a committed SWIM
    trace fixture (``SWIM_TRACES``) — then the trace is the imported log,
    byte-hashed into the cell descriptor."""
    machines, _ = FLEET_SHAPES[shape]
    if preset in SWIM_TRACES:
        trace = TraceRef(path=str(SWIM_TRACES[preset]))
    else:
        config = dataclasses.replace(PRESETS[preset],
                                     num_jobs=scaled_jobs(preset, machines))
        trace = TraceRef(config=config)
    cluster = fleet_shape(shape, replication=replication)
    if fabric != BASE_FABRIC:
        cluster = dataclasses.replace(cluster,
                                      remote_penalty_scale=FABRICS[fabric])
    if faults != BASE_FAULTS:
        cluster = dataclasses.replace(cluster,
                                      faults=FAULT_PROFILES[faults])
    suffix = "" if faults == BASE_FAULTS else f"-{faults}"
    return ExperimentSpec(
        name=f"regime-{preset}-{shape}-{fabric}-r{replication}{suffix}",
        traces=(trace,),
        clusters=(cluster,),
        schedulers=SCHEDULERS,
        seeds=tuple(seeds),
    )


def _verdict_of(cmp: PairedComparison) -> str:
    """'win' / 'loss' when the 95% CI excludes zero, else 'tie'."""
    if cmp.ci_lo_pct > 0:
        return "win"
    if cmp.ci_hi_pct < 0:
        return "loss"
    return "tie"


@dataclass
class RegimeCell:
    """Verdict for one (workload regime, cluster shape, fabric, replication)
    point of the atlas."""

    preset: str
    shape: str
    machines: int
    vms: int
    num_jobs: int
    seeds: Tuple[int, ...]
    vs_fair: PairedComparison            # proposed-vs-fair throughput
    vs_fifo: PairedComparison            # proposed-vs-fifo throughput
    adaptive_vs_fair: PairedComparison   # adaptive-vs-fair throughput
    adaptive_vs_proposed: PairedComparison
    ra_vs_fair: PairedComparison         # adaptive_ra (reduce-aware latch)
    ra_vs_adaptive: PairedComparison     # ... and its gain over plain latch
    delay_vs_fair: PairedComparison      # delay-scheduling baseline
    locality: Dict[str, float]           # mean locality rate per scheduler
    deadline_frac: Dict[str, float]      # mean deadlines-met / jobs per run
    mean_makespan: Dict[str, float]
    fabric: str = BASE_FABRIC
    replication: int = BASE_REPLICATION
    faults: str = BASE_FAULTS

    def verdict(self) -> str:
        """Proposed-vs-fair verdict (the legacy fixed-policy column)."""
        return _verdict_of(self.vs_fair)

    def adaptive_verdict(self) -> str:
        """Adaptive-vs-fair verdict (the pressure-adaptive column)."""
        return _verdict_of(self.adaptive_vs_fair)

    def ra_verdict(self) -> str:
        """adaptive_ra-vs-fair verdict (reduce-aware overload latch)."""
        return _verdict_of(self.ra_vs_fair)

    def delay_verdict(self) -> str:
        """delay-vs-fair verdict (delay-scheduling baseline)."""
        return _verdict_of(self.delay_vs_fair)

    def locality_delta_pp(self, scheduler: str = "proposed") -> float:
        """Locality-rate gain of ``scheduler`` over fair, percentage pts."""
        return (self.locality[scheduler] - self.locality["fair"]) * 100.0

    def deadline_delta_pp(self, scheduler: str = "proposed") -> float:
        """Deadlines-met-fraction gain of ``scheduler`` over fair, pp."""
        return (self.deadline_frac[scheduler]
                - self.deadline_frac["fair"]) * 100.0

    def to_dict(self) -> Dict[str, object]:
        return {
            "preset": self.preset,
            "shape": self.shape,
            "fabric": self.fabric,
            "replication": self.replication,
            "faults": self.faults,
            "machines": self.machines,
            "vms": self.vms,
            "num_jobs": self.num_jobs,
            "seeds": list(self.seeds),
            "verdict": self.verdict(),
            "adaptive_verdict": self.adaptive_verdict(),
            "ra_verdict": self.ra_verdict(),
            "delay_verdict": self.delay_verdict(),
            "throughput_vs_fair": self.vs_fair.to_dict(),
            "throughput_vs_fifo": self.vs_fifo.to_dict(),
            "adaptive_vs_fair": self.adaptive_vs_fair.to_dict(),
            "adaptive_vs_proposed": self.adaptive_vs_proposed.to_dict(),
            "adaptive_ra_vs_fair": self.ra_vs_fair.to_dict(),
            "adaptive_ra_vs_adaptive": self.ra_vs_adaptive.to_dict(),
            "delay_vs_fair": self.delay_vs_fair.to_dict(),
            "locality": self.locality,
            "locality_delta_pp": self.locality_delta_pp(),
            "adaptive_locality_delta_pp": self.locality_delta_pp("adaptive"),
            "ra_locality_delta_pp": self.locality_delta_pp("adaptive_ra"),
            "delay_locality_delta_pp": self.locality_delta_pp("delay"),
            "deadline_frac": self.deadline_frac,
            "deadline_delta_pp": self.deadline_delta_pp(),
            "adaptive_deadline_delta_pp": self.deadline_delta_pp("adaptive"),
            "ra_deadline_delta_pp": self.deadline_delta_pp("adaptive_ra"),
            "mean_makespan": self.mean_makespan,
        }


@dataclass
class RegimeReport:
    presets: Tuple[str, ...]
    shapes: Tuple[str, ...]
    seeds: Tuple[int, ...]
    cells: List[RegimeCell]
    simulated: int
    cached: int
    fabrics: Tuple[str, ...] = (BASE_FABRIC,)
    replications: Tuple[int, ...] = (BASE_REPLICATION,)
    fault_profiles: Tuple[str, ...] = (BASE_FAULTS,)
    swim: Tuple[str, ...] = ()
    version: int = REPORT_VERSION

    def cell(self, preset: str, shape: str,
             fabric: str = BASE_FABRIC,
             replication: int = BASE_REPLICATION,
             faults: str = BASE_FAULTS) -> RegimeCell:
        for c in self.cells:
            if (c.preset, c.shape, c.fabric, c.replication, c.faults) \
                    == (preset, shape, fabric, replication, faults):
                return c
        raise KeyError((preset, shape, fabric, replication, faults))

    def to_dict(self) -> Dict[str, object]:
        return {
            "version": self.version,
            "presets": list(self.presets),
            "shapes": list(self.shapes),
            "seeds": list(self.seeds),
            "fabrics": list(self.fabrics),
            "replications": list(self.replications),
            "fault_profiles": list(self.fault_profiles),
            "swim": list(self.swim),
            "schedulers": list(SCHEDULERS),
            "simulated": self.simulated,
            "cached": self.cached,
            "cells": [c.to_dict() for c in self.cells],
        }

    def save_json(self, path: Union[str, Path]) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_dict(), indent=2, sort_keys=True)
                        + "\n")
        return path

    # -- human-readable views -----------------------------------------------
    def format(self) -> str:
        lines = [f"== regime atlas: proposed/adaptive/adaptive_ra/delay vs "
                 f"fair (+fifo) ({len(self.seeds)} paired seeds/cell; "
                 f"{self.simulated} simulated, {self.cached} cached) =="]
        for c in self.cells:
            g, a, r = c.vs_fair, c.adaptive_vs_fair, c.ra_vs_fair
            lines.append(
                f"  {c.preset:13s} {c.shape:6s} {c.fabric:5s} "
                f"r{c.replication} {c.faults:12s} ({c.num_jobs:3d} jobs)  "
                f"prop {g.mean_gain_pct:+6.1f}% "
                f"[{g.ci_lo_pct:+6.1f}%, {g.ci_hi_pct:+6.1f}%] "
                f"-> {c.verdict():4s}  "
                f"adapt {a.mean_gain_pct:+6.1f}% "
                f"[{a.ci_lo_pct:+6.1f}%, {a.ci_hi_pct:+6.1f}%] "
                f"-> {c.adaptive_verdict():4s}  "
                f"ra {r.mean_gain_pct:+6.1f}% -> {c.ra_verdict():4s}  "
                f"delay {c.delay_vs_fair.mean_gain_pct:+6.1f}% "
                f"-> {c.delay_verdict():4s}  "
                f"Δlocal {c.locality_delta_pp():+5.1f}pp  "
                f"Δddl {c.deadline_delta_pp():+5.1f}pp")
        return "\n".join(lines)

    def to_markdown(self) -> str:
        head = [
            "| regime | cluster | fabric | repl | faults | jobs "
            "| proposed vs fair (95% CI) | verdict "
            "| adaptive vs fair (95% CI) | verdict "
            "| adaptive_ra vs fair (95% CI) | verdict "
            "| delay vs fair | verdict | adaptive vs proposed "
            "| Δ locality (prop/adapt/ra/delay) "
            "| Δ deadlines (prop/adapt/ra) |",
            "| --- | --- | --- | ---: | --- | ---: | --- | --- | --- | --- "
            "| --- | --- | --- | --- | --- | --- | --- |",
        ]
        rows = []
        for c in self.cells:
            f, a = c.vs_fair, c.adaptive_vs_fair
            r, d, ap = c.ra_vs_fair, c.delay_vs_fair, c.adaptive_vs_proposed
            rows.append(
                f"| {c.preset} | {c.shape} | {c.fabric} | {c.replication} "
                f"| {c.faults} | {c.num_jobs} "
                f"| {f.mean_gain_pct:+.1f}% [{f.ci_lo_pct:+.1f}%, "
                f"{f.ci_hi_pct:+.1f}%] | {c.verdict()} "
                f"| {a.mean_gain_pct:+.1f}% [{a.ci_lo_pct:+.1f}%, "
                f"{a.ci_hi_pct:+.1f}%] | {c.adaptive_verdict()} "
                f"| {r.mean_gain_pct:+.1f}% [{r.ci_lo_pct:+.1f}%, "
                f"{r.ci_hi_pct:+.1f}%] | {c.ra_verdict()} "
                f"| {d.mean_gain_pct:+.1f}% | {c.delay_verdict()} "
                f"| {ap.mean_gain_pct:+.1f}% "
                f"| {c.locality_delta_pp():+.1f} / "
                f"{c.locality_delta_pp('adaptive'):+.1f} / "
                f"{c.locality_delta_pp('adaptive_ra'):+.1f} / "
                f"{c.locality_delta_pp('delay'):+.1f} pp "
                f"| {c.deadline_delta_pp():+.1f} / "
                f"{c.deadline_delta_pp('adaptive'):+.1f} / "
                f"{c.deadline_delta_pp('adaptive_ra'):+.1f} pp |")
        return "\n".join(head + rows)


def _mean(vals: Sequence[float]) -> float:
    return sum(vals) / len(vals) if vals else 0.0


def run_regimes(presets: Sequence[str] = REGIME_PRESETS,
                shapes: Sequence[str] = FULL_SHAPES,
                seeds: Sequence[int] = FULL_SEEDS,
                cache_dir: Union[str, Path] = ".exp-cache",
                *, fabrics: Sequence[str] = (),
                replications: Sequence[int] = (),
                faults: Sequence[str] = (),
                swim: Sequence[str] = (),
                workers: int = 0, n_boot: int = 2000,
                progress=None) -> RegimeReport:
    """Run (or re-serve from cache) the full atlas grid and distill the
    per-regime verdicts.  ``fabrics`` adds a remote-penalty sweep and
    ``replications`` an HDFS-replica sweep: each extra fabric/replication
    re-runs every preset on the *first* shape (the paper's 20x2 unless
    overridden) with the scaled remote-read penalty / replica count.
    ``faults`` names ``FAULT_PROFILES`` entries: each profile re-runs every
    preset over the ``FAULT_SHAPES`` present in ``shapes`` (falling back to
    the first shape) with the profile's crash churn / heterogeneity.
    ``swim`` names committed SWIM trace fixtures (``SWIM_TRACES``) run as
    extra regime columns on the first shape."""
    for f in fabrics:
        if f not in FABRICS:
            raise ValueError(f"unknown fabric {f!r}; available: "
                             f"{', '.join(FABRICS)}")
    for r in replications:
        if not isinstance(r, int) or r < 1:
            raise ValueError(f"replication must be a positive int, got {r!r}")
    for fp in faults:
        if fp not in FAULT_PROFILES:
            raise ValueError(f"unknown fault profile {fp!r}; available: "
                             f"{', '.join(FAULT_PROFILES)}")
    for sw in swim:
        if sw not in SWIM_TRACES:
            raise ValueError(f"unknown SWIM trace {sw!r}; available: "
                             f"{', '.join(SWIM_TRACES)}")
    cells: List[RegimeCell] = []
    simulated = cached = 0
    fault_shapes = tuple(s for s in FAULT_SHAPES if s in shapes) \
        or (shapes[0],)
    points = [(preset, shape, BASE_FABRIC, BASE_REPLICATION, BASE_FAULTS)
              for preset in presets for shape in shapes]
    points += [(sw, shapes[0], BASE_FABRIC, BASE_REPLICATION, BASE_FAULTS)
               for sw in swim]
    points += [(preset, shapes[0], fabric, BASE_REPLICATION, BASE_FAULTS)
               for fabric in fabrics for preset in presets
               if fabric != BASE_FABRIC]
    points += [(preset, shapes[0], BASE_FABRIC, repl, BASE_FAULTS)
               for repl in replications for preset in presets
               if repl != BASE_REPLICATION]
    points += [(preset, shape, BASE_FABRIC, BASE_REPLICATION, fp)
               for fp in faults for shape in fault_shapes
               for preset in presets if fp != BASE_FAULTS]
    for preset, shape, fabric, repl, fprofile in points:
        spec = regime_spec(preset, shape, seeds, fabric=fabric,
                           replication=repl, faults=fprofile)
        report = run_experiment(spec, cache_dir, workers=workers,
                                progress=progress)
        simulated += report.simulated
        cached += report.cached
        by = report.by_scheduler()
        machines, vms = FLEET_SHAPES[shape]
        cells.append(RegimeCell(
            preset=preset,
            shape=shape,
            fabric=fabric,
            replication=repl,
            faults=fprofile,
            machines=machines,
            vms=vms,
            num_jobs=scaled_jobs(preset, machines),
            seeds=tuple(seeds),
            vs_fair=compare_throughput(by["fair"], by["proposed"],
                                       n_boot=n_boot),
            vs_fifo=compare_throughput(by["fifo"], by["proposed"],
                                       n_boot=n_boot),
            adaptive_vs_fair=compare_throughput(by["fair"], by["adaptive"],
                                                n_boot=n_boot),
            adaptive_vs_proposed=compare_throughput(
                by["proposed"], by["adaptive"], n_boot=n_boot),
            ra_vs_fair=compare_throughput(by["fair"], by["adaptive_ra"],
                                          n_boot=n_boot),
            ra_vs_adaptive=compare_throughput(
                by["adaptive"], by["adaptive_ra"], n_boot=n_boot),
            delay_vs_fair=compare_throughput(by["fair"], by["delay"],
                                             n_boot=n_boot),
            locality={s: _mean([r.locality_rate for r in rs])
                      for s, rs in by.items()},
            deadline_frac={
                s: _mean([r.deadlines_met / r.jobs_total for r in rs
                          if r.jobs_total])
                for s, rs in by.items()},
            mean_makespan={s: _mean([r.makespan for r in rs])
                           for s, rs in by.items()},
        ))
        if progress:
            c = cells[-1]
            progress(f"[{preset}/{shape}/{fabric}/r{repl}/{fprofile}] "
                     f"proposed "
                     f"{c.vs_fair.mean_gain_pct:+.1f}% -> {c.verdict()}, "
                     f"adaptive {c.adaptive_vs_fair.mean_gain_pct:+.1f}% "
                     f"-> {c.adaptive_verdict()}, "
                     f"ra {c.ra_vs_fair.mean_gain_pct:+.1f}% "
                     f"-> {c.ra_verdict()}")
    return RegimeReport(presets=tuple(presets), shapes=tuple(shapes),
                        seeds=tuple(seeds), cells=cells,
                        simulated=simulated, cached=cached,
                        fabrics=(BASE_FABRIC,) + tuple(
                            f for f in fabrics if f != BASE_FABRIC),
                        replications=(BASE_REPLICATION,) + tuple(
                            r for r in replications
                            if r != BASE_REPLICATION),
                        fault_profiles=(BASE_FAULTS,) + tuple(
                            fp for fp in faults if fp != BASE_FAULTS),
                        swim=tuple(swim))


# -- serving axis -------------------------------------------------------------

def serve_spec(profile: str, shape: str,
               seeds: Sequence[int] = FULL_SEEDS,
               preset: str = SERVE_PRESET) -> ExperimentSpec:
    """One serving cell as a sweep spec: the scaled batch trace plus the
    scaled service fleet, run under both ``SERVE_SCHEDULERS`` on identical
    inputs.  The serve config enters the cluster descriptor (and so the
    cache hash) — serving cells never collide with batch-only cells."""
    machines, _ = FLEET_SHAPES[shape]
    config = dataclasses.replace(PRESETS[preset],
                                 num_jobs=scaled_jobs(preset, machines))
    cluster = dataclasses.replace(fleet_shape(shape),
                                  serve=serve_profile(profile, machines))
    return ExperimentSpec(
        name=f"serve-{preset}-{shape}-{profile}",
        traces=(TraceRef(config=config),),
        clusters=(cluster,),
        schedulers=SERVE_SCHEDULERS,
        seeds=tuple(seeds),
    )


@dataclass
class ServeCell:
    """Verdict for one (serving profile, cluster shape) point: how much
    batch throughput does harvesting recover, and what does it cost the
    services' tail latency / SLO budget?"""

    profile: str
    shape: str
    machines: int
    vms: int
    num_jobs: int
    seeds: Tuple[int, ...]
    slo_bound: float                     # ServeConfig.slo_violation_bound
    throughput: PairedComparison         # harvest-vs-adaptive batch jph
    p99: PairedComparison                # serving p99 delta (lower better)
    violation_rate: Dict[str, float]     # mean SLO-violation rate per sched
    mean_p99_ms: Dict[str, float]
    mean_makespan: Dict[str, float]
    harvest_borrows: float               # mean per harvest run
    harvest_returns: float

    def verdict(self) -> str:
        return _verdict_of(self.throughput)

    def slo_ok(self) -> bool:
        """Every scheduler held the whole-run SLO-violation bound."""
        return all(v <= self.slo_bound + 1e-12
                   for v in self.violation_rate.values())

    def to_dict(self) -> Dict[str, object]:
        return {
            "profile": self.profile,
            "shape": self.shape,
            "machines": self.machines,
            "vms": self.vms,
            "num_jobs": self.num_jobs,
            "seeds": list(self.seeds),
            "slo_bound": self.slo_bound,
            "verdict": self.verdict(),
            "slo_ok": self.slo_ok(),
            "throughput_harvest_vs_adaptive": self.throughput.to_dict(),
            "serve_p99_harvest_vs_adaptive": self.p99.to_dict(),
            "violation_rate": self.violation_rate,
            "mean_p99_ms": self.mean_p99_ms,
            "mean_makespan": self.mean_makespan,
            "harvest_borrows": self.harvest_borrows,
            "harvest_returns": self.harvest_returns,
        }


@dataclass
class ServeReport:
    preset: str
    profiles: Tuple[str, ...]
    shapes: Tuple[str, ...]
    seeds: Tuple[int, ...]
    cells: List[ServeCell]
    simulated: int
    cached: int
    version: int = REPORT_VERSION

    def cell(self, profile: str, shape: str) -> ServeCell:
        for c in self.cells:
            if (c.profile, c.shape) == (profile, shape):
                return c
        raise KeyError((profile, shape))

    def to_dict(self) -> Dict[str, object]:
        return {
            "version": self.version,
            "preset": self.preset,
            "profiles": list(self.profiles),
            "shapes": list(self.shapes),
            "seeds": list(self.seeds),
            "schedulers": list(SERVE_SCHEDULERS),
            "simulated": self.simulated,
            "cached": self.cached,
            "cells": [c.to_dict() for c in self.cells],
        }

    def save_json(self, path: Union[str, Path]) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_dict(), indent=2, sort_keys=True)
                        + "\n")
        return path

    def format(self) -> str:
        lines = [f"== serving atlas: harvest vs adaptive on co-located "
                 f"service fleets ({self.preset} batch mix, "
                 f"{len(self.seeds)} paired seeds/cell; "
                 f"{self.simulated} simulated, {self.cached} cached) =="]
        for c in self.cells:
            t, p = c.throughput, c.p99
            lines.append(
                f"  {c.profile:16s} {c.shape:6s} ({c.num_jobs:3d} jobs)  "
                f"batch {t.mean_gain_pct:+6.1f}% "
                f"[{t.ci_lo_pct:+6.1f}%, {t.ci_hi_pct:+6.1f}%] "
                f"-> {c.verdict():4s}  "
                f"p99 {p.mean_gain_pct:+6.1f}%  "
                f"viol {c.violation_rate.get('adaptive', 0.0):.4f}/"
                f"{c.violation_rate.get('harvest', 0.0):.4f} "
                f"(bound {c.slo_bound:.2f}) "
                f"{'ok' if c.slo_ok() else 'BREACH'}  "
                f"borrows {c.harvest_borrows:.1f}")
        return "\n".join(lines)

    def to_markdown(self) -> str:
        head = [
            "| profile | cluster | jobs | harvest vs adaptive batch "
            "(95% CI) | verdict | serve p99 Δ | violation rate "
            "(adaptive / harvest, bound) | SLO | borrows / returns |",
            "| --- | --- | ---: | --- | --- | --- | --- | --- | --- |",
        ]
        rows = []
        for c in self.cells:
            t, p = c.throughput, c.p99
            rows.append(
                f"| {c.profile} | {c.shape} | {c.num_jobs} "
                f"| {t.mean_gain_pct:+.1f}% [{t.ci_lo_pct:+.1f}%, "
                f"{t.ci_hi_pct:+.1f}%] | {c.verdict()} "
                f"| {p.mean_gain_pct:+.1f}% "
                f"| {c.violation_rate.get('adaptive', 0.0):.4f} / "
                f"{c.violation_rate.get('harvest', 0.0):.4f} "
                f"(≤ {c.slo_bound:.2f}) "
                f"| {'ok' if c.slo_ok() else '**breach**'} "
                f"| {c.harvest_borrows:.1f} / {c.harvest_returns:.1f} |")
        return "\n".join(head + rows)


def run_serve_regimes(profiles: Sequence[str] = SERVE_PROFILES,
                      shapes: Sequence[str] = SERVE_SHAPES,
                      seeds: Sequence[int] = FULL_SEEDS,
                      cache_dir: Union[str, Path] = ".exp-cache",
                      *, preset: str = SERVE_PRESET,
                      workers: int = 0, n_boot: int = 2000,
                      progress=None) -> ServeReport:
    """Run (or re-serve from cache) the serving axis: every profile x
    shape cell pairs ``harvest`` against ``adaptive`` on identical
    (trace, placement, jitter, request-stream) draws, so the throughput
    and p99 comparisons isolate the harvest component."""
    for p in profiles:
        if p not in _SERVE_BASES:
            raise ValueError(f"unknown serve profile {p!r}; available: "
                             f"{', '.join(_SERVE_BASES)}")
    cells: List[ServeCell] = []
    simulated = cached = 0
    for profile in profiles:
        for shape in shapes:
            spec = serve_spec(profile, shape, seeds, preset=preset)
            report = run_experiment(spec, cache_dir, workers=workers,
                                    progress=progress)
            simulated += report.simulated
            cached += report.cached
            by = report.by_scheduler()
            machines, vms = FLEET_SHAPES[shape]
            cells.append(ServeCell(
                profile=profile,
                shape=shape,
                machines=machines,
                vms=vms,
                num_jobs=scaled_jobs(preset, machines),
                seeds=tuple(seeds),
                slo_bound=serve_profile(profile,
                                        machines).slo_violation_bound,
                throughput=compare_throughput(by["adaptive"], by["harvest"],
                                              n_boot=n_boot),
                p99=compare_serve_p99(by["adaptive"], by["harvest"],
                                      n_boot=n_boot),
                violation_rate={
                    s: _mean([r.serve.get("violation_rate", 0.0)
                              for r in rs])
                    for s, rs in by.items()},
                mean_p99_ms={
                    s: _mean([r.serve.get("p99_ms", 0.0) for r in rs])
                    for s, rs in by.items()},
                mean_makespan={s: _mean([r.makespan for r in rs])
                               for s, rs in by.items()},
                harvest_borrows=_mean(
                    [r.serve.get("harvest_borrows", 0)
                     for r in by["harvest"]]),
                harvest_returns=_mean(
                    [r.serve.get("harvest_returns", 0)
                     for r in by["harvest"]]),
            ))
            if progress:
                c = cells[-1]
                progress(f"[serve {profile}/{shape}] batch "
                         f"{c.throughput.mean_gain_pct:+.1f}% "
                         f"-> {c.verdict()}, p99 "
                         f"{c.p99.mean_gain_pct:+.1f}%, "
                         f"viol {c.violation_rate.get('harvest', 0.0):.4f} "
                         f"({'ok' if c.slo_ok() else 'BREACH'})")
    return ServeReport(preset=preset, profiles=tuple(profiles),
                       shapes=tuple(shapes), seeds=tuple(seeds),
                       cells=cells, simulated=simulated, cached=cached)
