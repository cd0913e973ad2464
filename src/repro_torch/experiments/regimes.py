"""Regime atlas grids, as the port's own copy of the JAX package's
``experiments/regimes.py``: the atlas axes (presets, fleet shapes, seeds,
policy columns, network fabrics, HDFS replication, fault and serving
profiles, the committed SWIM trace) and ``regime_spec``, which turns one
atlas point into a sweep spec.  The surrogate's calibration builds its
cells here.  Pure Python; a test holds every descriptor to the original's.

Job counts scale with the fleet (num_jobs × machines/20) so a 100-machine
cell faces proportional load, and every (trace seed, placement, jitter) draw
is shared by all schedulers — the comparisons isolate pure policy.

Not copied yet (ROADMAP M10c): ``RegimeCell``, ``run_regimes``,
``serve_spec``, the serving regimes and the reports.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Sequence, Tuple

from repro_torch.core.types import (FaultConfig, MachineClass, ServeConfig,
                                    ServiceSpec)
from repro_torch.experiments.runner import ExperimentSpec, TraceRef
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
