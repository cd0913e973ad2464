"""Large-fleet scenario suite — clusters far beyond the paper's 20 machines.

This is the port's own copy of the JAX package's ``simcluster/largescale.py``
(pure Python).  The frozen seed engine (``engine="legacy"``) is not ported:
asking for it raises ``PolicyError``.

The paper evaluates on 20 machines × 2 VMs and ≤ 25 jobs.  The ROADMAP
north-star (and the virtual-cluster scheduler evaluations in
arXiv:1808.08040 / arXiv:1704.02632) call for schedulers exercised on
hundreds of machines and hundreds of jobs with realistic *bursty* submission
patterns — fleets the seed engine's O(jobs × tasks) heartbeat scans could
not simulate in reasonable time.  Each scenario here is a named, seedable
recipe: a ``ClusterSpec`` plus a job-arrival trace.

Burst patterns deliberately include long idle gaps between waves: a job
submitted after the cluster drains exercises the heartbeat re-arm path
(the seed engine deadlocked there — its heartbeat chains died with the last
finished job and never revived).
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

from repro_torch.core.types import (ClusterSpec, FaultConfig, JobSpec,
                                    MachineClass, ServeConfig, ServiceSpec)
from repro_torch.simcluster.workloads import (WORKLOADS, default_deadline,
                                              make_job)


@dataclass(frozen=True)
class Scenario:
    """A reproducible large-fleet experiment: cluster shape + arrival trace."""

    name: str
    description: str
    num_machines: int
    vms_per_machine: int
    num_jobs: int
    # jobs arrive in bursts: ``burst_size`` jobs every ``burst_gap`` seconds,
    # spaced ``intra_burst_stagger`` apart inside a burst
    burst_size: int
    burst_gap: float
    intra_burst_stagger: float = 2.0
    sizes_gb: Sequence[float] = (1.0, 2.0, 3.0, 4.0)
    skew: float = 1.0
    replication: int = 3
    deadline_slack: float = 2.2
    # fault-injection layer (FaultConfig, default disabled) — churn
    # scenarios run the same arrival trace on a fleet that loses nodes
    faults: FaultConfig = FaultConfig()
    # co-located serving layer (ServeConfig, default disabled) — serving
    # scenarios pin service cores the batch side can harvest back
    serve: ServeConfig = ServeConfig()

    def cluster(self) -> ClusterSpec:
        return ClusterSpec(num_machines=self.num_machines,
                           vms_per_machine=self.vms_per_machine,
                           replication=self.replication,
                           faults=self.faults,
                           serve=self.serve)

    def jobs(self, spec: ClusterSpec, seed: int = 0) -> List[JobSpec]:
        rng = random.Random(seed)
        workloads = list(WORKLOADS)
        jobs: List[JobSpec] = []
        t = 0.0
        # deadlines scale with how big the job is relative to the fleet, so
        # large fleets get proportionally tight (still feasible) goals
        slot_scale = max(1.0, spec.num_nodes * spec.base_map_slots / 40.0)
        for i in range(self.num_jobs):
            if i > 0 and i % self.burst_size == 0:
                t += self.burst_gap
            w = workloads[rng.randrange(len(workloads))]
            size = self.sizes_gb[rng.randrange(len(self.sizes_gb))]
            deadline = (default_deadline(w, size, slack=self.deadline_slack)
                        / slot_scale + 180.0)
            jobs.append(make_job(f"{w}-{i}", w, size, deadline, spec, rng,
                                 submit_time=t, skew=self.skew))
            t += self.intra_burst_stagger
        return jobs

    def total_tasks(self, jobs: Sequence[JobSpec]) -> int:
        return sum(j.u_m + j.v_r for j in jobs)


SCENARIOS: Dict[str, Scenario] = {s.name: s for s in [
    Scenario(
        name="fleet_100x2",
        description="100 machines x 2 VMs, 120 jobs in bursts of 30",
        num_machines=100, vms_per_machine=2, num_jobs=120,
        burst_size=30, burst_gap=240.0),
    Scenario(
        name="fleet_200x2",
        description="200 machines x 2 VMs, 250 jobs in bursts of 50",
        num_machines=200, vms_per_machine=2, num_jobs=250,
        burst_size=50, burst_gap=180.0, sizes_gb=(1.0, 2.0, 4.0, 6.0)),
    Scenario(
        name="fleet_200x4",
        description="200 machines x 4 VMs, 300 jobs in bursts of 75",
        num_machines=200, vms_per_machine=4, num_jobs=300,
        burst_size=75, burst_gap=150.0, sizes_gb=(2.0, 4.0, 6.0)),
    Scenario(
        name="fleet_400x2",
        description="400 machines x 2 VMs, 500 jobs in bursts of 100",
        num_machines=400, vms_per_machine=2, num_jobs=500,
        burst_size=100, burst_gap=120.0, sizes_gb=(2.0, 4.0, 8.0)),
    Scenario(
        name="fleet_100x2_sustained",
        description=("100 machines x 2 VMs, 150 jobs arriving continuously "
                     "at near-saturation (the cluster never drains, so the "
                     "seed engine can run it too — the apples-to-apples "
                     "speedup benchmark)"),
        num_machines=100, vms_per_machine=2, num_jobs=150,
        burst_size=150, burst_gap=0.0, intra_burst_stagger=2.0,
        sizes_gb=(3.0, 6.0, 9.0, 12.0)),
    Scenario(
        name="burst_idle_gap",
        description=("100 machines x 2 VMs, 100 jobs in bursts separated by "
                     "long idle gaps (heartbeat re-arm stress)"),
        num_machines=100, vms_per_machine=2, num_jobs=100,
        burst_size=20, burst_gap=1500.0, sizes_gb=(0.5, 1.0, 2.0)),
    Scenario(
        name="fleet_100x2_churn",
        description=("100 machines x 2 VMs, 120 jobs under node churn: "
                     "crashes (MTBF 1800 s, MTTR 120 s), straggler bursts, "
                     "and a 3:1 heterogeneous new/old machine mix — the "
                     "fault-injection benchmark scenario"),
        num_machines=100, vms_per_machine=2, num_jobs=120,
        burst_size=30, burst_gap=240.0,
        faults=FaultConfig(
            enabled=True,
            crash_mtbf=1800.0, crash_mttr=120.0,
            rereplicate_after=60.0,
            burst_rate=900.0, burst_duration=45.0, burst_slowdown=2.5,
            machine_classes=(
                MachineClass(name="new", weight=3),
                MachineClass(name="old", weight=1, speed=1.4, fabric=1.25,
                             mtbf_scale=0.5),
            ))),
    Scenario(
        name="fleet_100x2_serving",
        description=("100 machines x 2 VMs, 120 batch jobs co-located with "
                     "a 20-replica 2-vCPU service fleet (40 of 400 cores "
                     "pinned) — the serving/harvest benchmark scenario"),
        num_machines=100, vms_per_machine=2, num_jobs=120,
        burst_size=30, burst_gap=240.0,
        serve=ServeConfig(enabled=True, services=(
            ServiceSpec(name="api", replicas=20, vcpus=2, base_rps=15.0,
                        diurnal_amplitude=0.3, slo_p99_ms=600.0),
        ))),
    Scenario(
        name="smoke_40x2",
        description="40 machines x 2 VMs, 40 jobs — CI-sized smoke scenario",
        num_machines=40, vms_per_machine=2, num_jobs=40,
        burst_size=10, burst_gap=200.0, sizes_gb=(0.5, 1.0, 2.0)),
]}


# Cluster shapes for the regime atlas (experiments/regimes.py): the paper's
# 20x2 up to fleet scale.  Replication 1 matches the calibrated paper setting
# (per-VM virtual disks); the scenario suite above keeps replication 3 for
# the HDFS-default stress runs.
FLEET_SHAPES: Dict[str, Tuple[int, int]] = {
    "20x2": (20, 2),
    "50x2": (50, 2),
    "100x2": (100, 2),
}


def fleet_shape(name: str, replication: int = 1) -> ClusterSpec:
    """``ClusterSpec`` for a named ``MxV`` shape from ``FLEET_SHAPES``."""
    if name not in FLEET_SHAPES:
        raise ValueError(f"unknown fleet shape {name!r}; available: "
                         f"{', '.join(FLEET_SHAPES)}")
    machines, vms = FLEET_SHAPES[name]
    return ClusterSpec(num_machines=machines, vms_per_machine=vms,
                       replication=replication)


def build_scheduler(kind: str, spec: ClusterSpec, *, legacy: bool = False):
    """Deprecated string-keyed factory — the policy registry replaced it.

    Kept as a shim so old call sites keep working: ``kind`` is resolved
    through ``repro_torch.core.policies`` (``PolicyError`` subclasses ValueError,
    so unknown names still raise ValueError).  New code should construct a
    ``PolicySpec`` and call ``.build(spec)`` directly."""
    import warnings

    from repro_torch.core.policies import build_policy
    warnings.warn(
        "build_scheduler(kind: str, ...) is deprecated; use "
        "repro_torch.core.policies.PolicySpec(name, params).build(cluster) "
        "or SchedulerBase.from_policy(...)",
        DeprecationWarning, stacklevel=2)
    return build_policy(kind, spec, legacy=legacy)


def run_scenario(name: str, *, scheduler="proposed", seed: int = 0,
                 engine: str = "indexed", until: float = 10_000_000.0,
                 tracing=None):
    """Run one named scenario; returns the ``SimResult``.  ``scheduler`` is
    any policy value ``PolicySpec.parse`` accepts (name, JSON, dict, spec).
    ``tracing`` enables the decision-trace bus on the indexed engine: pass a
    ``TraceConfig`` (or ``True`` for the default-on config); the result's
    ``trace`` attribute then carries the bus.  The legacy engine has no bus
    — tracing there is rejected rather than silently dropped; without
    tracing, ``engine="legacy"`` raises ``PolicyError`` (not ported)."""
    import dataclasses

    from repro_torch.core.policies import build_policy
    sc = SCENARIOS[name]
    spec = sc.cluster()
    if tracing:
        from repro_torch.core.types import TraceConfig
        if tracing is True:
            tracing = TraceConfig(enabled=True)
        if engine == "legacy":
            raise ValueError("tracing requires the indexed engine")
        spec = dataclasses.replace(spec, tracing=tracing)
    jobs = sc.jobs(spec, seed=seed)
    sched = build_policy(scheduler, spec, legacy=(engine == "legacy"))
    from repro_torch.simcluster.sim import ClusterSim
    sim = ClusterSim(spec, sched, seed=seed)
    return sim.run(jobs, until=until)
