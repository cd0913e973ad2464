"""Fault injection on the port's event engine, on the CPU:
``tests/test_faults.py`` with the port's modules — the fault log is
byte-reproducible from (config, seed, workload, policy), the fault streams
never touch the decision RNG, re-replication restores locality, machine
classes slow the old class, the config plumbing keeps cache hashes, and
every baseline drains under churn.  (``tests/test_torch_engine.py`` holds
the port's fault logs to the original's.)
"""
import copy
import json
import random

import pytest

from repro_torch.core.policies import PolicySpec
from repro_torch.core.types import (ClusterSpec, FaultConfig, JobSpec,
                                    MachineClass, TaskKind, WorkloadProfile)
from repro_torch.simcluster.largescale import SCENARIOS
from repro_torch.simcluster.sim import ClusterSim
from repro_torch.simcluster.workloads import default_deadline, make_job

CHURN = FaultConfig(enabled=True, crash_mtbf=300.0, crash_mttr=60.0,
                    rereplicate_after=30.0)
HETERO = (MachineClass(name="new", weight=3),
          MachineClass(name="old", weight=1, speed=1.4, fabric=1.25,
                       mtbf_scale=0.5))


def _spec(machines=6, vms=2, replication=1, faults=CHURN):
    return ClusterSpec(num_machines=machines, vms_per_machine=vms,
                       replication=replication, faults=faults)


def _jobs(spec, n=6, seed=0):
    rng = random.Random(seed)
    jobs = []
    for i in range(n):
        w = ["wordcount", "grep", "sort"][i % 3]
        gb = 0.5 + 0.5 * (i % 4)
        jobs.append(make_job(f"{w}-{i}", w, gb, default_deadline(w, gb),
                             spec, rng, submit_time=30.0 * i))
    return jobs


def _run(spec, policy="proposed", seed=0, jobs=None):
    sched = PolicySpec(policy).build(spec)
    sim = ClusterSim(spec, sched, seed=seed)
    res = sim.run(jobs if jobs is not None else _jobs(spec))
    return sim, res


# -- fault-schedule determinism ----------------------------------------------

def test_fault_log_is_deterministic_for_config_and_seed():
    """Same (FaultConfig, seed, workload, policy) -> byte-identical fault
    event log on every repeat; a different seed diverges.  The schedule is
    drawn from dedicated streams, but chains suspend over idle windows, so
    two *policies* may realize different churn tails — the reproducibility
    pin is per run configuration."""
    logs = {}
    for policy in ("proposed", "fifo", "adaptive"):
        sim, res = _run(_spec(), policy=policy, seed=7)
        assert sim.fault_stats["crashes"] > 0
        logs[policy] = json.dumps(sim.fault_log)
        again, _ = _run(_spec(), policy=policy, seed=7)
        assert json.dumps(again.fault_log) == logs[policy]
    # the pre-idle prefix is policy-independent: every policy starts from
    # the same per-machine streams, so the first crash is shared
    first = json.loads(logs["proposed"])[0]
    assert first == json.loads(logs["fifo"])[0]
    assert first == json.loads(logs["adaptive"])[0]
    other, _ = _run(_spec(), policy="proposed", seed=8)
    assert json.dumps(other.fault_log) != logs["proposed"]


@pytest.mark.parametrize("policy", ["fifo", "fair", "delay"])
def test_fault_rng_streams_do_not_touch_decision_rng(policy):
    """Faults draw from dedicated per-machine streams, never ``self.rng``:
    an *enabled* config whose every fault process is off reproduces the
    faults-off run exactly — same durations, same decisions, same makespan.
    (Pinned on the non-reconfiguring policies: the fault-aware engine also
    frees a reconfig double-launch's leaked slot, an intentional divergence
    from the frozen engine's leak.)"""
    base_spec = _spec(faults=FaultConfig())
    quiet = FaultConfig(enabled=True, crash_mtbf=0.0, burst_rate=0.0)
    sim_off, res_off = _run(base_spec, policy=policy, seed=3)
    sim_on, res_on = _run(_spec(faults=quiet), policy=policy, seed=3,
                          jobs=_jobs(base_spec))
    assert res_on.makespan == res_off.makespan
    assert {j: r.finish_time for j, r in res_on.jobs.items()} \
        == {j: r.finish_time for j, r in res_off.jobs.items()}
    assert sim_on.fault_log == []


# -- re-replication -----------------------------------------------------------

def test_rereplication_restores_locality_and_counts():
    """With replication=1 a down machine orphans its blocks; after the
    grace window each orphaned pending block gains a replica on a live
    node, and the caller's JobSpec placements are never mutated."""
    spec = _spec(machines=4, vms=2, replication=1,
                 faults=FaultConfig(enabled=True, crash_mtbf=200.0,
                                    crash_mttr=400.0,  # long outages
                                    rereplicate_after=20.0))
    jobs = _jobs(spec, n=8)
    before = [copy.deepcopy(j.block_placement) for j in jobs]
    sim, res = _run(spec, seed=11, jobs=jobs)
    assert sim.fault_stats["crashes"] > 0
    assert sim.fault_stats["blocks_rereplicated"] > 0
    assert [j.block_placement for j in jobs] == before
    assert all(r.finish_time is not None for r in res.jobs.values())


# -- heterogeneity ------------------------------------------------------------

def test_machine_class_pattern_is_weight_expanded_round_robin():
    f = FaultConfig(enabled=True, machine_classes=HETERO)
    names = [f.machine_class(m).name for m in range(8)]
    assert names == ["new", "new", "new", "old"] * 2
    # disabled or homogeneous -> base class everywhere
    assert FaultConfig().machine_class(0).name == "base"
    assert FaultConfig(enabled=True).machine_class(3).speed == 1.0


def test_heterogeneous_fleet_slows_old_class_tasks():
    """Tasks on 'old'-class machines take speed× longer: with CV=0 the
    recorded map durations on old-class VMs are exactly 1.4× the new-class
    ones for the same job."""
    prof = WorkloadProfile(name="t", map_time=10.0, reduce_time=5.0,
                           shuffle_time_per_pair=0.0, time_cv=0.0)
    f = FaultConfig(enabled=True, machine_classes=HETERO)
    spec = ClusterSpec(num_machines=4, vms_per_machine=1, replication=1,
                       faults=f)
    # two blocks per node (= map slots per VM) so every VM runs exactly
    # its own local maps
    job = JobSpec(job_id="j", profile=prof, u_m=8, v_r=1, deadline=1e6,
                  block_placement=[(i // 2,) for i in range(8)])
    sched = PolicySpec("fifo").build(spec)
    sim = ClusterSim(spec, sched, seed=0, straggler_prob=0.0)
    durations = {}
    real = ClusterSim.task_duration

    def record(self, jb, task, local, node=None, now=0.0):
        d = real(self, jb, task, local, node=node, now=now)
        if task.kind == TaskKind.MAP:
            durations[node] = d
        return d
    sim.task_duration = record.__get__(sim)
    sim.run([job])
    # machines 0-2 are 'new', machine 3 is 'old' (weights 3:1); 1 VM each
    assert durations[3] == pytest.approx(1.4 * durations[0])
    assert durations[0] == durations[1] == durations[2]


# -- config plumbing ----------------------------------------------------------

def test_default_faults_omitted_from_spec_dict():
    """Cache-hash stability: a default FaultConfig must leave
    ClusterSpec.to_dict() exactly as it was before the fault layer."""
    d = ClusterSpec(num_machines=4, vms_per_machine=2).to_dict()
    assert "faults" not in d
    d2 = _spec().to_dict()
    assert d2["faults"]["enabled"] is True
    assert ClusterSpec.from_dict(d2) == _spec()
    assert ClusterSpec.from_dict(d) == ClusterSpec(num_machines=4,
                                                   vms_per_machine=2)


def test_fault_config_validation_and_active():
    with pytest.raises(ValueError):
        FaultConfig(crash_mtbf=-1.0)
    with pytest.raises(ValueError):
        FaultConfig(crash_mttr=0.0)
    with pytest.raises(ValueError):
        FaultConfig(burst_slowdown=0.9)
    with pytest.raises(ValueError):
        MachineClass(weight=0)
    assert not FaultConfig().active
    assert not FaultConfig(enabled=True).active          # all processes off
    assert FaultConfig(enabled=True, crash_mtbf=100.0).active
    assert FaultConfig(enabled=True, machine_classes=HETERO).active
    rt = FaultConfig.from_dict(CHURN.to_dict())
    assert rt == CHURN


def test_churn_scenario_preset_shape():
    sc = SCENARIOS["fleet_100x2_churn"]
    assert sc.faults.enabled and sc.faults.crash_mtbf > 0
    assert sc.faults.machine_classes
    assert sc.cluster().faults is sc.faults
    # the non-churn scenarios stay fault-free
    assert not SCENARIOS["fleet_100x2"].faults.enabled


# -- baseline liveness under churn (the delay scheduler must not wedge) ------

@pytest.mark.parametrize("policy", ["delay", "fair", "fifo", "adaptive_ra"])
def test_baselines_drain_under_churn(policy):
    """Every baseline finishes every job under sustained churn: in
    particular the delay scheduler's skip-count logic must not spin on
    offers that can no longer arrive from a down node."""
    spec = _spec(machines=5, vms=2, replication=2)
    sim, res = _run(spec, policy=policy, seed=5, jobs=_jobs(spec, n=10))
    assert sim.fault_stats["crashes"] > 0
    assert not sim.live and not sim.lost_pending
    assert all(r.finish_time is not None for r in res.jobs.values())
    for rj in res.jobs.values():
        assert len(rj.completed_map) == rj.spec.u_m
        assert len(rj.completed_reduce) == rj.spec.v_r


def test_vcpu_conservation_across_crash_restart():
    """Crash + restart of machines holding parked tasks / in-flight plugs
    keeps the cluster vCPU sum exact (reconfiguring policies)."""
    spec = _spec(machines=5, vms=2, replication=2)
    sim, res = _run(spec, policy="adaptive", seed=9, jobs=_jobs(spec, n=10))
    assert sim.fault_stats["crashes"] > 0
    rc = sim.reconfig
    assert rc.total_vcpus == spec.num_nodes * spec.base_map_slots
    assert sum(rc.vcpus) + len(rc.in_flight) == rc.total_vcpus
    assert all(r.finish_time is not None for r in res.jobs.values())
