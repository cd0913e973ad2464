"""The port's frozen seed engine (``repro_torch.simcluster._legacy``) on the
CPU: the decision-parity contract between the port's two engines, and the
port's legacy results against the JAX package's.

The first half holds the port's indexed engine to the port's legacy engine
bit for bit, as ``tests/test_parity.py`` and ``tests/test_parity_fuzz.py``
hold the original's: Table 2 under proposed, fair and fifo at seeds 3 and
11, the job mix, heavy stragglers, the deterministic fuzz sweep of
``REPRO_FUZZ_SCENARIOS`` scenarios (default 200; ``REPRO_FUZZ_SEED`` picks
the family) and its hypothesis pass, the adaptive-ON and fault-ON liveness
sweeps, and the "off is default and inert" pins.  The scenario generator is
the original's, drawn in the same order from one ``random.Random`` and built
from either package's types, so one seed gives the same scenario in both.

The second half compares the packages: the port's ``LegacyClusterSim`` on
the same scenario gives the original's results, dumped to canonical JSON
(the packages' ``TaskKind`` and dataclasses are different classes, so
objects are never compared directly).
"""
import dataclasses
import json
import os
import random

import pytest

import repro.core.policies as jpol
import repro.core.types as jtypes
import repro.experiments.metrics as jmetrics
import repro.simcluster._legacy as jlegacy
import repro.simcluster.largescale as jlarge
import repro.simcluster.sim as jsim
import repro.simcluster.traces as jtraces
import repro.simcluster.workloads as jwork
import repro_torch.core.policies as tpol
import repro_torch.core.types as ttypes
import repro_torch.experiments.metrics as tmetrics
import repro_torch.simcluster._legacy as tlegacy
import repro_torch.simcluster.largescale as tlarge
import repro_torch.simcluster.sim as tsim
import repro_torch.simcluster.traces as ttraces
import repro_torch.simcluster.workloads as twork
from repro_torch.core.baselines import FairScheduler, FIFOScheduler
from repro_torch.core.policies import PolicySpec
from repro_torch.core.reconfigurator import Reconfigurator
from repro_torch.core.scheduler import CompletionTimeScheduler
from repro_torch.core.types import (AdaptiveConfig, FaultConfig, ServeConfig,
                                    TraceConfig)
from repro_torch.simcluster._legacy import (LegacyClusterSim,
                                            LegacyCompletionTimeScheduler,
                                            LegacyFairScheduler,
                                            LegacyFIFOScheduler,
                                            LegacyReconfigurator)
from repro_torch.simcluster.sim import ClusterSim
from repro_torch.simcluster.workloads import (paper_cluster, paper_job_mix,
                                              paper_table2_jobs)

try:                                    # optional [test] extra
    import hypothesis
    from hypothesis import given, settings, strategies as st
except ImportError:                     # pragma: no cover - env-dependent
    hypothesis = None

# one namespace a package: the modules a legacy run goes through
JAX = dict(types=jtypes, pol=jpol, sim=jsim, legacy=jlegacy, work=jwork,
           metrics=jmetrics, traces=jtraces, large=jlarge)
PORT = dict(types=ttypes, pol=tpol, sim=tsim, legacy=tlegacy, work=twork,
            metrics=tmetrics, traces=ttraces, large=tlarge)

N_SCENARIOS = int(os.environ.get("REPRO_FUZZ_SCENARIOS", "200"))
N_ADAPTIVE = int(os.environ.get("REPRO_ADAPTIVE_FUZZ_SCENARIOS", "60"))
N_FAULT = int(os.environ.get("REPRO_FAULT_FUZZ_SCENARIOS", "60"))
BASE_SEED = int(os.environ.get("REPRO_FUZZ_SEED", "0"))
CHUNKS = 8
SUBMIT_WINDOW_S = 12.0      # the seed engine's heartbeats die after a drain

if hypothesis is not None:
    settings.register_profile("tier1", max_examples=25, derandomize=True,
                              deadline=None, database=None)
    settings.register_profile("dev", max_examples=200, deadline=None)
    settings.load_profile(os.environ.get("HYPOTHESIS_PROFILE", "tier1"))


# ---------------------------------------------------------------------------
# the original's fixed-seed parity cases, on the port's two engines
# ---------------------------------------------------------------------------

def _proposed(spec):
    s = CompletionTimeScheduler(spec, Reconfigurator(spec, max_wait=30.0))
    s.park_depth = 4
    return s


def _legacy_proposed(spec):
    s = LegacyCompletionTimeScheduler(spec,
                                      LegacyReconfigurator(spec, max_wait=30.0))
    s.park_depth = 4
    return s


SCHEDULERS = {
    "proposed": (_proposed, _legacy_proposed),
    "fair": (FairScheduler, LegacyFairScheduler),
    "fifo": (FIFOScheduler, LegacyFIFOScheduler),
}


def _run_both(which, seed, jobs_fn, **kw):
    spec = paper_cluster()
    new_sched, old_sched = SCHEDULERS[which]
    res_new = ClusterSim(spec, new_sched(spec), seed=seed, **kw).run(jobs_fn(spec, seed))
    res_old = LegacyClusterSim(spec, old_sched(spec), seed=seed, **kw).run(
        jobs_fn(spec, seed))
    return res_new, res_old


def _assert_identical(res_new, res_old):
    assert res_new.makespan == res_old.makespan
    assert res_new.deadlines_met() == res_old.deadlines_met()
    assert res_new.locality_rate() == res_old.locality_rate()
    assert res_new.speculative_launches == res_old.speculative_launches
    assert set(res_new.jobs) == set(res_old.jobs)
    for jid, new in res_new.jobs.items():
        old = res_old.jobs[jid]
        assert new.finish_time == old.finish_time, jid
        assert new.local_map_launches == old.local_map_launches, jid
        assert new.remote_map_launches == old.remote_map_launches, jid
        assert new.reconfig_map_launches == old.reconfig_map_launches, jid
        assert new.map_durations == old.map_durations, jid
        assert new.reduce_durations == old.reduce_durations, jid
    for key in ("reconfigurations", "parked", "expired"):
        assert res_new.reconfig_stats.get(key) == res_old.reconfig_stats.get(key)


@pytest.mark.parametrize("which", ["proposed", "fair", "fifo"])
@pytest.mark.parametrize("seed", [3, 11])
def test_table2_parity(which, seed):
    res_new, res_old = _run_both(which, seed,
                                 lambda spec, s: paper_table2_jobs(spec, seed=s))
    _assert_identical(res_new, res_old)


@pytest.mark.parametrize("which", ["proposed", "fair"])
def test_job_mix_parity(which):
    res_new, res_old = _run_both(
        which, 2, lambda spec, s: paper_job_mix(spec, sizes_gb=(2, 4, 6), seed=s))
    _assert_identical(res_new, res_old)


def test_parity_with_heavy_stragglers():
    res_new, res_old = _run_both("proposed", 9,
                                 lambda spec, s: paper_table2_jobs(spec, seed=s),
                                 straggler_prob=0.2)
    assert res_new.speculative_launches > 0
    _assert_identical(res_new, res_old)


# ---------------------------------------------------------------------------
# the original's scenario generator, over either package's types
# ---------------------------------------------------------------------------

def fuzz_adaptive_config(rng, enabled=False, m=PORT):
    floor = round(rng.uniform(1.0, 8.0), 2)
    return m["types"].AdaptiveConfig(
        enabled=enabled,
        max_wait_floor=floor,
        max_wait_ceiling=round(floor + rng.uniform(5.0, 50.0), 2),
        ewma_alpha=round(rng.uniform(0.05, 0.9), 3),
        breakeven_margin=round(rng.uniform(0.5, 2.0), 2),
        fail_streak_limit=rng.randint(1, 4),
        fail_cooldown=round(rng.uniform(5.0, 60.0), 1),
        outcome_alpha=round(rng.uniform(0.05, 0.5), 3),
        park_win_floor=round(rng.uniform(0.0, 0.8), 2),
        park_active_factor=round(rng.uniform(0.1, 1.2), 2),
        park_min_width=round(rng.uniform(0.0, 24.0), 1),
        overload_pending_factor=round(rng.uniform(0.05, 1.5), 2),
        overload_active_factor=round(rng.uniform(0.1, 1.5), 2),
    )


def fuzz_fault_config(rng, enabled=False, m=PORT):
    T = m["types"]
    classes = ()
    if rng.random() < 0.5:
        classes = (T.MachineClass(name="new", weight=rng.randint(1, 3)),
                   T.MachineClass(name="old", weight=1,
                                  speed=round(rng.uniform(1.0, 1.8), 2),
                                  fabric=round(rng.uniform(0.8, 1.5), 2),
                                  mtbf_scale=round(rng.uniform(0.3, 1.0), 2)))
    return T.FaultConfig(
        enabled=enabled,
        crash_mtbf=round(rng.uniform(120.0, 900.0), 1),
        crash_mttr=round(rng.uniform(20.0, 120.0), 1),
        crash_warmup=round(rng.uniform(0.0, 30.0), 1),
        rereplicate_after=round(rng.uniform(10.0, 60.0), 1),
        burst_rate=round(rng.uniform(100.0, 600.0), 1) if rng.random() < 0.5 else 0.0,
        burst_duration=round(rng.uniform(10.0, 60.0), 1),
        burst_slowdown=round(rng.uniform(1.5, 4.0), 2),
        machine_classes=classes,
    )


def fuzz_trace_config(rng, enabled=False, m=PORT):
    return m["types"].TraceConfig(
        enabled=enabled,
        launches=rng.random() < 0.5,
        parks=rng.random() < 0.5,
        overload=rng.random() < 0.5,
        faults=rng.random() < 0.5,
        pressure_every=round(rng.uniform(0.0, 60.0), 1),
        max_events=rng.choice([0, 1, 1000, 1_000_000]),
    )


def fuzz_serve_config(rng, m=PORT):
    """Inactive by construction: disabled with wild services, or
    quiet-enabled with none."""
    T = m["types"]
    enabled = rng.random() < 0.5
    services = ()
    if not enabled and rng.random() < 0.7:
        services = tuple(
            T.ServiceSpec(name=f"svc{i}",
                          replicas=rng.randint(1, 4),
                          vcpus=rng.randint(1, 2),
                          base_rps=round(rng.uniform(1.0, 40.0), 2),
                          diurnal_amplitude=round(rng.uniform(0.0, 0.9), 2),
                          burst_prob=round(rng.uniform(0.0, 0.2), 3),
                          burst_size_mean=round(rng.uniform(1.0, 16.0), 1),
                          service_time=round(rng.uniform(0.005, 0.1), 4),
                          slo_p99_ms=round(rng.uniform(100.0, 800.0), 1))
            for i in range(rng.randint(1, 2)))
    headroom = round(rng.uniform(0.1, 0.8), 2)
    return T.ServeConfig(
        enabled=enabled, services=services,
        harvest_headroom=headroom,
        harvest_return_util=round(headroom + rng.uniform(0.05, 0.19), 3),
        harvest_util_alpha=round(rng.uniform(0.05, 0.9), 3),
        slo_violation_bound=round(rng.uniform(0.0, 0.2), 3))


def build_scenario(rng, m=PORT):
    """One random scenario, reproducible from its integer seed alone; the
    draws are the original generator's, in its order."""
    T, W = m["types"], m["work"]
    machines = rng.randint(2, 8)
    vms = rng.randint(1, 2)
    nodes = machines * vms
    spec = T.ClusterSpec(num_machines=machines, vms_per_machine=vms,
                         replication=rng.randint(1, min(2, nodes)),
                         adaptive=fuzz_adaptive_config(rng, m=m),
                         faults=fuzz_fault_config(rng, m=m))
    n_jobs = rng.randint(1, 6)
    submits = sorted(round(rng.uniform(0.0, SUBMIT_WINDOW_S), 2) for _ in range(n_jobs))
    submits[0] = 0.0
    jobs = []
    for i, t in enumerate(submits):
        w = rng.choice(sorted(W.WORKLOADS))
        gb = round(rng.uniform(0.125, 3.0), 3)
        deadline = round(W.default_deadline(w, gb) * rng.uniform(0.6, 3.0), 1)
        jobs.append(W.make_job(f"{w}-{i}", w, gb, deadline, spec, rng,
                               submit_time=t, skew=rng.uniform(0.0, 1.5)))
    spec = dataclasses.replace(spec, tracing=fuzz_trace_config(rng, m=m))
    spec = dataclasses.replace(spec, adaptive=dataclasses.replace(
        spec.adaptive,
        surge_width=round(rng.uniform(0.0, 40.0), 1),
        crash_discount=rng.random() < 0.5,
        ewma_gap_cap=round(rng.uniform(0.0, 8.0), 2),
    ))
    spec = dataclasses.replace(spec, serve=fuzz_serve_config(rng, m=m))
    return {
        "spec": spec,
        "jobs": jobs,
        "scheduler": rng.choice(["proposed", "fair", "fifo"]),
        "sim_seed": rng.randrange(1 << 30),
        "straggler_prob": rng.choice([0.0, 0.05, 0.2]),
        "straggler_factor": round(rng.uniform(2.0, 4.0), 2),
        "speculative": rng.random() < 0.75,
        "speculation_threshold": round(rng.uniform(1.5, 3.0), 2),
        "max_wait": round(rng.uniform(5.0, 60.0), 1),
        "park_depth": rng.randint(1, 6),
    }


def _policy_spec(sc, m=PORT):
    params = {}
    if sc["scheduler"] in ("proposed", "adaptive"):
        params = {"max_wait": sc["max_wait"], "park_depth": sc["park_depth"]}
    return m["pol"].PolicySpec(sc["scheduler"], params)


def _schedulers(sc, m=PORT):
    spec = sc["spec"]
    policy = _policy_spec(sc, m)
    new = policy.build(spec)
    if sc["scheduler"] == "adaptive":
        with pytest.raises(m["pol"].PolicyError):
            policy.build(spec, legacy=True)
        return new, None
    return new, policy.build(spec, legacy=True)


def _sim_kwargs(sc):
    return dict(seed=sc["sim_seed"], straggler_prob=sc["straggler_prob"],
                straggler_factor=sc["straggler_factor"],
                speculative=sc["speculative"],
                speculation_threshold=sc["speculation_threshold"])


def assert_scenario_parity(sc):
    new_sched, old_sched = _schedulers(sc)
    res_new = ClusterSim(sc["spec"], new_sched, **_sim_kwargs(sc)).run(list(sc["jobs"]))
    res_old = LegacyClusterSim(sc["spec"], old_sched, **_sim_kwargs(sc)).run(
        list(sc["jobs"]))
    _assert_identical(res_new, res_old)


@pytest.mark.fuzz
@pytest.mark.parametrize("chunk", range(CHUNKS))
def test_fuzz_parity_deterministic(chunk):
    per_chunk = (N_SCENARIOS + CHUNKS - 1) // CHUNKS
    start = chunk * per_chunk
    for k in range(start, min(start + per_chunk, N_SCENARIOS)):
        scenario_seed = BASE_SEED * 1_000_003 + k
        sc = build_scenario(random.Random(scenario_seed))
        try:
            assert_scenario_parity(sc)
        except AssertionError as e:
            raise AssertionError(
                f"parity broken for fuzz scenario seed={scenario_seed} "
                f"({sc['scheduler']}, {sc['spec'].num_machines}x"
                f"{sc['spec'].vms_per_machine}, {len(sc['jobs'])} jobs): {e}") from e


@pytest.mark.fuzz
@pytest.mark.skipif(hypothesis is None, reason="hypothesis not installed (pip install .[test])")
def test_fuzz_parity_hypothesis():
    @given(st.integers(min_value=0, max_value=2 ** 32 - 1))
    def check(scenario_seed):
        assert_scenario_parity(build_scenario(random.Random(scenario_seed)))

    check()


# -- adaptive-ON: liveness, not parity ---------------------------------------

def _run_new(sc, sched, spec=None):
    return ClusterSim(spec or sc["spec"], sched, **_sim_kwargs(sc)).run(list(sc["jobs"]))


def assert_adaptive_liveness(sc):
    sc = dict(sc, scheduler="adaptive")
    sched, _ = _schedulers(sc)
    res = _run_new(sc, sched)
    for jid, job in res.jobs.items():
        assert job.finish_time is not None, f"{jid} never finished"
        assert len(job.completed_map) == job.spec.u_m, jid
        assert len(job.completed_reduce) == job.spec.v_r, jid
    rc = sched.reconfig
    leftover = [item for q in rc.aq for item in q]
    stats = res.reconfig_stats
    assert stats["parked"] == stats["reconfigurations"] + stats["expired"] + len(leftover)
    for item in leftover:
        assert item.task.index in res.jobs[item.task.job_id].completed_map, \
            f"stranded parked task {item.task}"
    assert not rc.in_flight
    sched_off, _ = _schedulers(dict(sc, scheduler="proposed"))
    res_off = _run_new(sc, sched_off)
    assert set(res.jobs) == set(res_off.jobs)
    for jid, job in res_off.jobs.items():
        assert job.completed_map == res.jobs[jid].completed_map, jid
        assert job.completed_reduce == res.jobs[jid].completed_reduce, jid


@pytest.mark.fuzz
@pytest.mark.parametrize("chunk", range(CHUNKS))
def test_fuzz_adaptive_never_strands(chunk):
    per_chunk = (N_ADAPTIVE + CHUNKS - 1) // CHUNKS
    start = chunk * per_chunk
    for k in range(start, min(start + per_chunk, N_ADAPTIVE)):
        scenario_seed = BASE_SEED * 7_000_003 + k
        sc = build_scenario(random.Random(scenario_seed))
        try:
            assert_adaptive_liveness(sc)
        except AssertionError as e:
            raise AssertionError(
                f"adaptive liveness broken for scenario seed={scenario_seed}: {e}") from e


# -- fault-ON: churn liveness, not parity ------------------------------------

FAULT_POLICIES = ("proposed", "adaptive", "adaptive_ra", "delay", "fair", "fifo")


def assert_fault_liveness(sc, policy):
    rng = random.Random(f"fault-knobs:{sc['sim_seed']}")
    spec = dataclasses.replace(sc["spec"], faults=fuzz_fault_config(rng, enabled=True))
    sim = ClusterSim(spec, PolicySpec(policy).build(spec), **_sim_kwargs(sc))
    res = sim.run(list(sc["jobs"]))
    assert not sim.events, "event-queue leak: loop exited with events queued"
    assert not sim.live, "tasks still marked running after drain"
    assert not sim.lost_pending, sorted(sim.lost_pending)
    for node in range(sim.spec.num_nodes):
        assert not sim.map_running[node] and not sim.red_running[node]
    for jid, job in res.jobs.items():
        assert job.finish_time is not None, f"{jid} never finished"
        assert len(job.completed_map) == job.spec.u_m, jid
        assert len(job.completed_reduce) == job.spec.v_r, jid
    fs = res.fault_stats
    assert fs["crashes"] == sum(1 for _, kind, _ in res.fault_log if kind == "crash")
    assert fs["tasks_reexecuted"] <= fs["tasks_lost"]
    return fs


@pytest.mark.fuzz
@pytest.mark.parametrize("chunk", range(CHUNKS))
def test_fuzz_fault_liveness(chunk):
    per_chunk = (N_FAULT + CHUNKS - 1) // CHUNKS
    start = chunk * per_chunk
    crashes = 0
    for k in range(start, min(start + per_chunk, N_FAULT)):
        scenario_seed = BASE_SEED * 13_000_003 + k
        sc = build_scenario(random.Random(scenario_seed))
        policy = FAULT_POLICIES[k % len(FAULT_POLICIES)]
        try:
            crashes += assert_fault_liveness(sc, policy)["crashes"]
        except AssertionError as e:
            raise AssertionError(
                f"fault liveness broken for scenario seed={scenario_seed} ({policy}): {e}") from e
    assert crashes > 0, "chaos suite chunk observed zero crashes"


# -- "off is default and inert" ----------------------------------------------

def _proposed_run(sc, **replace):
    spec = dataclasses.replace(sc["spec"], **replace) if replace else sc["spec"]
    sched, _ = _schedulers(dict(sc, scheduler="proposed", spec=spec))
    return _run_new(sc, sched, spec)


def _finish_times(res):
    return {j: r.finish_time for j, r in res.jobs.items()}


@pytest.mark.fuzz
def test_fault_off_is_default_and_inert():
    assert FaultConfig().enabled is False
    sc = build_scenario(random.Random(31337))
    assert sc["spec"].faults != FaultConfig()
    res_knobs, res_plain = _proposed_run(sc), _proposed_run(sc, faults=FaultConfig())
    assert res_knobs.makespan == res_plain.makespan
    assert _finish_times(res_knobs) == _finish_times(res_plain)
    assert res_knobs.fault_stats == {} and res_knobs.fault_log == []


@pytest.mark.fuzz
def test_serving_off_is_default_and_inert():
    assert ServeConfig().enabled is False and ServeConfig().active is False
    assert ServeConfig(enabled=True).active is False
    sc = build_scenario(random.Random(77377))
    assert sc["spec"].serve != ServeConfig() and not sc["spec"].serve.active
    res_knobs, res_plain = _proposed_run(sc), _proposed_run(sc, serve=ServeConfig())
    assert res_knobs.makespan == res_plain.makespan
    assert _finish_times(res_knobs) == _finish_times(res_plain)
    assert res_knobs.serve_stats == {} and res_knobs.serve_log == []


@pytest.mark.fuzz
def test_serving_quiet_enabled_matches_off_bit_exact():
    sc = build_scenario(random.Random(424242))
    res_off = _proposed_run(sc, serve=ServeConfig())
    res_quiet = _proposed_run(sc, serve=ServeConfig(enabled=True, services=()))
    assert res_off.makespan == res_quiet.makespan
    assert res_off.events_processed == res_quiet.events_processed
    assert res_off.reconfig_stats == res_quiet.reconfig_stats
    for jid, off in res_off.jobs.items():
        quiet = res_quiet.jobs[jid]
        assert off.finish_time == quiet.finish_time, jid
        assert off.local_map_launches == quiet.local_map_launches, jid
        assert off.remote_map_launches == quiet.remote_map_launches, jid
        assert off.map_durations == quiet.map_durations, jid
    assert res_quiet.serve_stats == {} and res_quiet.serve_log == []


@pytest.mark.fuzz
def test_tracing_off_is_default_and_inert():
    assert TraceConfig().enabled is False
    sc = build_scenario(random.Random(55057))
    assert sc["spec"].tracing != TraceConfig()
    res_knobs = _proposed_run(sc)
    assert res_knobs.trace is None
    res_plain = _proposed_run(sc, tracing=TraceConfig())
    assert res_knobs.makespan == res_plain.makespan
    assert _finish_times(res_knobs) == _finish_times(res_plain)


@pytest.mark.fuzz
def test_adaptive_off_is_default_and_inert():
    assert AdaptiveConfig().enabled is False
    sc = build_scenario(random.Random(90210))
    res_knobs, res_plain = _proposed_run(sc), _proposed_run(sc, adaptive=AdaptiveConfig())
    assert res_knobs.makespan == res_plain.makespan
    assert _finish_times(res_knobs) == _finish_times(res_plain)


# ---------------------------------------------------------------------------
# the port's legacy engine against the original's, as dumped JSON
# ---------------------------------------------------------------------------

def _dumps(obj):
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def _legacy_dump(result, m, *, cluster, label, seed, trace_name="t"):
    """Every observable of one legacy run as canonical JSON: the warehouse
    record (without ``wall_time_s``), the per-job decision counts and
    durations, the reconfigurator's counters and the event count."""
    trace = m["traces"].Trace(name=trace_name, seed=seed, jobs=[])
    rec = m["metrics"].run_record_from_result(
        result, trace=trace, cluster_dict=cluster.to_dict(), scheduler=label,
        seed=seed, wall_time_s=0.0).to_dict()
    rec.pop("wall_time_s")
    jobs = {j: [rt.finish_time, rt.local_map_launches, rt.remote_map_launches,
                rt.reconfig_map_launches, rt.map_durations, rt.reduce_durations,
                sorted(rt.completed_map), sorted(rt.completed_reduce)]
            for j, rt in result.jobs.items()}
    return _dumps({"record": rec, "jobs": jobs, "events": result.events_processed,
                   "makespan": result.makespan, "spec": result.speculative_launches,
                   "reconfig": result.reconfig_stats})


def _legacy_table2(m, which, seed, straggler_prob=0.03):
    spec = m["work"].paper_cluster()
    params = {"max_wait": 30.0, "park_depth": 4} if which == "proposed" else {}
    sched = m["pol"].PolicySpec(which, params).build(spec, legacy=True)
    res = m["legacy"].LegacyClusterSim(spec, sched, seed=seed,
                                       straggler_prob=straggler_prob).run(
        m["work"].paper_table2_jobs(spec, seed=seed))
    return _legacy_dump(res, m, cluster=spec, label=sched.name, seed=seed)


@pytest.mark.parametrize("which,seed,straggler_prob", [
    ("proposed", 3, 0.03), ("fair", 3, 0.03), ("fifo", 11, 0.03), ("proposed", 9, 0.2)])
def test_legacy_results_equal_the_original(which, seed, straggler_prob):
    assert _legacy_table2(PORT, which, seed, straggler_prob) == \
        _legacy_table2(JAX, which, seed, straggler_prob)


def _legacy_fuzz(m, scenario_seed):
    sc = build_scenario(random.Random(scenario_seed), m)
    _, sched = _schedulers(sc, m)
    res = m["legacy"].LegacyClusterSim(sc["spec"], sched, **_sim_kwargs(sc)).run(
        list(sc["jobs"]))
    return _legacy_dump(res, m, cluster=sc["spec"], label=sched.name, seed=sc["sim_seed"])


@pytest.mark.parametrize("chunk", range(4))
def test_legacy_fuzzed_results_equal_the_original(chunk):
    """Twelve fuzzed scenarios a chunk through both packages' seed engines:
    the same seed builds the same scenario in either package, and the
    dumps are byte-equal."""
    for k in range(chunk * 12, (chunk + 1) * 12):
        seed = BASE_SEED * 1_000_003 + k
        assert _legacy_fuzz(PORT, seed) == _legacy_fuzz(JAX, seed), f"scenario seed {seed}"


def test_legacy_classes_come_from_the_port():
    """Every class the copy uses is the port's own: a legacy result is the
    port's ``SimResult`` holding the port's ``JobRuntime``s."""
    spec = paper_cluster()
    res = LegacyClusterSim(spec, _legacy_proposed(spec), seed=3).run(
        paper_table2_jobs(spec, seed=3))
    assert type(res) is tsim.SimResult
    assert all(type(rt) is ttypes.JobRuntime for rt in res.jobs.values())
    assert tlegacy.OnlineEstimator.__module__ == "repro_torch.core.estimator"
    assert tlegacy.Launch.__module__ == "repro_torch.core.scheduler"
    assert tlegacy.RunningTask is tsim.RunningTask
    assert tlegacy.TaskKind is ttypes.TaskKind


# ---------------------------------------------------------------------------
# run_scenario(engine="legacy")
# ---------------------------------------------------------------------------

def _sustained(large):
    """A gap-free fleet small enough for a test: every job arrives before the
    first one can finish, so the seed engine's heartbeats never die."""
    return large.Scenario(name="sustained_20x2", description="20 x 2, 30 jobs, no gap",
                          num_machines=20, vms_per_machine=2, num_jobs=30,
                          burst_size=30, burst_gap=0.0, sizes_gb=(1.0, 2.0, 3.0))


@pytest.fixture
def sustained(monkeypatch):
    for large in (jlarge, tlarge):
        monkeypatch.setitem(large.SCENARIOS, "sustained_20x2", _sustained(large))
    return "sustained_20x2"


@pytest.mark.parametrize("name,scheduler", [("sustained_20x2", "proposed"),
                                            ("burst_idle_gap", "fifo"),
                                            ("smoke_40x2", "fair")])
def test_run_scenario_legacy_equals_the_original(name, scheduler, sustained):
    """The seed engine through ``run_scenario``, the idle-gap deadlock of
    the burst scenarios included: the same jobs starve in both packages."""
    a = jlarge.run_scenario(name, scheduler=scheduler, seed=1, engine="legacy")
    b = tlarge.run_scenario(name, scheduler=scheduler, seed=1, engine="legacy")
    assert type(b) is tsim.SimResult
    assert (b.makespan, b.events_processed, b.deadlines_met(), b.locality_rate()) == \
        (a.makespan, a.events_processed, a.deadlines_met(), a.locality_rate())
    assert {j: [rt.finish_time, rt.map_durations] for j, rt in b.jobs.items()} == \
        {j: [rt.finish_time, rt.map_durations] for j, rt in a.jobs.items()}


@pytest.mark.parametrize("scheduler", ["proposed", "fifo"])
def test_run_scenario_legacy_matches_indexed_on_a_gap_free_fleet(scheduler, sustained):
    new = tlarge.run_scenario(sustained, scheduler=scheduler, seed=0)
    old = tlarge.run_scenario(sustained, scheduler=scheduler, seed=0, engine="legacy")
    assert all(rt.finish_time is not None for rt in old.jobs.values())
    _assert_identical(new, old)
    assert new.events_processed == old.events_processed


def test_run_scenario_legacy_refusals_say_what_the_original_says():
    msgs = []
    for large in (jlarge, tlarge):
        with pytest.raises(ValueError) as e:
            large.run_scenario("fleet_100x2_serving", engine="legacy")
        msgs.append(str(e.value))
        with pytest.raises(ValueError) as e:
            large.run_scenario("smoke_40x2", engine="legacy", tracing=True)
        msgs.append(str(e.value))
        with pytest.raises(jpol.PolicyError if large is jlarge else tpol.PolicyError) as e:
            large.run_scenario("smoke_40x2", scheduler="adaptive", engine="legacy")
        msgs.append(str(e.value))
    assert msgs[:3] == msgs[3:]
    assert "no serving layer" in msgs[3] and "indexed engine" in msgs[4]
    assert "no legacy (seed-engine) counterpart" in msgs[5]
