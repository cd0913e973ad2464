"""The port's event engine (M10b) against the JAX package's, on the CPU.

The port keeps its own copies of the paper's scheduler (Algorithm 2), its
Resource Reconfigurator (Algorithm 1), the Resource Predictor (Eq. 10's
online estimator), the baselines, the decision-trace bus, the serving layer
and the discrete-event engine.  Both are pure Python on the host; the same
inputs must give the same bits.  The two packages' ``TaskKind`` are
different enum classes, so results are compared as the canonical JSON of
their ``RunRecord`` (without ``wall_time_s``), fault logs, serving logs and
trace streams, never object to object.
"""
import dataclasses
import json
import math
import random

import pytest

import repro.core.estimator as jest
import repro.core.policies as jpol
import repro.core.tracing as jtracing
import repro.core.types as jtypes
import repro.experiments.metrics as jmetrics
import repro.experiments.regimes as jregimes
import repro.experiments.runner as jrunner
import repro.simcluster.largescale as jlarge
import repro.simcluster.sim as jsim
import repro.simcluster.traces as jtraces
import repro.simcluster.workloads as jwork
import repro_torch.core.estimator as pest
import repro_torch.core.policies as tpol
import repro_torch.core.tracing as ttracing
import repro_torch.core.types as ttypes
import repro_torch.experiments.metrics as tmetrics
import repro_torch.experiments.regimes as tregimes
import repro_torch.experiments.runner as trunner
import repro_torch.simcluster.largescale as tlarge
import repro_torch.simcluster.sim as tsim
import repro_torch.simcluster.traces as ttraces
import repro_torch.simcluster.workloads as twork

# one namespace a package: the modules a run goes through
JAX = dict(types=jtypes, pol=jpol, runner=jrunner, sim=jsim, metrics=jmetrics,
           work=jwork, traces=jtraces)
PORT = dict(types=ttypes, pol=tpol, runner=trunner, sim=tsim, metrics=tmetrics,
            work=twork, traces=ttraces)
POLICIES = list(jpol.registered_policies())


def _dumps(obj):
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def _outcome(result, *, trace, cluster, label, seed, m):
    """Every observable of one run as canonical JSON strings."""
    rec = m["metrics"].run_record_from_result(
        result, trace=trace, cluster_dict=cluster.to_dict(), scheduler=label,
        seed=seed, wall_time_s=0.0).to_dict()
    rec.pop("wall_time_s")
    out = {"record": _dumps(rec),
           "fault_log": json.dumps(result.fault_log),
           "fault_stats": _dumps(result.fault_stats),
           "serve_log": json.dumps(result.serve_log),
           "durations": _dumps({j: [rt.map_durations, rt.reduce_durations]
                                for j, rt in result.jobs.items()})}
    if result.trace is not None:
        out["trace"] = result.trace.to_jsonl()
        out["trace_counts"] = _dumps(result.trace.counts)
    return out


def _run_cell(m, *, trace, cluster, policy, seed, tracing=False):
    """One grid cell as the runner builds it (``simulate_cell``), through
    one package, keeping the ``SimResult``."""
    runner, types = m["runner"], m["types"]
    cluster = types.ClusterSpec.from_dict(cluster)
    if tracing:
        cluster = dataclasses.replace(cluster, tracing=types.TraceConfig(enabled=True))
    trace = dict(trace)
    if "config" in trace:
        trace["config"] = m["traces"].TraceConfig.from_dict(trace["config"])
    ref = runner.TraceRef(**trace)
    spec = runner.ExperimentSpec(name="t", traces=(ref,), clusters=(cluster,),
                                 schedulers=(policy,), seeds=(seed,))
    cell = next(spec.cells())
    tr = cell.trace.resolve(seed)
    sched = cell.scheduler.build(cluster)
    sim = m["sim"].ClusterSim(cluster, sched, seed=seed,
                              straggler_prob=cell.straggler_prob,
                              straggler_factor=cell.straggler_factor,
                              speculative=cell.speculative,
                              speculation_threshold=cell.speculation_threshold)
    result = sim.run(tr.job_specs(cluster))
    return _outcome(result, trace=tr, cluster=cluster, label=cell.scheduler.label,
                    seed=seed, m=m), cell


def _assert_same(trace, cluster, policy, seed, tracing=False):
    a, jcell = _run_cell(JAX, trace=trace, cluster=cluster, policy=policy, seed=seed,
                         tracing=tracing)
    b, tcell = _run_cell(PORT, trace=trace, cluster=cluster, policy=policy, seed=seed,
                         tracing=tracing)
    assert list(a) == list(b)
    for key in a:
        assert a[key] == b[key], key
    # and the cell hashes into the same cache slot in both packages
    assert jcell.descriptor() == tcell.descriptor()
    assert jcell.cache_hash() == tcell.cache_hash()
    return b


def _fleet(machines, replication=1, **kw):
    return jtypes.ClusterSpec(num_machines=machines, vms_per_machine=2,
                              replication=replication, **kw).to_dict()


# ---------------------------------------------------------------------------
# records, byte for byte
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", POLICIES)
def test_every_policy_on_mix_small(policy):
    assert list(tpol.registered_policies()) == POLICIES
    out = _assert_same({"preset": "mix_small"}, _fleet(6), policy, 0)
    rec = json.loads(out["record"])
    assert rec["jobs_finished"] == rec["jobs_total"] > 0


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("policy", ["proposed", "adaptive", "fair", "delay"])
def test_heavy_tail_at_20x2(policy, seed):
    machines = jlarge.FLEET_SHAPES["20x2"][0]
    config = dataclasses.replace(jregimes.PRESETS["heavy_tail"],
                                 num_jobs=jregimes.scaled_jobs("heavy_tail", machines))
    _assert_same({"config": config.to_dict()}, _fleet(machines), policy, seed)


@pytest.mark.parametrize("policy", ["proposed", "adaptive_ra", "fifo"])
def test_replication_3(policy):
    _assert_same({"preset": "mix_small"}, _fleet(6, replication=3), policy, 2)


@pytest.mark.parametrize("policy", ["proposed", "adaptive", "fair"])
def test_fault_profile_churn_lo(policy):
    """A crash-prone fleet: the fault log (crashes, restarts, re-replication)
    and the re-executed work equal the original's."""
    faults = jregimes.FAULT_PROFILES["churn_lo"]
    assert tregimes.FAULT_PROFILES["churn_lo"].to_dict() == faults.to_dict()
    cluster = jtypes.ClusterSpec(num_machines=20, vms_per_machine=2,
                                 faults=faults).to_dict()
    config = dataclasses.replace(jregimes.PRESETS["heavy_tail"], num_jobs=30)
    out = _assert_same({"config": config.to_dict()}, cluster, policy, 3)
    assert json.loads(out["fault_stats"])["crashes"] > 0


@pytest.mark.parametrize("policy", ["harvest", "adaptive"])
def test_serving_profile(policy):
    """Co-located services: the serving log and the harvest accounting equal
    the original's, under the harvest policy and its no-harvest twin."""
    serve = tregimes.serve_profile("svc_heavy_loose", 6)
    assert serve.to_dict() == jregimes.serve_profile("svc_heavy_loose", 6).to_dict()
    cluster = jtypes.ClusterSpec(num_machines=6, vms_per_machine=2,
                                 serve=jregimes.serve_profile("svc_heavy_loose", 6)).to_dict()
    config = dataclasses.replace(jregimes.PRESETS[jregimes.SERVE_PRESET], num_jobs=12)
    out = _assert_same({"config": config.to_dict()}, cluster, policy, 1)
    assert json.loads(out["serve_log"])
    assert json.loads(out["record"])["serve"]


@pytest.mark.parametrize("policy", ["adaptive", "harvest"])
def test_traced_run_stream_is_byte_equal(policy):
    """Tracing on: the bus's canonical JSONL (``dumps_canonical`` a record)
    and its per-kind counts equal the original's."""
    assert ttracing.dumps_canonical({"b": 1, "a": [1.5, "x"]}) == \
        jtracing.dumps_canonical({"b": 1, "a": [1.5, "x"]})
    cluster = jtypes.ClusterSpec(num_machines=6, vms_per_machine=2,
                                 serve=jregimes.serve_profile("svc_spiky", 6)).to_dict()
    out = _assert_same({"preset": "mix_small"}, cluster, policy, 0, tracing=True)
    lines = out["trace"].splitlines()
    assert len(lines) > 50
    assert all(ttracing.dumps_canonical(json.loads(x)) == x for x in lines)


# ---------------------------------------------------------------------------
# a fuzz of random scenarios (after tests/test_parity_fuzz.py's generator)
# ---------------------------------------------------------------------------

N_FUZZ = 48
FUZZ_CHUNKS = 8


def _fuzz_scenario(rng, m):
    """One random scenario built from one package's types; the same ``rng``
    seed gives the same scenario in either package."""
    T = m["types"]
    machines, vms = rng.randint(2, 8), rng.randint(1, 2)
    adaptive = T.AdaptiveConfig(
        enabled=rng.random() < 0.5,
        max_wait_floor=round(rng.uniform(1.0, 8.0), 2),
        ewma_alpha=round(rng.uniform(0.05, 0.9), 3),
        fail_streak_limit=rng.randint(1, 4),
        park_win_floor=round(rng.uniform(0.0, 0.8), 2),
        overload_pending_factor=round(rng.uniform(0.05, 1.5), 2),
        overload_active_factor=round(rng.uniform(0.1, 1.5), 2),
        surge_width=round(rng.uniform(0.0, 40.0), 1))
    faults = T.FaultConfig()
    if rng.random() < 0.3:
        classes = ()
        if rng.random() < 0.5:
            classes = (T.MachineClass(name="new", weight=rng.randint(1, 3)),
                       T.MachineClass(name="old", weight=1,
                                      speed=round(rng.uniform(1.0, 1.8), 2),
                                      fabric=round(rng.uniform(0.8, 1.5), 2),
                                      mtbf_scale=round(rng.uniform(0.3, 1.0), 2)))
        faults = T.FaultConfig(
            enabled=True, crash_mtbf=round(rng.uniform(120.0, 900.0), 1),
            crash_mttr=round(rng.uniform(20.0, 120.0), 1),
            rereplicate_after=round(rng.uniform(10.0, 60.0), 1),
            burst_rate=round(rng.uniform(100.0, 600.0), 1) if rng.random() < 0.5 else 0.0,
            machine_classes=classes)
    serve = T.ServeConfig()
    if rng.random() < 0.25:
        serve = T.ServeConfig(enabled=True, services=(T.ServiceSpec(
            name="svc", replicas=rng.randint(1, 3), vcpus=rng.randint(1, 2),
            base_rps=round(rng.uniform(1.0, 30.0), 2),
            slo_p99_ms=round(rng.uniform(100.0, 800.0), 1)),))
    spec = T.ClusterSpec(num_machines=machines, vms_per_machine=vms,
                         replication=rng.randint(1, min(2, machines * vms)),
                         adaptive=adaptive, faults=faults, serve=serve,
                         remote_penalty_scale=rng.choice([1.0, 0.25]))
    n_jobs = rng.randint(1, 6)
    submits = sorted(round(rng.uniform(0.0, 60.0), 2) for _ in range(n_jobs))
    submits[0] = 0.0
    jobs = []
    for i, t in enumerate(submits):
        w = rng.choice(sorted(m["work"].WORKLOADS))
        gb = round(rng.uniform(0.125, 3.0), 3)
        deadline = round(m["work"].default_deadline(w, gb) * rng.uniform(0.6, 3.0), 1)
        jobs.append(m["work"].make_job(f"{w}-{i}", w, gb, deadline, spec, rng,
                                       submit_time=t, skew=rng.uniform(0.0, 1.5)))
    policy = rng.choice(POLICIES)
    params = {}
    if policy in ("proposed", "edf_nopark"):
        params = {"max_wait": round(rng.uniform(5.0, 60.0), 1),
                  "park_depth": rng.randint(1, 6)}
    elif policy in ("fair", "delay"):
        params = {"locality_delay": rng.randint(0, 10)}
    kwargs = dict(seed=rng.randrange(1 << 30),
                  straggler_prob=rng.choice([0.0, 0.05, 0.2]),
                  straggler_factor=round(rng.uniform(2.0, 4.0), 2),
                  speculative=rng.random() < 0.75,
                  speculation_threshold=round(rng.uniform(1.5, 3.0), 2))
    return spec, jobs, m["pol"].PolicySpec(policy, params), kwargs


def _fuzz_outcome(seed, m):
    spec, jobs, policy, kwargs = _fuzz_scenario(random.Random(seed), m)
    result = m["sim"].ClusterSim(spec, policy.build(spec), **kwargs).run(jobs)
    summary = {
        "makespan": result.makespan, "events": result.events_processed,
        "spec_launches": result.speculative_launches,
        "reconfig": result.reconfig_stats, "faults": result.fault_stats,
        "serve": result.serve_stats,
        "jobs": {j: [rt.finish_time, rt.local_map_launches, rt.remote_map_launches,
                     rt.reconfig_map_launches, rt.map_durations, rt.reduce_durations]
                 for j, rt in result.jobs.items()}}
    return (policy.label, _dumps(summary), json.dumps(result.fault_log),
            json.dumps(result.serve_log))


@pytest.mark.parametrize("chunk", range(FUZZ_CHUNKS))
def test_fuzzed_scenarios_are_byte_equal(chunk):
    per = N_FUZZ // FUZZ_CHUNKS
    for k in range(chunk * per, (chunk + 1) * per):
        seed = 7_000_003 + k
        assert _fuzz_outcome(seed, PORT) == _fuzz_outcome(seed, JAX), f"scenario seed {seed}"


# ---------------------------------------------------------------------------
# the Resource Predictor
# ---------------------------------------------------------------------------

def _runtime(m, rng, cluster):
    """A JobRuntime mid-run: some maps and reduces done, sampled durations."""
    w = rng.choice(sorted(m["work"].WORKLOADS))
    gb = round(rng.uniform(0.25, 6.0), 3)
    job = m["work"].make_job("j", w, gb, round(rng.uniform(30.0, 900.0), 1), cluster, rng,
                             submit_time=round(rng.uniform(0.0, 100.0), 2))
    rt = m["types"].JobRuntime(spec=job)
    for i in range(rng.randint(0, job.u_m)):
        rt.completed_map.add(i)
        d = rng.uniform(5.0, 60.0)
        rt.map_durations.append(d)
        rt.map_duration_sum += d
    for i in range(rng.randint(0, job.v_r) if rt.map_durations else 0):
        rt.completed_reduce.add(i)
        rt.reduce_durations.append(rng.uniform(5.0, 90.0))
    return rt


@pytest.mark.parametrize("assume", [True, False])
def test_online_estimator_equals_the_original(assume):
    jcluster = jtypes.ClusterSpec(num_machines=10, vms_per_machine=2)
    tcluster = ttypes.ClusterSpec(num_machines=10, vms_per_machine=2)
    jcfg = jest.EstimatorConfig(assume_tr_equals_tm=assume)
    tcfg = pest.EstimatorConfig(assume_tr_equals_tm=assume)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    je, te = jest.OnlineEstimator(jcfg), pest.OnlineEstimator(tcfg)
    seen = 0
    for seed in range(200):
        ja = _runtime(JAX, random.Random(seed), jcluster)
        ta = _runtime(PORT, random.Random(seed), tcluster)
        assert (te.t_m(ta), te.t_r(ta), te.t_s(ta)) == (je.t_m(ja), je.t_r(ja), je.t_s(ja))
        rng = random.Random(seed + 1)
        now = rng.uniform(0.0, 1200.0)
        caps = rng.choice([(None, None), (20, 20), (3, 2)])
        for remaining in (True, False):
            kw = dict(max_map_slots=caps[0], max_reduce_slots=caps[1],
                      remaining_work=remaining)
            a, b = je.demand(ja, now, **kw), te.demand(ta, now, **kw)
            assert (a is None) == (b is None)
            if a is not None:
                seen += 1
                assert repr(dataclasses.asdict(b)) == repr(dataclasses.asdict(a))
    assert seen > 100


def test_completion_time_and_mean_equal_the_original():
    rng = random.Random(11)
    for _ in range(500):
        args = (rng.randint(1, 400), rng.randint(1, 60), rng.uniform(1, 90),
                rng.uniform(1, 90), rng.uniform(0, 0.5), rng.randint(1, 80),
                rng.randint(1, 40))
        assert pest.completion_time(*args) == jest.completion_time(*args)
        sample = [rng.uniform(0, 100) for _ in range(rng.randint(0, 9))]
        assert pest.mean_task_length(sample) == jest.mean_task_length(sample)
        d = rng.uniform(-50, 2000)
        a = jest.min_slots(*args[:5], d, max_map_slots=40, max_reduce_slots=40)
        b = pest.min_slots(*args[:5], d, max_map_slots=40, max_reduce_slots=40)
        assert repr(dataclasses.asdict(a)) == repr(dataclasses.asdict(b))
    assert pest.SlotDemand is ttypes.SlotDemand
    assert math.isnan(pest.SlotDemand(1, 1, True).n_m_cont)


# ---------------------------------------------------------------------------
# the registry's builders (the frozen seed engine's too), the scenarios
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", POLICIES)
def test_built_schedulers_are_the_original_classes(policy):
    cluster_j = jtypes.ClusterSpec(num_machines=4, vms_per_machine=2)
    cluster_t = ttypes.ClusterSpec(num_machines=4, vms_per_machine=2)
    a = jpol.PolicySpec(policy).build(cluster_j)
    b = tpol.PolicySpec(policy).build(cluster_t)
    assert type(a).__name__ == type(b).__name__
    assert type(b).__module__.startswith("repro_torch.")
    assert (a.name, a.uses_reconfig) == (b.name, b.uses_reconfig)
    assert b.policy == tpol.PolicySpec(policy)
    for attr in ("park_depth", "overload_policy", "parking", "harvest", "locality_delay"):
        assert getattr(a, attr, None) == getattr(b, attr, None), attr
    assert b.spec.to_dict() == a.spec.to_dict()


@pytest.mark.parametrize("policy", POLICIES)
def test_legacy_builders_are_the_original_classes(policy):
    """``build(legacy=True)`` builds the frozen seed engine's counterpart of
    proposed, fair, fifo and delay (the port's own ``Legacy*`` classes, the
    original's names and knobs) and refuses every other policy with the
    original's message."""
    cluster_j = jtypes.ClusterSpec(num_machines=4, vms_per_machine=2)
    cluster_t = ttypes.ClusterSpec(num_machines=4, vms_per_machine=2)
    if jpol.get_policy(policy).legacy_builder is None:
        assert tpol.get_policy(policy).legacy_builder is None
        msgs = []
        for pol, cluster in ((jpol, cluster_j), (tpol, cluster_t)):
            with pytest.raises(pol.PolicyError) as e:
                pol.PolicySpec(policy).build(cluster, legacy=True)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1] == \
            f"policy {policy!r} has no legacy (seed-engine) counterpart"
        return
    assert policy in ("proposed", "fair", "fifo", "delay")
    a = jpol.PolicySpec(policy).build(cluster_j, legacy=True)
    b = tpol.build_policy(policy, cluster_t, legacy=True)
    assert type(b).__name__ == type(a).__name__ and type(b).__name__.startswith("Legacy")
    assert type(b).__module__ == "repro_torch.simcluster._legacy"
    assert b.name == a.name == policy
    for attr in ("park_depth", "locality_delay", "uses_reconfig"):
        assert getattr(a, attr, None) == getattr(b, attr, None), attr
    if policy == "proposed":
        assert b.reconfig.max_wait == a.reconfig.max_wait == 30.0


def test_smoke_policies_run_clean():
    assert tpol.smoke_test_policies() == [] == jpol.smoke_test_policies()


@pytest.mark.parametrize("name", list(jlarge.SCENARIOS))
def test_scenarios_and_fleet_shapes_equal_the_original(name):
    assert list(tlarge.SCENARIOS) == list(jlarge.SCENARIOS)
    assert tlarge.FLEET_SHAPES == jlarge.FLEET_SHAPES
    for shape in tlarge.FLEET_SHAPES:
        assert tlarge.fleet_shape(shape, replication=3).to_dict() == \
            jlarge.fleet_shape(shape, replication=3).to_dict()
    sc, t = jlarge.SCENARIOS[name], tlarge.SCENARIOS[name]
    assert t.cluster().to_dict() == sc.cluster().to_dict()
    assert [j.to_dict() for j in t.jobs(t.cluster(), seed=1)] == \
        [j.to_dict() for j in sc.jobs(sc.cluster(), seed=1)]


def test_small_scenario_runs_equal():
    a = jlarge.run_scenario("burst_idle_gap", scheduler="proposed", seed=4)
    b = tlarge.run_scenario("burst_idle_gap", scheduler="proposed", seed=4)
    assert (b.makespan, b.events_processed, b.deadlines_met(), b.locality_rate()) == \
        (a.makespan, a.events_processed, a.deadlines_met(), a.locality_rate())
    assert {j: rt.finish_time for j, rt in b.jobs.items()} == \
        {j: rt.finish_time for j, rt in a.jobs.items()}
