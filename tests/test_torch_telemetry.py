"""The port's decision-trace telemetry (``repro_torch.experiments.telemetry``)
and the bus it folds, on the CPU.

The first half holds the port's exports to the JAX package's on the same
traced cell: the folded summary, the canonical JSONL, the Chrome trace, the
summary stored beside the cell's record and the ``explain`` text are byte for
byte the original's (the record's wall-clock ``wall_time_s`` aside: every
other time in them is simulated).  The second half is ``tests/test_tracing.py``
and the telemetry part of ``tests/test_serving.py`` on the port alone.
"""
import dataclasses
import json
import random

import pytest

import repro.core.policies as jpol
import repro.core.types as jtypes
import repro.experiments.runner as jrunner
import repro.experiments.telemetry as jtel
import repro.simcluster.largescale as jlarge
import repro_torch.core.policies as tpol
import repro_torch.core.types as ttypes
import repro_torch.experiments.runner as trunner
import repro_torch.experiments.telemetry as ttel
import repro_torch.simcluster.largescale as tlarge
from repro_torch.core.policies import PolicySpec, build_policy
from repro_torch.core.tracing import (EVENT_KINDS, LATCH_RELEASE_CAUSES,
                                      PARK_GATES, FaultEvent, dumps_canonical)
from repro_torch.core.types import (ClusterSpec, FaultConfig, ServeConfig,
                                    ServiceSpec, TraceConfig)
from repro_torch.simcluster.largescale import run_scenario
from repro_torch.simcluster.sim import ClusterSim
from repro_torch.simcluster.workloads import (default_deadline, make_job,
                                              paper_cluster, paper_table2_jobs)

JAX = dict(types=jtypes, pol=jpol, runner=jrunner, tel=jtel, large=jlarge)
PORT = dict(types=ttypes, pol=tpol, runner=trunner, tel=ttel, large=tlarge)


# ---------------------------------------------------------------------------
# the exports, byte for byte
# ---------------------------------------------------------------------------

def _traced_cell(m, preset, machines, policy, seed, *, faults=None, serve=None):
    T = m["types"]
    cluster = T.ClusterSpec(num_machines=machines, vms_per_machine=2,
                            faults=faults if faults is not None else T.FaultConfig(),
                            serve=serve if serve is not None else T.ServeConfig())
    return m["runner"].Cell(trace=m["runner"].TraceRef(preset=preset), cluster=cluster,
                            scheduler=m["pol"].PolicySpec.parse(policy), seed=seed,
                            straggler_prob=0.05, straggler_factor=3.0,
                            speculative=True, speculation_threshold=2.0)


def _exports(m, tmp, cell):
    """Everything telemetry writes for one traced cell, as bytes."""
    tel = m["tel"]
    record, bus = tel.simulate_cell_traced(
        cell, m["types"].TraceConfig(enabled=True, pressure_every=20.0))
    rec = record.to_dict()
    assert rec.pop("wall_time_s") >= 0.0
    summary = tel.fold_trace(bus, record.makespan)
    stored = tel.store_trace_summary(tmp / "cache", cell, summary)
    return {
        "record": json.dumps(rec, sort_keys=True),
        "summary": dumps_canonical(summary.to_dict()),
        "derived": repr((summary.locality_rate(), summary.latch_residency(),
                         summary.latch_residency_frac(), summary.total_park_wins(),
                         summary.total_harvest_borrows(), summary.total_harvest_returns())),
        "jsonl": tel.write_jsonl(bus, tmp / "t.jsonl").read_bytes(),
        "chrome": tel.write_chrome_trace(bus, tmp / "t.chrome.json").read_bytes(),
        "stored": stored.read_bytes(),
        "stored_at": stored.relative_to(tmp).as_posix(),
        "text": tel.format_summary(cell.scheduler.label, record, summary),
    }


def _churn(m):
    return m["types"].FaultConfig(enabled=True, crash_mtbf=300.0, crash_mttr=60.0,
                                  rereplicate_after=30.0)


def _svc(m):
    T = m["types"]
    return T.ServeConfig(enabled=True, services=(T.ServiceSpec(
        name="api", replicas=3, vcpus=2, base_rps=15.0, diurnal_amplitude=0.3,
        slo_p99_ms=400.0),))


@pytest.mark.parametrize("case", ["adaptive", "proposed-churn", "harvest-serve", "fair"])
def test_exports_are_byte_equal(case, tmp_path):
    policy = case.split("-")[0]
    out = []
    for name, m in (("jax", JAX), ("port", PORT)):
        kw = {}
        if case.endswith("churn"):
            kw["faults"] = _churn(m)
        if case.endswith("serve"):
            kw["serve"] = _svc(m)
        cell = _traced_cell(m, "mix_small", 8, policy, 1, **kw)
        (tmp_path / name).mkdir()
        out.append(_exports(m, tmp_path / name, cell))
    a, b = out
    assert list(a) == list(b)
    for key in a:
        assert a[key] == b[key], key
    doc = json.loads(b["chrome"])
    assert any(e["ph"] == "X" for e in doc["traceEvents"])
    if case.endswith("churn"):
        assert json.loads(b["summary"])["machine_crashes"]
    if case.endswith("serve"):
        assert json.loads(b["summary"])["serve_ticks"] > 0


def _explain(m, tmp, **kw):
    text, pol, base = m["tel"].explain_cell(cache_dir=tmp / "cache",
                                            export_dir=tmp / "export", **kw)
    files = {p.relative_to(tmp).as_posix(): p.read_bytes()
             for p in sorted(tmp.rglob("*")) if p.is_file()}
    return (text.replace(str(tmp), "<tmp>"), dumps_canonical(pol.to_dict()),
            dumps_canonical(base.to_dict()), files)


@pytest.mark.parametrize("kw", [
    dict(preset="saturated", shape="20x2"),
    dict(preset="heavy_tail", shape="20x2", policy="adaptive_ra", baseline="fair",
         seed=1, faults="churn_lo"),
    dict(preset="bursty", shape="20x2", policy='{"name": "delay", "params": '
         '{"locality_delay": 4}}', fabric="10GbE", replication=2),
], ids=["saturated", "heavy_tail-churn", "bursty-inline-policy"])
def test_explain_cell_is_byte_equal(kw, tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    a = _explain(JAX, tmp_path / "jax", **kw)
    b = _explain(PORT, tmp_path / "port", **kw)
    assert a[0] == b[0] and a[1] == b[1] and a[2] == b[2]
    assert list(a[3]) == list(b[3])
    for path in a[3]:
        assert a[3][path] == b[3][path], path
    assert any(p.endswith(".trace.json") for p in b[3])       # stored
    assert sum(p.endswith(".chrome.json") for p in b[3]) == 2   # exported


def test_run_scenario_traced_exports_are_byte_equal(tmp_path):
    out = []
    for m in (JAX, PORT):
        res = m["large"].run_scenario("smoke_40x2", scheduler="adaptive", seed=0,
                                      tracing=m["types"].TraceConfig(enabled=True,
                                                                     pressure_every=30.0))
        d = tmp_path / m["tel"].__name__
        out.append((m["tel"].write_jsonl(res.trace, d / "t.jsonl").read_bytes(),
                    m["tel"].write_chrome_trace(res.trace, d / "t.chrome.json").read_bytes(),
                    dumps_canonical(m["tel"].fold_trace(res.trace, res.makespan).to_dict())))
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# tests/test_tracing.py on the port
# ---------------------------------------------------------------------------

TRACE_ON = TraceConfig(enabled=True, pressure_every=5.0)
CHURN = FaultConfig(enabled=True, crash_mtbf=300.0, crash_mttr=60.0, rereplicate_after=30.0)


def _spec(machines=6, vms=2, replication=1, tracing=TraceConfig(), faults=FaultConfig()):
    return ClusterSpec(num_machines=machines, vms_per_machine=vms,
                       replication=replication, tracing=tracing, faults=faults)


def _jobs(spec, n=8, seed=0, stagger=10.0):
    rng = random.Random(seed)
    jobs = []
    for i in range(n):
        w = ["wordcount", "grep", "sort"][i % 3]
        gb = 0.5 + 0.5 * (i % 4)
        jobs.append(make_job(f"{w}-{i}", w, gb, default_deadline(w, gb),
                             spec, rng, submit_time=stagger * i))
    return jobs


def _run(spec, policy="proposed", seed=0, jobs=None):
    sim = ClusterSim(spec, PolicySpec(policy).build(spec), seed=seed)
    return sim, sim.run(jobs if jobs is not None else _jobs(spec))


def test_trace_config_validation_and_roundtrip():
    assert TraceConfig().enabled is False
    with pytest.raises(ValueError):
        TraceConfig(pressure_every=-1.0)
    with pytest.raises(ValueError):
        TraceConfig(max_events=-1)
    assert TraceConfig.from_dict(TRACE_ON.to_dict()) == TRACE_ON


def test_tracing_always_omitted_from_spec_dict():
    assert "tracing" not in ClusterSpec(num_machines=4, vms_per_machine=2).to_dict()
    assert "tracing" not in _spec(tracing=TRACE_ON).to_dict()
    d = _spec().to_dict()
    d["tracing"] = TRACE_ON.to_dict()
    assert ClusterSpec.from_dict(d).tracing == TRACE_ON


def test_no_bus_attached_while_disabled():
    sim, res = _run(_spec())
    assert sim.trace is None and res.trace is None


@pytest.mark.parametrize("policy", ["proposed", "adaptive", "fair"])
def test_traced_run_is_bit_exact(policy):
    base = _spec()
    _, res_off = _run(base, policy=policy, seed=3)
    _, res_on = _run(_spec(tracing=TRACE_ON), policy=policy, seed=3, jobs=_jobs(base))
    assert res_on.trace is not None and res_on.trace.total > 0
    assert res_on.makespan == res_off.makespan
    assert res_on.locality_rate() == res_off.locality_rate()
    assert res_on.speculative_launches == res_off.speculative_launches
    assert {j: r.finish_time for j, r in res_on.jobs.items()} == \
        {j: r.finish_time for j, r in res_off.jobs.items()}


def test_traced_churn_run_is_byte_reproducible():
    spec = _spec(tracing=TRACE_ON, faults=CHURN)
    sim_a, res_a = _run(spec, policy="adaptive", seed=7)
    sim_b, res_b = _run(spec, policy="adaptive", seed=7)
    assert sim_a.fault_stats["crashes"] > 0
    assert sim_a.fault_log == sim_b.fault_log
    assert res_a.trace.to_jsonl() == res_b.trace.to_jsonl()


def test_fault_event_is_byte_compatible_with_tuples():
    ev = FaultEvent(12.5, "crash", 3)
    assert json.dumps([ev]) == json.dumps([(12.5, "crash", 3)])
    assert ev == (12.5, "crash", 3)
    t, kind, machine = ev
    assert (t, kind, machine) == (12.5, "crash", 3)
    assert ev.time == 12.5 and ev.kind == "crash" and ev.machine == 3
    sim, _ = _run(_spec(faults=CHURN), seed=7)
    assert sim.fault_stats["crashes"] > 0
    assert all(isinstance(e, FaultEvent) for e in sim.fault_log)
    assert json.dumps(sim.fault_log) == json.dumps([tuple(e) for e in sim.fault_log])


def test_fault_bus_events_match_fault_log():
    sim, res = _run(_spec(tracing=TRACE_ON, faults=CHURN), policy="adaptive", seed=7)
    for kind in ("crash", "restart", "rereplicate"):
        assert res.trace.count(kind) == sum(1 for e in sim.fault_log if e.kind == kind)


def test_emitted_kinds_are_registered():
    _, res = _run(_spec(tracing=TRACE_ON, faults=CHURN), policy="adaptive", seed=7)
    registered = {k for kinds in EVENT_KINDS.values() for k in kinds}
    assert set(res.trace.counts) <= registered


def test_park_deny_gates_are_named():
    gates = set()
    for policy in ("proposed", "adaptive"):
        _, res = _run(_spec(tracing=TRACE_ON), policy=policy, seed=3,
                      jobs=_jobs(_spec(), n=12, stagger=2.0))
        gates |= {d["gate"] for _, k, d in res.trace.events if k == "park_deny"}
    assert gates and gates <= set(PARK_GATES)
    assert len(gates) >= 2


def test_latch_trip_and_release_events():
    spec = _spec(machines=4, tracing=TRACE_ON)
    jobs = _jobs(spec, n=12, stagger=0.5)
    jobs += [make_job("late-0", "grep", 0.5, default_deadline("grep", 0.5), spec,
                      random.Random(99), submit_time=20_000.0)]
    _, res = _run(spec, policy="adaptive", seed=1, jobs=jobs)
    bus = res.trace
    assert bus.count("latch_trip") > 0
    for d in (d for _, k, d in bus.events if k == "latch_trip"):
        assert d["pending_maps"] >= d["pending_bar"]
        assert d["crowd"] >= d["crowd_bar"]
    releases = [d for _, k, d in bus.events if k == "latch_release"]
    assert releases and all(d["cause"] in LATCH_RELEASE_CAUSES for d in releases)


def test_category_switches_gate_emission():
    spec = _spec(tracing=TraceConfig(enabled=True, launches=False))
    _, res = _run(spec, policy="adaptive", seed=3, jobs=_jobs(spec))
    for kind in EVENT_KINDS["launches"]:
        assert res.trace.count(kind) == 0
    assert any(res.trace.count(k) for k in EVENT_KINDS["parks"])


def test_max_events_cap_bounds_memory_not_counts():
    spec = _spec(tracing=TraceConfig(enabled=True, max_events=25))
    _, res = _run(spec, policy="adaptive", seed=3, jobs=_jobs(spec))
    bus = res.trace
    assert len(bus.events) == 25 and bus.dropped > 0
    assert bus.total == len(bus.events) + bus.dropped
    assert sum(bus.counts.values()) == bus.total


def test_run_scenario_tracing_hook(tmp_path):
    res = run_scenario("smoke_40x2", scheduler="adaptive", seed=0,
                       tracing=TraceConfig(enabled=True, pressure_every=30.0))
    bus = res.trace
    assert bus is not None and bus.count("launch") > 0 and bus.count("pressure") > 0
    untraced = run_scenario("smoke_40x2", scheduler="adaptive", seed=0)
    assert untraced.trace is None and untraced.makespan == res.makespan
    with pytest.raises(ValueError, match="indexed engine"):
        run_scenario("smoke_40x2", engine="legacy", tracing=True)
    lines = ttel.write_jsonl(bus, tmp_path / "t.jsonl").read_text().splitlines()
    assert len(lines) == len(bus.events)
    rec = json.loads(lines[0])
    assert "t" in rec and "kind" in rec and lines[0] == dumps_canonical(rec)
    doc = json.loads(ttel.write_chrome_trace(bus, tmp_path / "t.chrome.json").read_text())
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert xs and all({"pid", "tid", "ts", "dur"} <= set(e) for e in xs)
    assert any(e["ph"] == "C" for e in doc["traceEvents"])
    summary = ttel.fold_trace(bus, res.makespan)
    assert summary.maps_local + summary.maps_remote == \
        bus.count("launch") - summary.reduces - summary.speculative
    assert summary.locality_rate() == pytest.approx(res.locality_rate())


def _cell(seed=0):
    return trunner.Cell(trace=trunner.TraceRef(preset="mix_small"),
                        cluster=ClusterSpec(num_machines=8, vms_per_machine=2),
                        scheduler=PolicySpec("adaptive"), seed=seed,
                        straggler_prob=0.05, straggler_factor=3.0,
                        speculative=True, speculation_threshold=2.0)


def test_simulate_cell_traced_reproduces_the_cached_record(tmp_path):
    cell = _cell()
    plain = trunner.simulate_cell(cell)
    record, bus = ttel.simulate_cell_traced(cell)
    assert record.makespan == plain["makespan"]
    assert record.locality_rate == plain["locality_rate"]
    assert record.cluster == plain["cluster"]
    summary = ttel.fold_trace(bus, record.makespan)
    path = ttel.store_trace_summary(tmp_path, cell, summary)
    cell_dir, _ = trunner._cell_paths(tmp_path, cell)
    assert path == cell_dir / f"seed{cell.seed}.trace.json"
    loaded = json.loads(path.read_text())
    assert loaded["counts"] == dict(bus.counts)
    assert loaded["locality_rate"] == pytest.approx(record.locality_rate)


def test_explain_cell_attributes_decisions(tmp_path):
    text, pol, _ = ttel.explain_cell("saturated", "20x2", cache_dir=tmp_path,
                                     export_dir=tmp_path / "export")
    assert "attribution:" in text and "latch" in text
    assert pol.park_admits + sum(pol.park_denies.values()) > 0
    assert any((tmp_path / "export").glob("*.chrome.json"))


# ---------------------------------------------------------------------------
# the telemetry part of tests/test_serving.py on the port
# ---------------------------------------------------------------------------

def test_telemetry_folds_harvest_and_service_timeline():
    from repro_torch.experiments.metrics import run_record_from_result
    from repro_torch.simcluster.traces import Trace

    spec = dataclasses.replace(paper_cluster(), serve=ServeConfig(enabled=True, services=(
        ServiceSpec(name="api", replicas=6, vcpus=2, base_rps=15.0,
                    diurnal_amplitude=0.3, slo_p99_ms=400.0),)))
    spec = dataclasses.replace(spec, tracing=TraceConfig(enabled=True))
    res = ClusterSim(spec, build_policy("harvest", spec), seed=3).run(
        paper_table2_jobs(spec, seed=3))
    summary = ttel.fold_trace(res.trace, res.makespan)
    assert summary.serve_ticks == res.trace.count("serve_tick")
    assert summary.total_harvest_borrows() == res.serve_stats["harvest_borrows"]
    assert summary.total_harvest_returns() == res.serve_stats["harvest_returns"]
    slo = summary.service_slo["api"]
    assert "api" in summary.service_timeline
    assert 0.0 <= slo["residency"] <= 1.0 and slo["ticks"] >= slo["ok_ticks"] > 0
    record = run_record_from_result(res, trace=Trace(name="paper", seed=3, jobs=[]),
                                    cluster_dict=spec.to_dict(), scheduler="harvest",
                                    seed=3, wall_time_s=0.0)
    text = ttel.format_summary("harvest", record, summary)
    assert "serve:" in text and "SLO residency" in text and "borrows" in text
