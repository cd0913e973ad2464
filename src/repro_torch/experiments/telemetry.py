"""Trace telemetry: fold a decision-trace bus into warehouse metrics,
export it (canonical JSONL + Chrome ``trace_event`` JSON for Perfetto),
and power the ``explain`` CLI verb.

The sink side of ``repro_torch.core.tracing``: the engine emits raw records;
this module turns them into the quantities the atlas narrative argues
with — locality split, park win/loss by cause, park-denial attribution by
Algorithm-1 gate, overload-latch residency, remote-transfer cost — and
stores the folded summary next to the cell's ``RunRecord`` in the sweep
warehouse (``<cache>/<cell_hash>/seed<k>.trace.json``).  Tracing never
enters the cell descriptor (``ClusterSpec.to_dict`` drops it), so a traced
replay hashes onto the same cache cell it explains.

This is the port's own copy of the JAX package's ``experiments/telemetry.py``
(pure Python on the host): a test holds its folded summaries, JSONL and
Chrome exports, stored summaries and ``explain`` text byte-equal to the
original's, the record's wall-clock ``wall_time_s`` aside.
"""
from __future__ import annotations

import dataclasses
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

from repro_torch.core.tracing import TraceBus, dumps_canonical
from repro_torch.core.types import TraceConfig
from repro_torch.experiments.metrics import RunRecord, run_record_from_result
from repro_torch.experiments.runner import Cell, _cell_paths
from repro_torch.simcluster.sim import ClusterSim

# park-wait histogram bucket upper bounds (seconds); the last bucket is
# open-ended
WAIT_BUCKETS: Tuple[float, ...] = (0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 60.0)


@dataclass
class LatchEpisode:
    """One overload-latch residency interval.  ``released_at`` is None when
    the latch never released (it held to the end of the run)."""

    tripped_at: float
    released_at: Optional[float]
    release_cause: Optional[str]
    trip_signals: Dict[str, object] = field(default_factory=dict)

    def residency(self, makespan: float) -> float:
        end = self.released_at if self.released_at is not None else makespan
        return max(0.0, end - self.tripped_at)


@dataclass
class TraceSummary:
    """A ``TraceBus`` folded into per-run decision metrics."""

    makespan: float
    counts: Dict[str, int]               # records emitted, by kind
    dropped: int                         # past TraceConfig.max_events
    # -- locality / launches ------------------------------------------------
    maps_local: int = 0                  # non-speculative map launches
    maps_remote: int = 0
    maps_via_reconfig: int = 0           # unplugged-core launches (subset)
    reduces: int = 0
    speculative: int = 0
    kills: Dict[str, int] = field(default_factory=dict)      # by cause
    # -- remote-transfer cost ----------------------------------------------
    local_map_seconds: float = 0.0       # finished non-spec map runtimes
    remote_map_seconds: float = 0.0
    # -- park funnel --------------------------------------------------------
    park_admits: int = 0
    park_denies: Dict[str, int] = field(default_factory=dict)  # by gate
    park_wins: Dict[str, int] = field(default_factory=dict)    # by cause
    park_losses: int = 0
    park_expired: int = 0
    park_crashed: int = 0
    # histogram of realized park waits (donor matches + expiries), bucketed
    # by WAIT_BUCKETS; the final bucket is > the last bound
    park_wait_hist: List[int] = field(
        default_factory=lambda: [0] * (len(WAIT_BUCKETS) + 1))
    # -- overload latch -----------------------------------------------------
    latch_episodes: List[LatchEpisode] = field(default_factory=list)
    # -- per-machine / per-job timelines ------------------------------------
    machine_launches: Dict[int, int] = field(default_factory=dict)
    machine_crashes: Dict[int, int] = field(default_factory=dict)
    job_maps: Dict[str, Dict[str, int]] = field(default_factory=dict)
    # -- serving / harvest --------------------------------------------------
    serve_ticks: int = 0
    harvest_borrows: Dict[str, int] = field(default_factory=dict)   # by signal
    harvest_returns: Dict[str, int] = field(default_factory=dict)   # by signal
    # per-service latency timeline [t, p99_ms] (one point per replica tick)
    service_timeline: Dict[str, List[List[float]]] = field(
        default_factory=dict)
    # per-service SLO residency: fraction of replica ticks whose p99 held
    # under the service's SLO ({"ticks", "ok_ticks", "residency"})
    service_slo: Dict[str, Dict[str, float]] = field(default_factory=dict)

    # -- derived ------------------------------------------------------------
    def locality_rate(self) -> float:
        tot = self.maps_local + self.maps_remote
        return self.maps_local / tot if tot else 0.0

    def latch_residency(self) -> float:
        return sum(e.residency(self.makespan) for e in self.latch_episodes)

    def latch_residency_frac(self) -> float:
        if self.makespan <= 0:
            return 0.0
        return self.latch_residency() / self.makespan

    def total_park_wins(self) -> int:
        return sum(self.park_wins.values())

    def total_harvest_borrows(self) -> int:
        return sum(self.harvest_borrows.values())

    def total_harvest_returns(self) -> int:
        return sum(self.harvest_returns.values())

    def to_dict(self) -> Dict[str, object]:
        d = dict(self.__dict__)
        d["latch_episodes"] = [
            {"tripped_at": e.tripped_at, "released_at": e.released_at,
             "release_cause": e.release_cause,
             "trip_signals": e.trip_signals}
            for e in self.latch_episodes]
        # JSON object keys are strings; keep machine maps sortable
        d["machine_launches"] = {str(k): v
                                 for k, v in self.machine_launches.items()}
        d["machine_crashes"] = {str(k): v
                                for k, v in self.machine_crashes.items()}
        d["locality_rate"] = self.locality_rate()
        d["latch_residency"] = self.latch_residency()
        d["latch_residency_frac"] = self.latch_residency_frac()
        return d


def _bucket(hist: List[int], wait: float) -> None:
    for i, bound in enumerate(WAIT_BUCKETS):
        if wait <= bound:
            hist[i] += 1
            return
    hist[-1] += 1


def fold_trace(bus: TraceBus, makespan: float) -> TraceSummary:
    """Fold retained bus records into a :class:`TraceSummary`.

    Works from the retained event list, so a capped bus (``dropped > 0``)
    folds what survived — the per-kind ``counts`` still cover everything."""
    s = TraceSummary(makespan=makespan, counts=dict(bus.counts),
                     dropped=bus.dropped)
    open_latch: Optional[LatchEpisode] = None
    for t, kind, data in bus.events:
        if kind == "launch":
            if data.get("spec"):
                s.speculative += 1
            elif data["tkind"] == "map":
                if data["local"]:
                    s.maps_local += 1
                else:
                    s.maps_remote += 1
                if data.get("via_reconfig"):
                    s.maps_via_reconfig += 1
                jm = s.job_maps.setdefault(
                    data["job"], {"local": 0, "remote": 0})
                jm["local" if data["local"] else "remote"] += 1
            else:
                s.reduces += 1
            m = data.get("machine")
            if m is not None:
                s.machine_launches[m] = s.machine_launches.get(m, 0) + 1
        elif kind == "finish":
            if data["tkind"] == "map" and not data.get("spec"):
                if data["local"]:
                    s.local_map_seconds += data["duration"]
                else:
                    s.remote_map_seconds += data["duration"]
        elif kind == "kill":
            cause = data.get("cause", "unknown")
            s.kills[cause] = s.kills.get(cause, 0) + 1
        elif kind == "park_admit":
            s.park_admits += 1
        elif kind == "park_deny":
            gate = data.get("gate", "unknown")
            s.park_denies[gate] = s.park_denies.get(gate, 0) + 1
        elif kind == "park_outcome":
            if data["won"]:
                cause = data.get("cause", "unknown")
                s.park_wins[cause] = s.park_wins.get(cause, 0) + 1
            else:
                s.park_losses += 1
        elif kind == "reconfig_match":
            _bucket(s.park_wait_hist, data["wait"])
        elif kind == "park_expired":
            s.park_expired += 1
            _bucket(s.park_wait_hist, data["waited"])
        elif kind == "park_crashed":
            s.park_crashed += 1
        elif kind == "latch_trip":
            if open_latch is None:
                open_latch = LatchEpisode(t, None, None, dict(data))
                s.latch_episodes.append(open_latch)
        elif kind == "latch_release":
            if open_latch is not None:
                open_latch.released_at = t
                open_latch.release_cause = data.get("cause")
                open_latch = None
        elif kind == "crash":
            m = data["machine"]
            s.machine_crashes[m] = s.machine_crashes.get(m, 0) + 1
        elif kind == "serve_tick":
            s.serve_ticks += 1
            svc = data["service"]
            s.service_timeline.setdefault(svc, []).append(
                [t, data["p99_ms"]])
            slo = s.service_slo.setdefault(
                svc, {"ticks": 0, "ok_ticks": 0})
            slo["ticks"] += 1
            if data["p99_ms"] <= data["slo_p99_ms"]:
                slo["ok_ticks"] += 1
        elif kind == "harvest_borrow":
            sig = data.get("signal", "unknown")
            s.harvest_borrows[sig] = s.harvest_borrows.get(sig, 0) + 1
        elif kind == "harvest_return":
            sig = data.get("signal", "unknown")
            s.harvest_returns[sig] = s.harvest_returns.get(sig, 0) + 1
    for slo in s.service_slo.values():
        slo["residency"] = (slo["ok_ticks"] / slo["ticks"]
                            if slo["ticks"] else 1.0)
    return s


# -- exporters ---------------------------------------------------------------

def write_jsonl(bus: TraceBus, path: Union[str, Path]) -> Path:
    """Canonical JSONL: one sorted-key record per line, byte-stable per
    (config, seed) — the diffable/hashable artifact."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(bus.to_jsonl())
    return path


def chrome_trace_events(bus: TraceBus) -> List[Dict[str, object]]:
    """Chrome ``trace_event`` view of the bus (open the written file in
    Perfetto / chrome://tracing): task executions are complete ``X`` slices
    (pid = physical machine, tid = VM/node), park and latch decisions are
    instant events, and pressure snapshots are ``C`` counter tracks."""
    out: List[Dict[str, object]] = []
    us = 1e6                             # trace_event timestamps are µs
    # open launches by (task, speculative); finish/kill events close them
    open_runs: Dict[Tuple[str, bool], Dict[str, object]] = {}
    for t, kind, data in bus.events:
        if kind == "launch":
            open_runs[(data["task"], bool(data.get("spec")))] = {
                "t": t, "node": data["node"],
                "machine": data.get("machine", 0),
                "tkind": data["tkind"], "local": data["local"]}
        elif kind in ("finish", "kill"):
            key = (data["task"], bool(data.get("spec")))
            start = open_runs.pop(key, None)
            begin = start["t"] if start is not None else data.get("start", t)
            node = data["node"]
            machine = (start["machine"] if start is not None
                       else data.get("machine", 0))
            out.append({
                "name": str(data["task"]), "ph": "X",
                "cat": data["tkind"] + ("-killed" if kind == "kill" else ""),
                "pid": machine, "tid": node,
                "ts": begin * us, "dur": max(0.0, (t - begin)) * us,
                "args": {k: v for k, v in data.items()
                         if k not in ("task", "tkind", "node")},
            })
        elif kind == "serve_tick":
            out.append({
                "name": f"serve:{data['service']}", "ph": "C",
                "pid": data.get("machine", 0), "ts": t * us,
                "args": {"p99_ms": data["p99_ms"], "util": data["util"],
                         "cores": data["cores"]}})
        elif kind in ("park_admit", "park_deny", "unpark", "park_expired",
                      "park_crashed", "park_outcome", "reconfig_match",
                      "harvest_borrow", "harvest_return",
                      "crash", "restart", "burst", "rereplicate"):
            out.append({
                "name": (f"{kind}:{data['gate']}" if kind == "park_deny"
                         else kind),
                "ph": "i", "s": "p", "cat": "decision",
                "pid": data.get("machine", 0),
                "tid": data.get("node", data.get("target_vm", 0)),
                "ts": t * us, "args": dict(data),
            })
        elif kind in ("latch_trip", "latch_release"):
            out.append({"name": kind, "ph": "i", "s": "g", "cat": "overload",
                        "pid": 0, "tid": 0, "ts": t * us,
                        "args": dict(data)})
        elif kind == "pressure":
            out.append({"name": "pressure", "ph": "C", "pid": 0,
                        "ts": t * us,
                        "args": {"pending_maps": data["pending_maps"],
                                 "active_jobs": data["active_jobs"],
                                 "ready_reduces": data["ready_reduces"],
                                 "parked": data.get("parked", 0),
                                 "down_nodes": data["down_nodes"]}})
    return out


def write_chrome_trace(bus: TraceBus, path: Union[str, Path]) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    # args dicts carry raw TaskId objects off the bus; render them as the
    # same canonical strings the JSONL exporter uses
    path.write_text(json.dumps(
        {"traceEvents": chrome_trace_events(bus),
         "displayTimeUnit": "ms"}, default=str) + "\n")
    return path


# -- warehouse integration ---------------------------------------------------

def simulate_cell_traced(cell: Cell,
                         tracing: Optional[TraceConfig] = None
                         ) -> Tuple[RunRecord, TraceBus]:
    """Replay one sweep cell with the decision-trace bus attached.

    Identical inputs to ``runner.simulate_cell`` — same trace, placements,
    jitter draws — so the traced replay reproduces the cached run
    bit-exactly (tracing draws from no RNG); it just also returns the bus."""
    tracing = tracing or TraceConfig(enabled=True)
    spec = dataclasses.replace(cell.cluster, tracing=tracing)
    trace = cell.trace.resolve(cell.seed)
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
        result, trace=trace, cluster_dict=cell.cluster.to_dict(),
        scheduler=cell.scheduler.label, seed=cell.seed, wall_time_s=wall,
        policy=cell.scheduler.to_dict())
    return record, result.trace


def store_trace_summary(cache_dir: Union[str, Path], cell: Cell,
                        summary: TraceSummary) -> Path:
    """Write the folded summary next to the cell's ``RunRecord``:
    ``<cache>/<cell_hash>/seed<k>.trace.json``.  The cell hash is the
    *untraced* hash (tracing never enters the descriptor), so the summary
    sits beside the record it explains."""
    cell_dir, result_path = _cell_paths(Path(cache_dir), cell)
    cell_dir.mkdir(parents=True, exist_ok=True)
    path = cell_dir / (result_path.stem + ".trace.json")
    path.write_text(dumps_canonical(summary.to_dict()) + "\n")
    return path


# -- the `explain` verb ------------------------------------------------------

def _pct(part: int, whole: int) -> str:
    return f"{100.0 * part / whole:.0f}%" if whole else "n/a"


def format_summary(label: str, record: RunRecord,
                   summary: TraceSummary) -> str:
    """Human-readable decision-attribution block for one traced run."""
    lines = [f"{label}: makespan {record.makespan:.1f}s, "
             f"throughput {record.throughput_jph:.1f} jobs/h, "
             f"locality {summary.locality_rate() * 100:.1f}%, "
             f"deadlines {record.deadlines_met}/{record.jobs_total}"]
    # latch story
    eps = summary.latch_episodes
    if eps:
        e = eps[0]
        sig = e.trip_signals
        trip = (f"  latch: tripped at t={e.tripped_at:.1f} "
                f"(pending={sig.get('pending_maps')} >= "
                f"{sig.get('pending_bar', 0.0):.0f}, "
                f"crowd={sig.get('crowd')} >= "
                f"{sig.get('crowd_bar', 0.0):.0f})")
        if e.released_at is None:
            trip += ", released never"
        else:
            trip += (f", released at t={e.released_at:.1f} "
                     f"({e.release_cause})")
        if len(eps) > 1:
            trip += f" (+{len(eps) - 1} more episode(s))"
        trip += (f"; latched "
                 f"{summary.latch_residency_frac() * 100:.1f}% of the run")
        lines.append(trip)
    else:
        lines.append("  latch: never tripped")
    # park funnel
    denies = sum(summary.park_denies.values())
    lines.append(f"  parks: {summary.park_admits} admitted, "
                 f"{denies} denied, {summary.total_park_wins()} won "
                 f"({summary.park_losses} lost, "
                 f"{summary.park_expired} expired, "
                 f"{summary.park_crashed} crashed)")
    if summary.park_denies:
        top = sorted(summary.park_denies.items(),
                     key=lambda kv: (-kv[1], kv[0]))
        lines.append("  denied by gate: " + ", ".join(
            f"{g} {n} ({_pct(n, denies)})" for g, n in top))
    maps = summary.maps_local + summary.maps_remote
    lines.append(f"  maps: {summary.maps_local}/{maps} local "
                 f"({summary.maps_via_reconfig} via reconfig); "
                 f"remote map runtime {summary.remote_map_seconds:.0f}s "
                 f"vs local {summary.local_map_seconds:.0f}s")
    if summary.machine_crashes:
        lines.append(f"  faults: {sum(summary.machine_crashes.values())} "
                     f"crashes over {len(summary.machine_crashes)} machines")
    if summary.serve_ticks:
        res = ", ".join(
            f"{svc} {d['residency'] * 100:.1f}%"
            for svc, d in sorted(summary.service_slo.items()))
        line = (f"  serve: {summary.serve_ticks} replica ticks; "
                f"SLO residency {res}; harvest "
                f"{summary.total_harvest_borrows()} borrows / "
                f"{summary.total_harvest_returns()} returns")
        if summary.harvest_borrows or summary.harvest_returns:
            sigs = sorted(
                list(summary.harvest_borrows.items())
                + list(summary.harvest_returns.items()),
                key=lambda kv: (-kv[1], kv[0]))
            line += " (" + ", ".join(f"{k} {n}" for k, n in sigs) + ")"
        lines.append(line)
    return "\n".join(lines)


def explain_cell(preset: str, shape: str, *, policy: str = "adaptive",
                 baseline: str = "proposed", seed: int = 0,
                 fabric: str = "1GbE", replication: int = 1,
                 faults: str = "none",
                 cache_dir: Union[str, Path] = ".exp-cache",
                 store: bool = True,
                 export_dir: Optional[Union[str, Path]] = None
                 ) -> Tuple[str, TraceSummary, TraceSummary]:
    """Replay one atlas cell with tracing on and attribute its decisions.

    Runs ``policy`` and ``baseline`` on identical inputs (same trace seed,
    placements and jitter draws), folds both buses, stores the ``policy``
    summary next to the cell's warehouse record, and returns the formatted
    attribution text plus both summaries.  ``export_dir`` additionally
    writes the raw JSONL trace and the Chrome/Perfetto JSON there."""
    from repro_torch.experiments.regimes import regime_spec

    spec = regime_spec(preset, shape, (seed,), fabric=fabric,
                       replication=replication, faults=faults)
    cells = {c.scheduler.label: c for c in spec.cells()}
    if policy not in cells:
        # not an atlas column: build the cell from any registered policy
        base = next(iter(cells.values()))
        from repro_torch.core.policies import PolicySpec
        cells[policy] = dataclasses.replace(
            base, scheduler=PolicySpec.parse(policy))
    out_lines = [f"explain {preset}/{shape} fabric={fabric} "
                 f"r={replication} faults={faults} seed={seed}"]
    summaries: Dict[str, Tuple[RunRecord, TraceSummary]] = {}
    for label in (policy, baseline):
        record, bus = simulate_cell_traced(cells[label])
        summary = fold_trace(bus, record.makespan)
        summaries[label] = (record, summary)
        out_lines.append(format_summary(label, record, summary))
        if store:
            store_trace_summary(cache_dir, cells[label], summary)
        if export_dir is not None:
            stem = Path(export_dir) / f"{preset}-{shape}-{label}-s{seed}"
            write_jsonl(bus, stem.with_suffix(".trace.jsonl"))
            write_chrome_trace(bus, stem.with_suffix(".chrome.json"))
            out_lines.append(f"  exported {stem}.trace.jsonl + .chrome.json"
                             " (open the .chrome.json in Perfetto)")
    pol_sum = summaries[policy][1]
    base_sum = summaries[baseline][1]
    # attribution delta: what happened to the parks the baseline admitted?
    if base_sum.park_admits and pol_sum.park_denies:
        gate, n = max(pol_sum.park_denies.items(),
                      key=lambda kv: (kv[1], kv[0]))
        denies = sum(pol_sum.park_denies.values())
        out_lines.append(
            f"attribution: {baseline} admitted {base_sum.park_admits} parks "
            f"on these inputs; {policy} admitted {pol_sum.park_admits} and "
            f"denied {denies} — {_pct(n, denies)} of denials by the "
            f"`{gate}` gate")
    return "\n".join(out_lines), pol_sum, base_sum
