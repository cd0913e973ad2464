#!/usr/bin/env python3
"""The port's two event engines timed side by side, on the host.

Runs large-fleet scenarios of ``repro_torch.simcluster.largescale`` on the
indexed engine (``simcluster.sim``) and, where the frozen seed engine
(``simcluster._legacy``) can run them at all, on that one too, and reports
per scenario the wall time, events and events/s of each engine, and
``parity``: true when both engines ran and agree on every decision (the
makespan, the event count, and each job's finish time, launch split and task
durations), null when only the indexed engine ran (``legacy_skipped`` says
why: the seed engine's heartbeats die once the cluster drains, so jobs after
an idle gap never run there; it has neither fault injection nor a serving
layer).  Pure Python: no card is used.

Modes:

* ``--quick`` — the paper cluster (20 machines x 2 VMs, Table 2's five jobs;
  both engines, best of 5) and the sustained 100-machine, 150-job fleet
  (both engines, once), plus the smoke, churn and serving fleets on the
  indexed engine;
* default — the same and the larger indexed-only fleets (up to 400 x 2 and
  500 jobs) and the idle-gap scenario.

Usage::

    PYTHONPATH=src python3 scripts/bench_torch_sim.py [--quick] [--seed N] [--out PATH]

The JSON goes to ``build/bench_torch_sim.json`` unless ``--out`` says
otherwise.  ``chip_smoke.py`` calls :func:`bench` in its ``experiments``
phase.
"""
from __future__ import annotations

import argparse
import json
import os
import platform
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
DEFAULT_OUT = ROOT / "build" / "bench_torch_sim.json"

# (scenario, engines, repeats): the best wall time of `repeats` runs counts
QUICK = (("paper_20x2", ("indexed", "legacy"), 5),
         ("fleet_100x2_sustained", ("indexed", "legacy"), 1),
         ("smoke_40x2", ("indexed",), 1),
         ("fleet_100x2_churn", ("indexed",), 1),
         ("fleet_100x2_serving", ("indexed",), 1))
FULL = QUICK + (("fleet_100x2", ("indexed",), 1),
                ("fleet_200x2", ("indexed",), 1),
                ("fleet_200x4", ("indexed",), 1),
                ("fleet_400x2", ("indexed",), 1),
                ("burst_idle_gap", ("indexed",), 1))
_IDLE_GAPS = ("idle gaps between bursts: the seed engine's heartbeats die when "
              "the cluster drains and later jobs never run")
LEGACY_SKIPPED = {
    **{name: _IDLE_GAPS for name in ("smoke_40x2", "fleet_100x2", "fleet_200x2",
                                     "fleet_200x4", "fleet_400x2", "burst_idle_gap")},
    "fleet_100x2_churn": "the seed engine has no fault injection",
    "fleet_100x2_serving": "the seed engine has no serving layer",
}
PAPER_SEED = 3              # benchmarks/bench_sim.py's paper-cluster seed


def _paper_run(engine: str, seed: int):
    from repro_torch.core.policies import PolicySpec
    from repro_torch.simcluster._legacy import LegacyClusterSim
    from repro_torch.simcluster.sim import ClusterSim
    from repro_torch.simcluster.workloads import paper_cluster, paper_table2_jobs
    spec = paper_cluster()
    sched = PolicySpec("proposed").build(spec, legacy=engine == "legacy")
    sim = (LegacyClusterSim if engine == "legacy" else ClusterSim)(spec, sched, seed=seed)
    jobs = paper_table2_jobs(spec, seed=seed)
    t0 = time.perf_counter()
    res = sim.run(jobs)
    return res, time.perf_counter() - t0


def _scenario_run(name: str, engine: str, seed: int):
    from repro_torch.simcluster.largescale import run_scenario
    t0 = time.perf_counter()
    res = run_scenario(name, engine=engine, seed=seed)
    return res, time.perf_counter() - t0


def decisions(res) -> str:
    """Every decision the parity contract pins, as canonical JSON."""
    return json.dumps({
        "makespan": res.makespan, "events": res.events_processed,
        "speculative": res.speculative_launches,
        "reconfig": {k: res.reconfig_stats.get(k)
                     for k in ("reconfigurations", "parked", "expired")},
        "jobs": {j: [rt.finish_time, rt.local_map_launches, rt.remote_map_launches,
                     rt.reconfig_map_launches, rt.map_durations, rt.reduce_durations]
                 for j, rt in sorted(res.jobs.items())}}, sort_keys=True)


def _summary(res, walls) -> dict:
    wall = min(walls)
    return {"wall_time_s": wall, "walls_s": walls, "events": res.events_processed,
            "events_per_sec": res.events_processed / wall if wall else None,
            "sim_makespan_s": res.makespan,
            "jobs_finished": sum(1 for j in res.jobs.values() if j.finish_time is not None),
            "jobs_total": len(res.jobs), "deadlines_met": res.deadlines_met(),
            "locality_rate": res.locality_rate(),
            "speculative_launches": res.speculative_launches}


def bench_scenario(name: str, engines, repeats: int, seed: int) -> dict:
    out: dict = {}
    digests = {}
    for engine in engines:
        walls, res = [], None
        for _ in range(repeats):
            if name == "paper_20x2":
                res, wall = _paper_run(engine, PAPER_SEED)
            else:
                res, wall = _scenario_run(name, engine, seed)
            walls.append(wall)
        out[engine] = _summary(res, walls)
        digests[engine] = decisions(res)
    if "legacy" in digests:
        out["parity"] = digests["legacy"] == digests["indexed"]
        out["speedup"] = out["legacy"]["wall_time_s"] / out["indexed"]["wall_time_s"]
    else:
        out["parity"] = None
        out["legacy_skipped"] = LEGACY_SKIPPED[name]
    return out


def bench(quick: bool = True, seed: int = 0, progress=print) -> dict:
    """Run the chosen scenarios; return the report (``scenarios`` keyed by
    name, each with its engines' numbers and ``parity``)."""
    t0 = time.perf_counter()
    report = {"mode": "quick" if quick else "full", "seed": seed,
              "paper_seed": PAPER_SEED, "python": platform.python_version(),
              "cpu_count": os.cpu_count(), "scenarios": {}}
    for name, engines, repeats in (QUICK if quick else FULL):
        if progress:
            progress(f"[bench_torch_sim] {name} ({' + '.join(engines)}) ...")
        report["scenarios"][name] = bench_scenario(name, engines, repeats, seed)
    report["total_wall_time_s"] = time.perf_counter() - t0
    return report


def format_report(report: dict) -> str:
    lines = []
    for name, r in report["scenarios"].items():
        line = (f"  {name}: indexed {r['indexed']['events']} events, "
                f"{r['indexed']['wall_time_s']:.4f} s, "
                f"{r['indexed']['events_per_sec']:.0f} ev/s")
        if r["parity"] is None:
            line += "; legacy not run"
        else:
            line += (f"; legacy {r['legacy']['wall_time_s']:.4f} s, "
                     f"{r['legacy']['events_per_sec']:.0f} ev/s, "
                     f"speedup {r['speedup']:.2f}x, parity={r['parity']}")
        lines.append(line)
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="the paper cluster and the sustained fleet on both "
                         "engines, three fleets on the indexed one")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    report = bench(quick=args.quick, seed=args.seed)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(report, indent=2) + "\n")
    print(f"[bench_torch_sim] wrote {args.out}")
    print(format_report(report))
    broken = [n for n, r in report["scenarios"].items() if r["parity"] is False]
    if broken:
        print(f"[bench_torch_sim] parity broken: {', '.join(broken)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))
    raise SystemExit(main())
