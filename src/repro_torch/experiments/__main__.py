"""CLI for the trace-driven experiment harness, as the port's own copy of
the JAX package's ``python -m repro.experiments`` verbs.

Subcommands::

    generate   synthesize a trace (preset or custom knobs) to a JSONL file
    import     convert a SWIM/Facebook-format cluster log to repro-trace/v1
    run        sweep a (trace x cluster x policy x seeds) grid, cached
    compare    run two policies on the same grid, paired-bootstrap stats
    surrogate  sweep a preset grid through the batched fluid engine on the
               card (calibrated cells only by default) and print per-policy
               estimates plus the calibration error vs paired oracle cells
    policies   list the registered scheduler policies (--smoke: run each
               on a tiny cluster and flag stranded work)

The event engine (``run``, ``compare``, ``policies --smoke`` and the
surrogate's oracle) is pure Python on the host; the fluid surrogate
integrates on the card, or on the CPU's plain version with ``--device
cpu``.  There is no fallback: ``surrogate`` without a card and without
``--device cpu`` exits non-zero.  Each verb prints what the original's
prints, line for line.  The original's ``regimes``, ``explain``,
``faults``, ``serve`` and ``paper`` verbs wait for ROADMAP's M10c.

Scheduler arguments accept either a registered policy name (``proposed``,
``adaptive``, ``adaptive_ra``, ``delay``, ``fair``, ``fifo``, ...) or an
inline policy JSON object, e.g. ``'{"name": "delay", "params":
{"locality_delay": 4}}'`` — see ``repro_torch.core.policies``.

Examples::

    PYTHONPATH=src python -m repro_torch.experiments generate --preset bursty \
        --seed 0 --out traces/bursty.jsonl
    PYTHONPATH=src python -m repro_torch.experiments import --log cluster.tsv \
        --out traces/cluster.jsonl
    PYTHONPATH=src python -m repro_torch.experiments run --trace traces/bursty.jsonl \
        --schedulers proposed fair --seeds 0:3 --machines 20 --vms 2
    PYTHONPATH=src python -m repro_torch.experiments compare --preset mix_small \
        --a proposed --b fair --seeds 0:5
    PYTHONPATH=src python -m repro_torch.experiments surrogate --shape 20x2 --seeds 0:8
    PYTHONPATH=src python -m repro_torch.experiments surrogate --device cpu heavy_tail
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path
from typing import List, Tuple

from repro_torch.core.policies import (PolicyError, PolicySpec,
                                       registered_policies,
                                       smoke_test_policies)
from repro_torch.core.types import ClusterSpec
from repro_torch.experiments import regimes as regimes_mod
from repro_torch.experiments.runner import (ExperimentSpec, TraceRef,
                                            run_experiment)
from repro_torch.experiments.stats import (compare_completion_by_workload,
                                           compare_deadlines,
                                           compare_throughput)
from repro_torch.simcluster.largescale import FLEET_SHAPES
from repro_torch.simcluster.traces import (PRESETS, TraceConfig,
                                           TraceImportError, generate_trace,
                                           import_swim_file, paper_trace)

DEFAULT_CACHE = Path(".exp-cache")


def _parse_seeds(tokens: List[str]) -> Tuple[int, ...]:
    """Accept explicit seeds and half-open ``a:b`` ranges: ``0 1 4:8``."""
    out: List[int] = []
    for tok in tokens:
        if ":" in tok:
            a, b = tok.split(":", 1)
            out.extend(range(int(a), int(b)))
        else:
            out.append(int(tok))
    if not out:
        raise argparse.ArgumentTypeError("no seeds given")
    return tuple(dict.fromkeys(out))    # dedup, keep order


def _parse_policy(token: str) -> PolicySpec:
    """A scheduler CLI token: registered name or inline policy JSON."""
    try:
        return PolicySpec.parse(token)
    except PolicyError as e:
        raise SystemExit(f"bad policy {token!r}: {e}")


def _parse_faults(token):
    """A --faults CLI token: named profile from ``FAULT_PROFILES`` or an
    inline ``FaultConfig`` JSON object."""
    from repro_torch.core.types import FaultConfig
    if token in regimes_mod.FAULT_PROFILES:
        return regimes_mod.FAULT_PROFILES[token]
    if token.lstrip().startswith("{"):
        import json
        try:
            return FaultConfig.from_dict(json.loads(token))
        except (ValueError, TypeError) as e:
            raise SystemExit(f"bad fault config {token!r}: {e}")
    raise SystemExit(
        f"bad --faults {token!r}: expected a profile name "
        f"({', '.join(regimes_mod.FAULT_PROFILES)}) or FaultConfig JSON")


def _parse_serve(token, machines: int):
    """A --serve CLI token: named profile from ``SERVE_PROFILES`` (scaled
    to the cluster's machine count) or an inline ``ServeConfig`` JSON."""
    from repro_torch.core.types import ServeConfig
    if token in regimes_mod.SERVE_PROFILES:
        return regimes_mod.serve_profile(token, machines)
    if token.lstrip().startswith("{"):
        import json
        try:
            return ServeConfig.from_dict(json.loads(token))
        except (ValueError, TypeError) as e:
            raise SystemExit(f"bad serve config {token!r}: {e}")
    raise SystemExit(
        f"bad --serve {token!r}: expected a profile name "
        f"({', '.join(regimes_mod.SERVE_PROFILES)}) or ServeConfig JSON")


def _cluster_from_args(args) -> ClusterSpec:
    spec = ClusterSpec(num_machines=args.machines,
                       vms_per_machine=args.vms,
                       replication=args.replication,
                       remote_penalty_scale=args.remote_penalty_scale)
    if getattr(args, "faults", None):
        spec = dataclasses.replace(spec, faults=_parse_faults(args.faults))
    if getattr(args, "serve", None):
        spec = dataclasses.replace(
            spec, serve=_parse_serve(args.serve, args.machines))
    return spec


def _trace_ref_from_args(args) -> TraceRef:
    if args.trace is not None:
        return TraceRef(path=str(args.trace))
    if args.preset is not None:
        return TraceRef(preset=args.preset,
                        seed=getattr(args, "trace_seed", None))
    raise SystemExit("one of --trace / --preset is required")


def _add_grid_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--trace", type=Path, default=None,
                   help="trace JSONL file (from `generate`)")
    p.add_argument("--preset", default=None,
                   help="named trace preset: paper, "
                        + ", ".join(sorted(PRESETS)))
    p.add_argument("--trace-seed", type=int, default=None,
                   help="pin the trace seed (default: couple to each sim seed)")
    p.add_argument("--seeds", nargs="+", default=["0"],
                   help="sim seeds; accepts `a:b` ranges (default: 0)")
    p.add_argument("--machines", type=int, default=20)
    p.add_argument("--vms", type=int, default=2)
    p.add_argument("--replication", type=int, default=1)
    p.add_argument("--remote-penalty-scale", type=float, default=1.0,
                   help="network-fabric calibration of the remote-read "
                        "penalty (1.0 = 1GbE, 0.25 ~ 10GbE, 0.0625 ~ 40GbE)")
    p.add_argument("--faults", default=None,
                   help="fault-injection profile (churn_lo, churn_hi, "
                        "churn_hetero) or inline FaultConfig JSON, e.g. "
                        '\'{"enabled": true, "crash_mtbf": 1800}\'')
    p.add_argument("--serve", default=None,
                   help="co-located serving profile ("
                        + ", ".join(regimes_mod.SERVE_PROFILES)
                        + ") or inline ServeConfig JSON")
    p.add_argument("--cache", type=Path, default=DEFAULT_CACHE,
                   help=f"result cache directory (default: {DEFAULT_CACHE})")
    p.add_argument("--workers", type=int, default=0,
                   help="multiprocessing pool size; 0 = inline (default)")


def cmd_generate(args) -> int:
    if args.preset == "paper":
        if args.num_jobs is not None:
            raise SystemExit("--num-jobs is incompatible with --preset paper "
                             "(the Table-2 mix is fixed at 5 jobs)")
        trace = paper_trace(args.seed)
    else:
        if args.preset is None:
            config = TraceConfig()
        elif args.preset in PRESETS:
            config = PRESETS[args.preset]
        else:
            raise SystemExit(f"unknown preset {args.preset!r}; available: "
                             f"paper, {', '.join(sorted(PRESETS))}")
        if args.num_jobs is not None:
            config = dataclasses.replace(config, num_jobs=args.num_jobs)
        trace = generate_trace(config, args.seed)
    path = trace.save(args.out)
    counts = ", ".join(f"{w}:{c}" for w, c in
                       sorted(trace.workload_counts().items()))
    print(f"wrote {path}: {len(trace.jobs)} jobs over "
          f"{trace.duration():.0f}s, {trace.total_input_gb():.1f} GB total "
          f"({counts})")
    return 0


def cmd_import(args) -> int:
    try:
        trace = import_swim_file(
            args.log,
            **({"name": args.name} if args.name else {}),
            deadline_slack=args.deadline_slack,
            skew=args.skew,
            max_jobs=args.max_jobs)
    except TraceImportError as e:
        raise SystemExit(f"import failed: {e}")
    path = trace.save(args.out)
    counts = ", ".join(f"{w}:{c}" for w, c in
                       sorted(trace.workload_counts().items()))
    print(f"imported {args.log} -> {path}: {len(trace.jobs)} jobs over "
          f"{trace.duration():.0f}s, {trace.total_input_gb():.1f} GB total "
          f"({counts})")
    return 0


def _print_records(report) -> None:
    print(f"[{report.spec_name}] {len(report.records)} runs "
          f"({report.simulated} simulated, {report.cached} cached)")
    print(f"{'scheduler':10s} {'seed':>4s} {'makespan':>9s} {'tput/h':>7s} "
          f"{'done':>5s} {'ddl':>4s} {'local%':>7s} {'spec':>5s}")
    for r in report.records:
        print(f"{r.scheduler:10s} {r.seed:4d} {r.makespan:9.1f} "
              f"{r.throughput_jph:7.1f} {r.jobs_finished:3d}/{r.jobs_total:<3d}"
              f"{r.deadlines_met:4d} {r.locality_rate:7.1%} "
              f"{r.speculative_launches:5d}")


def cmd_run(args) -> int:
    policies = [_parse_policy(tok) for tok in args.schedulers]
    policies += [_parse_policy(tok) for tok in (args.policy or [])]
    try:
        spec = ExperimentSpec(
            name=args.name,
            traces=(_trace_ref_from_args(args),),
            clusters=(_cluster_from_args(args),),
            schedulers=tuple(policies),
            seeds=_parse_seeds(args.seeds),
        )
    except ValueError as e:               # duplicate policies etc.
        raise SystemExit(f"bad sweep spec: {e}")
    report = run_experiment(spec, args.cache, workers=args.workers,
                            progress=print if args.verbose else None)
    _print_records(report)
    return 0


def cmd_compare(args) -> int:
    pol_a, pol_b = _parse_policy(args.a), _parse_policy(args.b)
    try:
        spec = ExperimentSpec(
            name=args.name,
            traces=(_trace_ref_from_args(args),),
            clusters=(_cluster_from_args(args),),
            schedulers=(pol_a, pol_b),
            seeds=_parse_seeds(args.seeds),
        )
    except ValueError as e:               # e.g. --a and --b the same policy
        raise SystemExit(f"bad sweep spec: {e}")
    report = run_experiment(spec, args.cache, workers=args.workers,
                            progress=print if args.verbose else None)
    by_sched = report.by_scheduler()
    a, b = pol_a.label, pol_b.label
    ra, rb = by_sched[a], by_sched[b]
    print(f"[{report.spec_name}] {b} vs {a} "
          f"({report.simulated} simulated, {report.cached} cached)")
    print("  " + compare_throughput(ra, rb).format(a, b))
    dl = compare_deadlines(ra, rb)
    print(f"  deadlines met/run: {a} {dl['mean_a']:.1f} -> "
          f"{b} {dl['mean_b']:.1f}")
    print("  per-workload completion-time gain:")
    for w, cmp in compare_completion_by_workload(ra, rb).items():
        print(f"    {w:16s} {cmp.mean_gain_pct:+6.1f}% "
              f"[{cmp.ci_lo_pct:+6.1f}%, {cmp.ci_hi_pct:+6.1f}%] "
              f"win {cmp.win_rate:.0%}")
    return 0


def cmd_policies(args) -> int:
    print(f"{'policy':12s} {'ordering':13s} {'park':9s} {'overload':13s} "
          f"{'harvest':8s} parameters")
    for name, pol in registered_policies().items():
        params = ", ".join(f"{k}={v}" for k, v in sorted(pol.defaults.items()))
        c = pol.components
        print(f"{name:12s} {c['ordering']:13s} {c['park']:9s} "
              f"{c['overload']:13s} {c.get('harvest', 'off'):8s} "
              f"{params or '-'}")
        if args.verbose:
            print(f"             {pol.description}")
    if args.smoke:
        failures = smoke_test_policies()
        if failures:
            print("policy smoke FAILED:")
            for f in failures:
                print(f"  - {f}")
            return 1
        print(f"policy smoke passed: {len(registered_policies())} policies "
              "ran clean (every job finished, no stranded tasks)")
    return 0


def cmd_surrogate(args) -> int:
    from repro_torch.experiments import surrogate as sur_mod
    from repro_torch.simcluster.surrogate import (SurrogateUnsupported,
                                                  _device)

    shape = args.shape
    if shape not in FLEET_SHAPES:
        raise SystemExit(f"unknown shape {shape!r}; available: "
                         f"{', '.join(FLEET_SHAPES)}")
    if args.presets:
        pairs = [(p, shape) for p in args.presets]
        for p, s in pairs:
            if p not in PRESETS:
                raise SystemExit(f"unknown preset {p!r}; available: "
                                 f"{', '.join(sorted(PRESETS))}")
            if (p, s) not in sur_mod.CALIBRATED and not args.policies:
                raise SystemExit(
                    f"({p}, {s}) is not in the calibration allowlist; "
                    f"pass --policies to sweep uncalibrated estimates "
                    f"anyway (allowlisted: "
                    f"{', '.join(f'{k[0]}/{k[1]}' for k in sorted(sur_mod.CALIBRATED))})")
    else:
        pairs = [k for k in sorted(sur_mod.CALIBRATED) if k[1] == shape]
        if not pairs:
            raise SystemExit(f"no calibrated presets at shape {shape!r}")
    seeds = _parse_seeds(args.seeds)
    try:
        _device(args.device)         # no card and no fallback: stop here
    except RuntimeError as e:
        raise SystemExit(f"surrogate: {e}")
    rc = 0
    for preset, shp in pairs:
        allow = sur_mod.CALIBRATED.get((preset, shp), ())
        pols = tuple(args.policies) if args.policies else allow
        pols = tuple(p for p in pols if p != "fair")
        base = regimes_mod.regime_spec(preset, shp, seeds=seeds)
        spec = ExperimentSpec(name=f"surrogate-{preset}-{shp}",
                              traces=base.traces, clusters=base.clusters,
                              schedulers=pols + ("fair",), seeds=seeds)
        try:
            rep = sur_mod.run_surrogate(
                spec, args.cache, progress=print if args.verbose else None,
                device=args.device)
        except SurrogateUnsupported as e:
            raise SystemExit(f"surrogate: {e}")
        by = rep.by_scheduler()
        print(f"[{preset}/{shp}] {rep.simulated + rep.cached} surrogate "
              f"cells ({rep.cached} cached), seeds {seeds[0]}..{seeds[-1]}")
        print(f"  {'policy':11s} {'tput/h':>7s} {'vs fair':>8s} "
              f"{'local%':>7s} {'ddl':>6s} calibrated")
        for pol in pols + ("fair",):
            recs = by[pol]
            jph = sum(r.throughput_jph for r in recs) / len(recs)
            loc = sum(r.locality_rate for r in recs) / len(recs)
            ddl = sum(r.deadlines_met for r in recs) / len(recs)
            gain = ("       -" if pol == "fair" else
                    f"{compare_throughput(by['fair'], recs).mean_gain_pct:+7.1f}%")
            tag = "yes" if pol in allow else ("-" if pol == "fair"
                                              else "NO (oracle-only)")
            print(f"  {pol:11s} {jph:7.1f} {gain:>8s} {loc:7.1%} "
                  f"{ddl:6.1f} {tag}")
        if not args.no_calibrate and allow:
            cal = sur_mod.calibrate(
                preset, shp, args.cache, workers=args.workers,
                progress=print if args.verbose else None,
                device=args.device)
            print(f"  calibration vs event oracle "
                  f"(seeds {cal.seeds[0]}..{cal.seeds[-1]}):")
            for pc in cal.policies:
                status = "IN" if pc.inside else "OUT"
                print(f"    {pc.policy:11s} surrogate "
                      f"{pc.surrogate_gain_pct:+6.1f}% vs oracle CI "
                      f"[{pc.oracle.ci_lo_pct:+6.1f}%, "
                      f"{pc.oracle.ci_hi_pct:+6.1f}%]  {status}")
            if not cal.wall_green:
                print(f"  CALIBRATION DRIFT: an allowlisted policy left "
                      f"the oracle CI — rerun tests/test_torch_calibration.py")
                rc = 1
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.experiments",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="command", required=True)

    g = sub.add_parser("generate", help="synthesize a trace to JSONL")
    g.add_argument("--preset", default=None,
                   help="paper, " + ", ".join(sorted(PRESETS)))
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--num-jobs", type=int, default=None,
                   help="override the preset's job count")
    g.add_argument("--out", type=Path, required=True)
    g.set_defaults(func=cmd_generate)

    im = sub.add_parser("import",
                        help="convert a SWIM-format cluster log to "
                             "repro-trace/v1 JSONL")
    im.add_argument("--log", type=Path, required=True,
                    help="SWIM/Facebook-format log: job_id submit_time gap "
                         "input_bytes shuffle_bytes output_bytes per line")
    im.add_argument("--out", type=Path, required=True)
    im.add_argument("--name", default=None,
                    help="trace name (default: log file stem)")
    im.add_argument("--deadline-slack", type=float, default=2.2)
    im.add_argument("--skew", type=float, default=1.0,
                    help="VM-level placement skew applied at replay")
    im.add_argument("--max-jobs", type=int, default=None,
                    help="import at most this many rows")
    im.set_defaults(func=cmd_import)

    r = sub.add_parser("run", help="run a sweep grid (cached)")
    _add_grid_args(r)
    r.add_argument("--schedulers", nargs="+", default=["proposed", "fair"],
                   help="policy names or inline policy JSON objects")
    r.add_argument("--policy", action="append", default=None,
                   help='extra policy JSON, e.g. \'{"name": "delay", '
                        '"params": {"locality_delay": 4}}\' (repeatable)')
    r.add_argument("--name", default="sweep")
    r.add_argument("--verbose", action="store_true")
    r.set_defaults(func=cmd_run)

    c = sub.add_parser("compare", help="paired policy comparison")
    _add_grid_args(c)
    c.add_argument("--a", default="fair",
                   help="baseline policy (name or JSON)")
    c.add_argument("--b", default="proposed",
                   help="candidate policy (name or JSON)")
    c.add_argument("--name", default="compare")
    c.add_argument("--verbose", action="store_true")
    c.set_defaults(func=cmd_compare)

    sg = sub.add_parser(
        "surrogate",
        help="batched fluid-engine sweep over calibrated atlas cells, "
             "with differential calibration vs paired oracle cells")
    sg.add_argument("presets", nargs="*",
                    help="presets to sweep (default: every allowlisted "
                         "preset at --shape)")
    sg.add_argument("--shape", default="20x2",
                    help="fleet shape (default: 20x2, the calibrated shape)")
    sg.add_argument("--seeds", nargs="+", default=["0:8"],
                    help="sim seeds; accepts `a:b` ranges (default: 0:8)")
    sg.add_argument("--policies", nargs="*", default=None,
                    help="override the calibrated policy set (uncalibrated "
                         "estimates are labeled as such)")
    sg.add_argument("--cache", type=Path, default=DEFAULT_CACHE,
                    help=f"shared result cache (default: {DEFAULT_CACHE}); "
                         "surrogate cells hash into their own namespace")
    sg.add_argument("--no-calibrate", action="store_true",
                    help="skip the paired event-oracle calibration pass")
    sg.add_argument("--workers", type=int, default=0,
                    help="pool size for the oracle side of calibration")
    sg.add_argument("--device", default="cuda",
                    help="where the surrogate integrates (default: cuda, "
                         "the card; cpu runs the kernel's plain version)")
    sg.add_argument("--verbose", action="store_true")
    sg.set_defaults(func=cmd_surrogate)

    pl = sub.add_parser("policies",
                        help="list registered scheduler policies "
                             "(repro_torch.core.policies)")
    pl.add_argument("--smoke", action="store_true",
                    help="instantiate every policy on a 2-machine scenario "
                         "and fail on stranded work")
    pl.add_argument("--verbose", action="store_true",
                    help="include policy descriptions")
    pl.set_defaults(func=cmd_policies)

    args = ap.parse_args(argv)
    return args.func(args)



if __name__ == "__main__":
    sys.exit(main())
