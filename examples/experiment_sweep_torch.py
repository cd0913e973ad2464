"""End-to-end tour of the port's trace-driven experiment CLI on a small grid.

Drives ``python -m repro_torch.experiments`` exactly as a user would:

1. ``generate`` — synthesize a bursty 20-job trace to JSONL;
2. ``run``      — sweep it over 2 policies x 3 seeds on a 10x2 cluster
                  (6 simulations, cached on disk);
3. ``run`` again — the same grid is served entirely from the cache, and a
                  ``PolicySpec``-style inline policy JSON (the ``delay``
                  baseline with a custom ``locality_delay``) extends the
                  grid, simulating only the new cells;
4. ``compare``  — paired-bootstrap comparison of proposed vs fair;
5. ``policies`` — the registered policy table + smoke run;
6. ``paper --quick`` — the paper's §5 evaluation at reporting depth.

Every verb here is the port's event engine, pure Python on the host: no
card is needed.  The same grid is expressible in-process::

    from repro_torch.core.policies import PolicySpec
    from repro_torch.core.types import ClusterSpec
    from repro_torch.experiments.runner import ExperimentSpec, TraceRef
    spec = ExperimentSpec(
        name="sweep",
        traces=(TraceRef(path="trace.jsonl"),),
        clusters=(ClusterSpec(num_machines=10, vms_per_machine=2),),
        schedulers=("proposed",                       # preset name
                    PolicySpec("delay", {"locality_delay": 4})),
        seeds=(0, 1, 2))

Everything lands in a temp directory and the whole script stays well under
a minute::

    PYTHONPATH=src python examples/experiment_sweep_torch.py
"""
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent


def cli(workdir: Path, *args: str) -> str:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO_ROOT / "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.experiments", *args],
        cwd=workdir, env=env, capture_output=True, text=True)
    sys.stdout.write(proc.stdout)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr)
        raise SystemExit(f"CLI failed: {' '.join(args)}")
    return proc.stdout


def tour(work: Path) -> None:
    grid = ["--trace", "trace.jsonl", "--seeds", "0:3",
            "--machines", "10", "--vms", "2", "--cache", "cache"]

    print("== 1. generate a bursty trace ==")
    cli(work, "generate", "--preset", "bursty", "--seed", "0",
        "--num-jobs", "20", "--out", "trace.jsonl")

    print("\n== 2. sweep: 2 schedulers x 3 seeds ==")
    out = cli(work, "run", *grid, "--schedulers", "proposed", "fair")
    assert "6 simulated, 0 cached" in out, out

    print("\n== 3. re-run: zero new simulations; an inline policy JSON "
          "extends the grid ==")
    out = cli(work, "run", *grid, "--schedulers", "proposed", "fair")
    assert "0 simulated, 6 cached" in out, out
    out = cli(work, "run", *grid, "--schedulers", "proposed", "fair",
              "--policy", '{"name": "delay", "params": {"locality_delay": 4}}')
    assert "3 simulated, 6 cached" in out, out
    assert "delay[locality_delay=4]" in out, out

    print("\n== 4. paired comparison (reuses the same cache) ==")
    out = cli(work, "compare", *grid, "--a", "fair", "--b", "proposed")
    assert "95% CI" in out, out

    print("\n== 5. the registered policy table + smoke ==")
    out = cli(work, "policies", "--smoke")
    assert "policy smoke passed" in out, out

    print("\n== 6. the paper evaluation, quick preset ==")
    out = cli(work, "paper", "--quick", "--cache", "paper-cache")
    assert "weakest-gain workload" in out, out


def main() -> int:
    t0 = time.time()
    with tempfile.TemporaryDirectory(prefix="exp-sweep-") as tmp:
        tour(Path(tmp))
    print(f"\nall done in {time.time() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
