"""The port's experiment tour (``examples/experiment_sweep_torch.py``) and the
benchmark of its two event engines (``scripts/bench_torch_sim.py``), on the
CPU: the tour drives ``python -m repro_torch.experiments`` through every step
to exit 0, and the benchmark reports events/s of both engines with parity.
"""
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


def _load(rel, name):
    spec = importlib.util.spec_from_file_location(name, REPO / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def bench():
    return _load("scripts/bench_torch_sim.py", "bench_torch_sim")


def test_experiment_sweep_torch_runs_to_exit_0(tmp_path):
    """The tour in a temporary directory under ``tmp_path`` (its TMPDIR),
    removed when it ends."""
    proc = subprocess.run(
        [sys.executable, str(REPO / "examples" / "experiment_sweep_torch.py")],
        capture_output=True, text=True, cwd=tmp_path, timeout=300,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO / "src"),
             "TMPDIR": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout
    for step in range(1, 7):
        assert f"== {step}. " in out
    assert "0 simulated, 6 cached" in out and "policy smoke passed" in out
    assert "weakest-gain workload" in out and "all done in" in out
    assert not any(tmp_path.iterdir())


def test_bench_paper_cluster_parity(bench):
    r = bench.bench_scenario("paper_20x2", ("indexed", "legacy"), 2, seed=0)
    assert r["parity"] is True and r["speedup"] > 0
    for engine in ("indexed", "legacy"):
        e = r[engine]
        assert e["events"] == r["indexed"]["events"] > 1000
        assert e["jobs_finished"] == e["jobs_total"] == 5
        assert len(e["walls_s"]) == 2 and e["wall_time_s"] == min(e["walls_s"])
        assert e["events_per_sec"] == e["events"] / e["wall_time_s"]


def test_bench_indexed_only_scenario_says_why(bench):
    r = bench.bench_scenario("smoke_40x2", ("indexed",), 1, seed=0)
    assert r["parity"] is None and "legacy" not in r
    assert "heartbeats die" in r["legacy_skipped"]
    assert set(bench.LEGACY_SKIPPED) == {n for n, e, _ in bench.FULL if e == ("indexed",)}


def test_bench_parity_sees_a_changed_decision(bench, monkeypatch):
    """Parity compares decisions, not just makespans: one changed task
    duration in the legacy run breaks it."""
    real = bench._paper_run

    def perturbed(engine, seed):
        res, wall = real(engine, seed)
        if engine == "legacy":
            job = next(iter(res.jobs.values()))
            job.map_durations[0] += 1e-9
        return res, wall

    monkeypatch.setattr(bench, "_paper_run", perturbed)
    assert bench.bench_scenario("paper_20x2", ("indexed", "legacy"), 1, seed=0)["parity"] is False


def test_bench_main_writes_its_own_file(bench, monkeypatch, tmp_path, capsys):
    assert bench.DEFAULT_OUT == REPO / "build" / "bench_torch_sim.json"
    monkeypatch.setattr(bench, "QUICK", bench.QUICK[:1])
    out = tmp_path / "b.json"
    assert bench.main(["--quick", "--out", str(out)]) == 0
    report = json.loads(out.read_text())
    assert report["mode"] == "quick" and list(report["scenarios"]) == ["paper_20x2"]
    assert report["scenarios"]["paper_20x2"]["parity"] is True
    text = capsys.readouterr().out
    assert "paper_20x2: indexed 4049 events" in text and "parity=True" in text
