"""The port's regime atlas (``repro_torch.experiments.regimes``) and its verbs
against the JAX package's, on the CPU.

A small grid that crosses every axis of the atlas (a preset, the 10GbE
fabric, replication 3, the churn_hi fault profile, the committed SWIM trace
and one serving profile) runs through both packages: the regime and serve
reports' JSON, ``format()`` and ``to_markdown()`` are byte-equal, a port run
into a cache the original filled simulates nothing, and ``regimes
--markdown`` edits a copy of ``EXPERIMENTS.md`` into the same bytes.  The
``regimes``, ``explain``, ``faults --list`` and ``serve --list`` verbs print
the original's lines and refuse what it refuses.
"""
import json
import shutil
from pathlib import Path

import pytest

import repro.experiments.__main__ as jcli
import repro.experiments.regimes as jreg
import repro_torch.experiments as texp
import repro_torch.experiments.__main__ as tcli
import repro_torch.experiments.regimes as treg

REPO = Path(__file__).resolve().parents[1]
GRID = dict(presets=("mix_small",), shapes=("20x2",), seeds=(0, 1))
AXES = dict(fabrics=("10GbE",), replications=(3,), faults=("churn_hi",), swim=("swim_fb",))
SERVE = dict(profiles=("svc_spiky",), shapes=("20x2",), seeds=(0, 1))


def _report_bytes(report, path):
    return (report.save_json(path).read_bytes(), report.format(), report.to_markdown())


@pytest.fixture(scope="module")
def atlas(tmp_path_factory):
    """The grid through each package into its own cache, then the port into
    the original's cache."""
    root = tmp_path_factory.mktemp("atlas")
    out = {}
    for name, reg in (("jax", jreg), ("port", treg)):
        rep = reg.run_regimes(cache_dir=root / name, n_boot=500, **GRID, **AXES)
        srep = reg.run_serve_regimes(cache_dir=root / name, n_boot=500, **SERVE)
        out[name] = (rep, srep)
    shared = (treg.run_regimes(cache_dir=root / "jax", n_boot=500, **GRID, **AXES),
              treg.run_serve_regimes(cache_dir=root / "jax", n_boot=500, **SERVE))
    return out, shared, root


def test_axes_and_profiles_equal_the_original():
    for name in ("REGIME_PRESETS", "FULL_SHAPES", "QUICK_SHAPES", "FULL_SEEDS", "QUICK_SEEDS",
                 "SCHEDULERS", "FABRICS", "BASE_FABRIC", "FULL_FABRICS", "QUICK_FABRICS",
                 "BASE_REPLICATION", "FULL_REPLICATIONS", "QUICK_REPLICATIONS",
                 "BASE_FAULTS", "FULL_FAULTS", "QUICK_FAULTS", "FAULT_SHAPES",
                 "SERVE_PROFILES", "SERVE_SHAPES", "FULL_SERVE", "QUICK_SERVE",
                 "SERVE_SCHEDULERS", "SERVE_PRESET", "FULL_SWIM", "QUICK_SWIM",
                 "REPORT_VERSION"):
        assert getattr(treg, name) == getattr(jreg, name), name
    assert {k: v.to_dict() for k, v in treg.FAULT_PROFILES.items()} == \
        {k: v.to_dict() for k, v in jreg.FAULT_PROFILES.items()}
    for p in treg.SERVE_PROFILES:
        for machines in (20, 50):
            assert treg.serve_profile(p, machines).to_dict() == \
                jreg.serve_profile(p, machines).to_dict()
    assert treg.SWIM_TRACES["swim_fb"].read_bytes() == jreg.SWIM_TRACES["swim_fb"].read_bytes()
    for shape in ("20x2", "50x2"):
        j, t = jreg.serve_spec("svc_heavy_tight", shape, (0, 1)), \
            treg.serve_spec("svc_heavy_tight", shape, (0, 1))
        assert [c.cache_hash() for c in t.cells()] == [c.cache_hash() for c in j.cells()]


def test_regime_report_is_byte_equal(atlas, tmp_path):
    out, _, _ = atlas
    (jrep, _), (trep, _) = out["jax"], out["port"]
    assert _report_bytes(trep, tmp_path / "t.json") == _report_bytes(jrep, tmp_path / "j.json")
    assert trep.simulated == jrep.simulated == 5 * len(treg.SCHEDULERS) * 2
    assert [(c.preset, c.fabric, c.replication, c.faults) for c in trep.cells] == [
        ("mix_small", "1GbE", 1, "none"), ("swim_fb", "1GbE", 1, "none"),
        ("mix_small", "10GbE", 1, "none"), ("mix_small", "1GbE", 3, "none"),
        ("mix_small", "1GbE", 1, "churn_hi")]
    assert "| faults |" in trep.to_markdown()


def test_serve_report_is_byte_equal(atlas, tmp_path):
    out, _, _ = atlas
    (_, jsrep), (_, tsrep) = out["jax"], out["port"]
    assert _report_bytes(tsrep, tmp_path / "t.json") == _report_bytes(jsrep, tmp_path / "j.json")
    (cell,) = tsrep.cells
    assert cell.verdict() in ("win", "loss", "tie") and cell.harvest_borrows > 0


def test_shared_cache_simulates_nothing(atlas, tmp_path):
    out, (rep, srep), _ = atlas
    (jrep, jsrep) = out["jax"]
    n, ns = jrep.simulated, jsrep.simulated
    assert (rep.simulated, rep.cached, srep.simulated, srep.cached) == (0, n, 0, ns)
    assert rep.format() == jrep.format().replace(f"{n} simulated, 0 cached",
                                                 f"0 simulated, {n} cached")
    assert [c.to_dict() for c in rep.cells] == [c.to_dict() for c in jrep.cells]
    assert [c.to_dict() for c in srep.cells] == [c.to_dict() for c in jsrep.cells]


def test_cache_cells_are_the_same_files(atlas):
    """Each package wrote the same cells under the same names, with the same
    descriptors and records (the record's wall clock aside)."""
    _, _, root = atlas

    def files(d):
        return sorted(p.relative_to(d).as_posix() for p in d.rglob("*.json"))

    assert files(root / "port") == files(root / "jax")
    for rel in files(root / "port"):
        a = json.loads((root / "jax" / rel).read_text())
        b = json.loads((root / "port" / rel).read_text())
        if rel.endswith("meta.json"):
            assert a == b
        else:
            a.pop("wall_time_s"), b.pop("wall_time_s")
            assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True), rel


def test_package_exports_equal_the_original():
    import repro.experiments as jexp
    import repro.simcluster as jsc
    import repro_torch.simcluster as tsc
    assert texp.__all__ == jexp.__all__
    for name in texp.__all__:
        assert getattr(texp, name).__name__ == getattr(jexp, name).__name__
        assert getattr(texp, name).__module__.startswith("repro_torch.")
    for name in ("ClusterSim", "SimResult", "SCENARIOS", "Scenario", "run_scenario",
                 "PRESETS", "TraceConfig", "generate_trace", "paper_cluster",
                 "PAPER_TABLE2_ROWS", "WORKLOADS", "paper_table2_jobs"):
        assert hasattr(tsc, name) and hasattr(jsc, name), name


# ---------------------------------------------------------------------------
# the verbs
# ---------------------------------------------------------------------------

def _both(capsys, argv_fn):
    out = []
    for name, cli in (("jax", jcli), ("port", tcli)):
        rc = cli.main(argv_fn(name))
        out.append((capsys.readouterr().out, rc))
    return out


def test_regimes_verb_prints_and_writes_the_same(capsys, tmp_path):
    """``regimes`` over every axis into a copy of EXPERIMENTS.md: the same
    lines (paths aside), reports and edited markdown."""
    for name in ("jax", "port"):
        (tmp_path / name).mkdir()
        shutil.copy(REPO / "EXPERIMENTS.md", tmp_path / name / "EXPERIMENTS.md")

    def argv(name):
        d = tmp_path / name
        return ["regimes", "--presets", "mix_small", "--shapes", "20x2", "--seeds", "0",
                "--fabrics", "40GbE", "--replications", "3", "--faults", "churn_lo",
                "--swim", "swim_fb", "--serve", "svc_light_loose",
                "--cache", str(d / "cache"), "--out", str(d / "regimes.json"),
                "--serve-out", str(d / "serve.json"), "--markdown", str(d / "EXPERIMENTS.md")]

    (a, rca), (b, rcb) = _both(capsys, argv)
    assert (rca, rcb) == (0, 0)
    assert a.replace(str(tmp_path / "jax"), "<d>") == b.replace(str(tmp_path / "port"), "<d>")
    for f in ("regimes.json", "serve.json", "EXPERIMENTS.md"):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
    md = (tmp_path / "port" / "EXPERIMENTS.md").read_text()
    assert md != (REPO / "EXPERIMENTS.md").read_text()
    assert "svc_light_loose" in md and "swim_fb" in md
    # and served from the cache the second time
    assert tcli.main(argv("port")) == 0
    again = capsys.readouterr().out
    assert "(1 paired seeds/cell; 0 simulated, 30 cached)" in again
    assert "0 simulated, 2 cached" in again


def test_regimes_markdown_into_a_new_file(capsys, tmp_path):
    def argv(name):
        d = tmp_path / name
        return ["regimes", "--presets", "mix_small", "--shapes", "20x2", "--seeds", "0",
                "--serve", "svc_spiky", "--cache", str(tmp_path / "cache"),
                "--out", str(d / "r.json"), "--serve-out", str(d / "s.json"),
                "--markdown", str(d / "new" / "atlas.md")]

    (a, rca), (b, rcb) = _both(capsys, argv)
    assert (rca, rcb) == (0, 0)
    assert (tmp_path / "port" / "new" / "atlas.md").read_bytes() == \
        (tmp_path / "jax" / "new" / "atlas.md").read_bytes()
    assert "<!-- serve:table:start -->" in (tmp_path / "port" / "new" / "atlas.md").read_text()


@pytest.mark.parametrize("argv", [["faults", "--list"], ["serve", "--list"],
                                  ["serve", "--list", "--machines", "50"]])
def test_list_verbs_print_the_same(argv, capsys):
    (a, rca), (b, rcb) = _both(capsys, lambda _: argv)
    assert (rca, rcb) == (0, 0) and a == b and a.count("\n") > 4


def test_explain_verb_prints_the_same(capsys, tmp_path):
    def argv(name):
        return ["explain", "heavy_tail", "20x2", "--policy", "adaptive_ra",
                "--baseline", "fair", "--faults", "churn_hetero",
                "--cache", str(tmp_path / name / "cache"),
                "--export", str(tmp_path / name / "export")]

    (a, rca), (b, rcb) = _both(capsys, argv)
    assert (rca, rcb) == (0, 0)
    assert a.replace(str(tmp_path / "jax"), "<d>") == b.replace(str(tmp_path / "port"), "<d>")
    exported = sorted((tmp_path / "port" / "export").glob("*.chrome.json"))
    assert len(exported) == 2
    for p in exported:
        assert json.loads(p.read_text())["traceEvents"]
        assert p.read_bytes() == (tmp_path / "jax" / "export" / p.name).read_bytes()


@pytest.mark.parametrize("argv", [
    ["faults"],
    ["serve"],
    ["regimes", "--presets", "nope"],
    ["regimes", "--shapes", "13x7"],
    ["regimes", "--fabrics", "100GbE"],
    ["regimes", "--faults", "meteor"],
    ["regimes", "--swim", "swim_yahoo"],
    ["regimes", "--serve", "svc_nope"],
    ["explain", "nope", "20x2"],
    ["explain", "saturated", "13x7"],
    ["explain", "saturated", "20x2", "--fabric", "100GbE"],
    ["explain", "saturated", "20x2", "--faults", "meteor"],
    ["explain", "saturated", "20x2", "--policy", "no_such_policy", "--no-store"],
])
def test_refusals_say_what_the_original_says(argv, tmp_path):
    msgs = []
    for cli in (jcli, tcli):
        extra = ["--cache", str(tmp_path)] if argv[0] in ("regimes", "explain") else []
        with pytest.raises(SystemExit) as e:
            cli.main(argv + extra)
        msgs.append(str(e.value.code))
    assert msgs[0] == msgs[1]
    assert msgs[1] not in ("0", "None")
