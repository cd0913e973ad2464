"""The paper's §5 evaluation on the port (``repro_torch.experiments.paperfig``)
against the JAX package's, on the CPU.

The Table-2 five-workload mix on the paper cluster (20 machines x 2 VMs),
proposed against Fair, paired per seed: at the same seeds the port's report
is the original's, byte for byte, and at the full twelve seeds it reproduces
the paper's two claims (a throughput gain whose 95 % CI excludes zero, and
Permutation the weakest workload of Fig. 3).  The ``paper`` verb prints what
the original's prints and exits with the same code.  The report this pins at
full seeds is the one ``chip_smoke.py`` holds the card machine's run to.
"""
import sys
from pathlib import Path

import pytest

import repro.experiments.__main__ as jcli
import repro.experiments.paperfig as jpaper
import repro_torch.experiments.__main__ as tcli
import repro_torch.experiments.paperfig as tpaper

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def full_reports(tmp_path_factory):
    """Both packages at the full twelve seeds, each into its own cache."""
    root = tmp_path_factory.mktemp("paper-full")
    return (jpaper.run_paper(jpaper.FULL_SEEDS, cache_dir=root / "jax"),
            tpaper.run_paper(tpaper.FULL_SEEDS, cache_dir=root / "port"), root)


def test_seed_sets_equal_the_original():
    assert tpaper.FULL_SEEDS == jpaper.FULL_SEEDS == tuple(range(1, 13))
    assert tpaper.QUICK_SEEDS == jpaper.QUICK_SEEDS == (1, 2, 3)
    j, t = jpaper.paper_spec((1, 2)), tpaper.paper_spec((1, 2))
    assert [c.descriptor() for c in t.cells()] == [c.descriptor() for c in j.cells()]
    assert [c.cache_hash() for c in t.cells()] == [c.cache_hash() for c in j.cells()]


def test_paper_quick_is_byte_equal(tmp_path):
    a = jpaper.run_paper(jpaper.QUICK_SEEDS, cache_dir=tmp_path / "jax")
    b = tpaper.run_paper(tpaper.QUICK_SEEDS, cache_dir=tmp_path / "port")
    assert b.format() == a.format()
    assert b.failures() == a.failures()
    assert b.throughput.n_pairs == len(tpaper.QUICK_SEEDS)
    assert b.throughput.ci_lo_pct <= b.throughput.mean_gain_pct <= b.throughput.ci_hi_pct
    assert set(b.per_workload) == {"grep", "wordcount", "sort", "permutation",
                                   "inverted_index"}
    text = b.format()
    assert "95% CI" in text and "weakest-gain workload" in text
    again = tpaper.run_paper(tpaper.QUICK_SEEDS, cache_dir=tmp_path / "port")
    assert again.simulated == 0 and again.cached == 2 * len(tpaper.QUICK_SEEDS)
    assert again.format() == b.format().replace("6 simulated, 0 cached",
                                                "0 simulated, 6 cached")


def test_paper_full_is_byte_equal(full_reports):
    a, b, _ = full_reports
    assert b.format() == a.format()
    assert b.simulated == a.simulated == 2 * len(tpaper.FULL_SEEDS)


def test_paper_full_reproduces_claims(full_reports):
    _, report, _ = full_reports
    assert report.failures() == []
    assert report.throughput.mean_gain_pct > 0 and report.throughput.ci_lo_pct > 0
    assert report.weakest_workload() == "permutation"
    for w, cmp in report.per_workload.items():
        if w != "permutation":
            assert cmp.mean_gain_pct > 0, (w, cmp.mean_gain_pct)
    assert report.format().splitlines()[-1] == "  claims: REPRODUCED"


def test_port_is_served_from_the_original_cache(full_reports):
    """One cache for both packages: the port's run after the original's
    simulates nothing and reports the same numbers."""
    a, _, root = full_reports
    served = tpaper.run_paper(tpaper.FULL_SEEDS, cache_dir=root / "jax")
    n = 2 * len(tpaper.FULL_SEEDS)
    assert (served.simulated, served.cached) == (0, n)
    assert served.format() == a.format().replace(f"{n} simulated, 0 cached",
                                                 f"0 simulated, {n} cached")


@pytest.mark.parametrize("argv", [
    ["paper", "--quick"],
    ["paper"],
    ["paper", "--seeds", "1:3"],
    ["paper", "--seeds", "5", "9", "--quick"],
], ids=["quick", "full", "seeds-range", "seeds-quick"])
def test_paper_verb_prints_the_same(argv, capsys, tmp_path):
    out = []
    for name, cli in (("jax", jcli), ("port", tcli)):
        rc = cli.main(argv + ["--cache", str(tmp_path / name)])
        out.append((capsys.readouterr().out, rc))
    assert out[0] == out[1]
    text, rc = out[1]
    assert text.startswith("== paper reproduction (proposed vs fair, ")
    if argv == ["paper"]:
        assert rc == 0 and text.endswith("  claims: REPRODUCED\n")
    if argv == ["paper", "--seeds", "1:3"]:
        # full mode enforces the claims: two seeds cannot exclude zero
        assert rc == 1 and "claims: REPRODUCED" not in text


def test_paper_verb_without_a_cache_uses_a_temporary_one(capsys, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    assert tcli.main(["paper", "--quick"]) == 0
    out = capsys.readouterr().out
    assert jcli.main(["paper", "--quick"]) == 0
    assert capsys.readouterr().out == out
    assert not any(tmp_path.iterdir())


def test_pinned_report_is_what_the_chip_run_compares(full_reports):
    """``chip_smoke.py`` cannot run JAX on the card machine: it holds its
    ``paper`` run to the text it keeps, which must be the original's."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    a, _, _ = full_reports
    assert chip_smoke.PAPER_REPORT == a.format()
