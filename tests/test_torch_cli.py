"""The port's ``python -m repro_torch.experiments`` verbs against the JAX
package's ``python -m repro.experiments``, on the CPU: the same arguments
print the same lines (``surrogate`` with ``--device cpu``: the fluid
surrogate's plain version, the port's event engine as the oracle), and the
files they write are byte-equal.  Without a card, ``surrogate`` without
``--device cpu`` exits non-zero: there is no fallback.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

import repro.experiments.__main__ as jcli
import repro_torch.experiments.__main__ as tcli

REPO = Path(__file__).resolve().parents[1]
SWIM_LOG = REPO / "src" / "repro_torch" / "experiments" / "data" / "swim_fb_sample.log"


def _both(capsys, tmp_path, argv, *, port_extra=()):
    """Run one verb through each package, each with its own cache under
    ``tmp_path``; return (original's stdout, port's stdout, exit codes)."""
    out = []
    for name, cli, extra in (("jax", jcli, ()), ("port", tcli, port_extra)):
        args = [a.replace("{cache}", str(tmp_path / f"cache-{name}")) for a in argv]
        rc = cli.main(args + list(extra))
        out.append((capsys.readouterr().out, rc))
    (a, rca), (b, rcb) = out
    return a, b, (rca, rcb)


@pytest.mark.parametrize("argv", [
    ["generate", "--preset", "bursty", "--seed", "3", "--out", "{out}"],
    ["generate", "--preset", "paper", "--seed", "1", "--out", "{out}"],
    ["generate", "--preset", "mix_small", "--num-jobs", "7", "--out", "{out}"],
    ["import", "--log", str(SWIM_LOG), "--out", "{out}"],
    ["import", "--log", str(SWIM_LOG), "--out", "{out}", "--name", "fb", "--max-jobs", "9",
     "--deadline-slack", "3.0", "--skew", "0.5"],
], ids=["bursty", "paper", "mix_small", "swim", "swim-options"])
def test_generate_and_import_print_and_write_the_same(argv, capsys, tmp_path):
    out = tmp_path / "trace.jsonl"
    argv = [str(out) if a == "{out}" else a for a in argv]
    lines, written = [], []
    for cli in (jcli, tcli):
        assert cli.main(argv) == 0
        lines.append(capsys.readouterr().out)
        written.append(out.read_bytes())
        out.unlink()
    assert lines[0] == lines[1] and lines[1].count("\n") == 1
    assert written[0] == written[1]


@pytest.mark.parametrize("argv", [
    ["run", "--preset", "mix_small", "--machines", "6", "--seeds", "0:2",
     "--schedulers", "proposed", "fair", "adaptive", "--cache", "{cache}"],
    ["run", "--preset", "heavy_tail", "--trace-seed", "2", "--machines", "6",
     "--replication", "2", "--remote-penalty-scale", "0.25", "--seeds", "1",
     "--schedulers", "fifo", "--policy", '{"name": "delay", "params": {"locality_delay": 4}}',
     "--cache", "{cache}"],
    ["run", "--preset", "mix_small", "--machines", "6", "--faults", "churn_hi",
     "--serve", "svc_spiky", "--seeds", "0", "--schedulers", "harvest", "adaptive",
     "--cache", "{cache}"],
    ["compare", "--preset", "mix_small", "--machines", "6", "--seeds", "0:3",
     "--a", "fair", "--b", "proposed", "--cache", "{cache}"],
], ids=["run", "run-options", "run-faults-serve", "compare"])
def test_run_and_compare_print_the_same(argv, capsys, tmp_path):
    a, b, rcs = _both(capsys, tmp_path, argv)
    assert rcs == (0, 0)
    assert a == b and "simulated" in a


@pytest.mark.parametrize("argv", [["policies"], ["policies", "--verbose"],
                                  ["policies", "--smoke"]])
def test_policies_print_the_same(argv, capsys, tmp_path):
    a, b, rcs = _both(capsys, tmp_path, argv)
    assert rcs == (0, 0)
    assert a == b and "edf_nopark" in a


def test_surrogate_on_the_cpu_prints_the_same(capsys, tmp_path):
    argv = ["surrogate", "heavy_tail", "--seeds", "0:2", "--cache", "{cache}"]
    a, b, rcs = _both(capsys, tmp_path, argv, port_extra=["--device", "cpu"])
    assert rcs == (0, 0)
    assert a == b
    assert "calibration vs event oracle" in b and "OUT" not in b
    # a second run is served from the cache and prints the same numbers
    assert tcli.main(["surrogate", "heavy_tail", "--seeds", "0:2", "--cache",
                      str(tmp_path / "cache-port"), "--device", "cpu"]) == 0
    again = capsys.readouterr().out
    assert again == b.replace("(0 cached)", "(8 cached)")


@pytest.mark.parametrize("argv", [
    ["surrogate", "--shape", "7x7"],
    ["surrogate", "nope"],
    ["surrogate", "heavy_tail", "--shape", "50x2"],
    ["run", "--machines", "6"],
    ["run", "--preset", "mix_small", "--schedulers", "no_such_policy"],
    ["compare", "--preset", "mix_small", "--a", "fair", "--b", "fair"],
    ["generate", "--preset", "paper", "--num-jobs", "3", "--out", "x.jsonl"],
    ["generate", "--preset", "nope", "--out", "x.jsonl"],
    ["import", "--log", "no/such/file.log", "--out", "x.jsonl"],
])
def test_refusals_say_what_the_original_says(argv, tmp_path):
    msgs = []
    for cli in (jcli, tcli):
        cache = ["--cache", str(tmp_path)] if argv[0] in ("run", "compare") else []
        with pytest.raises(SystemExit) as e:
            cli.main(argv + cache)
        msgs.append(str(e.value.code))
    assert msgs[0] == msgs[1]
    assert msgs[1] not in ("0", "None")


def test_surrogate_without_a_card_exits_non_zero(monkeypatch, capsys, tmp_path):
    """No fallback: the default device is the card, and without one the verb
    stops before any work, with the surrogate's own message."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        tcli.main(["surrogate", "heavy_tail", "--cache", str(tmp_path)])
    assert "no CUDA device" in str(e.value.code)
    assert not any(tmp_path.iterdir())
    assert capsys.readouterr().out == ""


def test_module_entry_point_refuses_without_a_card(tmp_path):
    """``python -m repro_torch.experiments surrogate`` as the chip smoke runs
    it: on a machine without a card and without ``--device cpu`` it exits
    non-zero."""
    import torch
    if torch.cuda.is_available():                      # pragma: no cover
        pytest.skip("a card is present: the verb would run")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.experiments", "surrogate", "--shape", "20x2",
         "--seeds", "0:8", "--cache", str(tmp_path)],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert proc.stdout == ""
