"""The surrogate's calibration on the port alone (M10b), on the CPU.

* The SWIM importer and its fixtures: the port reads its own copy.
* The atlas grids: ``regime_spec`` builds the original's descriptors.
* ``run_experiment``: inline and pooled runs agree, and one cache serves
  both packages (the event cells hash alike, so either re-serves the
  other's with zero cells simulated).
* ``calibrate(..., device="cpu")``: the port's event engine as the oracle
  and the fluid surrogate's plain version; every ``CALIBRATED`` pair is
  ``wall_green``, with the JAX package's CIs and gains.

On the card ``chip_smoke.py`` runs the same calibration with K3 integrating
the surrogate side.
"""
import dataclasses
import inspect
import json

import pytest

import repro.experiments.regimes as jregimes
import repro.experiments.runner as jrunner
import repro.experiments.surrogate as jexp
import repro.simcluster.traces as jtraces
import repro_torch.experiments.regimes as tregimes
import repro_torch.experiments.runner as trunner
import repro_torch.experiments.surrogate as texp
import repro_torch.simcluster.traces as ttraces
from repro_torch.simcluster import largescale as tlarge


def _strip(record):
    d = record.to_dict()
    d.pop("wall_time_s")
    return json.dumps(d, sort_keys=True)


# ---------------------------------------------------------------------------
# SWIM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("suffix", ["log", "jsonl"])
def test_swim_fixtures_are_the_port_s_own_byte_equal_copies(suffix):
    port = tregimes._DATA_DIR / f"swim_fb_sample.{suffix}"
    orig = jregimes._DATA_DIR / f"swim_fb_sample.{suffix}"
    assert "repro_torch" in port.parts and "repro_torch" not in orig.parts
    assert port.read_bytes() == orig.read_bytes()
    assert tregimes.SWIM_TRACES["swim_fb"] == tregimes._DATA_DIR / "swim_fb_sample.jsonl"


@pytest.mark.parametrize("kwargs", [{}, {"deadline_slack": 3.0, "skew": 0.5},
                                    {"max_jobs": 17, "name": "fb17"}])
def test_swim_import_gives_the_original_s_jsonl(kwargs):
    log = tregimes._DATA_DIR / "swim_fb_sample.log"
    text = ttraces.import_swim_file(log, **kwargs).to_jsonl()
    assert text == jtraces.import_swim_file(jregimes._DATA_DIR / "swim_fb_sample.log",
                                            **kwargs).to_jsonl()
    if not kwargs:
        # the committed trace is this import, byte for byte
        assert text == tregimes.SWIM_TRACES["swim_fb"].read_text()
    assert ttraces.SWIM_SIGNATURES == jtraces.SWIM_SIGNATURES
    assert ttraces.classify_swim_workload(1e9, 4e9, 1.5e9) == "permutation"


@pytest.mark.parametrize("bad", ["", "# only a comment\n", "job 1 2 3\n",
                                 "j -1 0 1 2 3\n", '{"a": 1}\n'])
def test_swim_import_rejects_what_the_original_rejects(bad):
    with pytest.raises(ttraces.TraceImportError) as t:
        ttraces.import_swim(bad)
    with pytest.raises(jtraces.TraceImportError) as j:
        jtraces.import_swim(bad)
    assert str(t.value) == str(j.value)
    assert isinstance(t.value, ValueError)


# ---------------------------------------------------------------------------
# the atlas grids
# ---------------------------------------------------------------------------

def _descriptors(spec):
    return [c.descriptor() for c in spec.cells()], spec.name, \
        [s.label for s in spec.schedulers]


def test_regime_constants_equal_the_original():
    for name in ("REGIME_PRESETS", "FULL_SHAPES", "QUICK_SHAPES", "FULL_SEEDS",
                 "QUICK_SEEDS", "SCHEDULERS", "FABRICS", "BASE_FABRIC", "FULL_FABRICS",
                 "BASE_REPLICATION", "FULL_REPLICATIONS", "BASE_FAULTS", "FULL_FAULTS",
                 "FAULT_SHAPES", "SERVE_PROFILES", "SERVE_SHAPES", "FULL_SERVE",
                 "SERVE_SCHEDULERS", "SERVE_PRESET", "FULL_SWIM", "REPORT_VERSION"):
        assert getattr(tregimes, name) == getattr(jregimes, name), name
    assert {k: v.to_dict() for k, v in tregimes.FAULT_PROFILES.items()} == \
        {k: v.to_dict() for k, v in jregimes.FAULT_PROFILES.items()}
    for name in tregimes.SERVE_PROFILES:
        for machines in (6, 20, 50, 100):
            assert tregimes.serve_profile(name, machines).to_dict() == \
                jregimes.serve_profile(name, machines).to_dict()
    with pytest.raises(ValueError, match="unknown serve profile"):
        tregimes.serve_profile("nope", 20)


@pytest.mark.parametrize("shape", list(tlarge.FLEET_SHAPES))
def test_regime_spec_descriptors_equal_the_original(shape):
    presets = tregimes.REGIME_PRESETS + ("mix_small",) + tuple(tregimes.SWIM_TRACES)
    for preset in presets:
        machines = tlarge.FLEET_SHAPES[shape][0]
        assert tregimes.scaled_jobs(preset, machines) == jregimes.scaled_jobs(preset, machines)
        variants = [{}, {"seeds": (0, 5)}, {"replication": 3}]
        variants += [{"fabric": f} for f in tregimes.FABRICS]
        variants += [{"faults": f} for f in tregimes.FAULT_PROFILES]
        for kw in variants:
            assert _descriptors(tregimes.regime_spec(preset, shape, **kw)) == \
                _descriptors(jregimes.regime_spec(preset, shape, **kw)), (preset, kw)


# ---------------------------------------------------------------------------
# run_experiment: the pool, and one cache for both packages
# ---------------------------------------------------------------------------

def _grid(runner):
    return runner.ExperimentSpec(
        name="cal-grid", traces=(runner.TraceRef(preset="mix_small"),
                                 runner.TraceRef(preset="heavy_tail", seed=3)),
        clusters=(runner.ClusterSpec(num_machines=6, vms_per_machine=2),),
        schedulers=("proposed", "adaptive", "fair"), seeds=(0, 1))


def test_pooled_and_inline_records_are_equal(tmp_path):
    """``spawn`` workers hash strings with their own seeds: the records must
    not depend on it."""
    inline = trunner.run_experiment(_grid(trunner), tmp_path / "a", workers=0)
    pooled = trunner.run_experiment(_grid(trunner), tmp_path / "b", workers=2)
    assert inline.simulated == pooled.simulated == 12
    assert [_strip(r) for r in inline.records] == [_strip(r) for r in pooled.records]
    assert sorted(p.name for p in (tmp_path / "a").iterdir()) == \
        sorted(p.name for p in (tmp_path / "b").iterdir())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_one_cache_serves_both_packages(writer, tmp_path):
    first, second = (jrunner, trunner) if writer == "jax" else (trunner, jrunner)
    wrote = first.run_experiment(_grid(first), tmp_path)
    assert (wrote.simulated, wrote.cached) == (12, 0)
    read = second.run_experiment(_grid(second), tmp_path)
    assert (read.simulated, read.cached) == (0, 12)
    assert [_strip(r) for r in read.records] == [_strip(r) for r in wrote.records]
    # and what the reader would have simulated is what the writer stored
    fresh = second.run_experiment(_grid(second), tmp_path / "fresh")
    assert [_strip(r) for r in fresh.records] == [_strip(r) for r in wrote.records]


# ---------------------------------------------------------------------------
# calibrate, on the port alone
# ---------------------------------------------------------------------------

def test_calibrate_defaults_to_the_card(monkeypatch, tmp_path):
    assert inspect.signature(texp.calibrate).parameters["device"].default == "cuda"
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_oracle(*a, **k):
        raise AssertionError("the oracle ran before the device was checked")

    monkeypatch.setattr(texp, "run_experiment", no_oracle)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        texp.calibrate("heavy_tail", "20x2", tmp_path)
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("preset,shape", sorted(texp.CALIBRATED))
def test_calibrate_on_the_port_is_wall_green(preset, shape, tmp_path):
    report = texp.calibrate(preset, shape, tmp_path / "port", device="cpu")
    ref = jexp.calibrate(preset, shape, tmp_path / "jax")
    assert report.wall_green, [(p.policy, p.surrogate_gain_pct, p.oracle.ci_lo_pct,
                                p.oracle.ci_hi_pct) for p in report.policies]
    assert (report.preset, report.shape, report.seeds) == (ref.preset, ref.shape, ref.seeds)
    assert [p.policy for p in report.policies] == list(texp.CALIBRATED[(preset, shape)])
    for p, q in zip(report.policies, ref.policies, strict=True):
        assert p.policy == q.policy and p.allowlisted and q.allowlisted
        assert dataclasses.asdict(p.oracle) == dataclasses.asdict(q.oracle)
        assert p.surrogate_gain_pct == q.surrogate_gain_pct
        assert p.inside
    # both engines wrote into one cache directory, in disjoint namespaces;
    # a second run re-serves every cell of both
    again = texp.calibrate(preset, shape, tmp_path / "port", device="cpu")
    assert [dataclasses.asdict(p) for p in again.policies] == \
        [dataclasses.asdict(p) for p in report.policies]
    n_cells = len(texp.CALIBRATION_SEEDS) * (len(report.policies) + 1)
    assert sum(1 for _ in (tmp_path / "port").rglob("seed*.json")) == 2 * n_cells
