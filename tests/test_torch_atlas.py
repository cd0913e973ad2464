"""The regime atlas on the port alone (``repro_torch.experiments.regimes``),
on the CPU: ``tests/test_regimes.py`` with the port's modules — the grid
covers the acceptance floor, the fabric / replication / fault / SWIM axes
extend it and reuse the cache, the reports render, the adaptive-policy pins
hold on the quick sub-grid, and the latch-liveness wall holds under churn.
(``tests/test_torch_regimes.py`` holds the reports to the original's.)
"""
import dataclasses
import json

import pytest

from repro_torch.core.policies import PolicySpec
from repro_torch.core.tracing import LATCH_RELEASE_CAUSES
from repro_torch.core.types import ClusterSpec, TraceConfig
from repro_torch.experiments.regimes import (BASE_FABRIC, FABRICS, FULL_FABRICS,
                                             FULL_SHAPES, QUICK_SEEDS, QUICK_SHAPES,
                                             REGIME_PRESETS, SCHEDULERS, regime_spec,
                                             run_regimes, scaled_jobs)
from repro_torch.experiments.runner import (ExperimentSpec, TraceRef,
                                            run_experiment)
from repro_torch.experiments.stats import compare_throughput
from repro_torch.simcluster.largescale import fleet_shape
from repro_torch.simcluster.traces import PRESETS


def test_atlas_grid_covers_acceptance_floor():
    """≥5 presets x ≥2 shapes x 6 policy columns x ≥8 paired seeds, plus
    the remote-penalty fabric and HDFS replication axes."""
    assert len(REGIME_PRESETS) >= 5
    assert "saturated" in REGIME_PRESETS        # the §5 closed-mix bridge
    assert len(QUICK_SHAPES) >= 2 and len(FULL_SHAPES) >= 3
    assert set(SCHEDULERS) == {"proposed", "adaptive", "adaptive_ra",
                               "delay", "fair", "fifo"}
    # every atlas column is a default-spec registry preset: its cell
    # descriptor stays the bare name (cache-compatible) and it builds
    from repro_torch.core.policies import PolicySpec
    for s in SCHEDULERS:
        assert PolicySpec(s).cache_descriptor() == s
    from repro_torch.experiments.regimes import (FULL_REPLICATIONS, FULL_SEEDS,
                                                 BASE_REPLICATION)
    assert len(FULL_SEEDS) >= 8
    assert set(QUICK_SHAPES) <= set(FULL_SHAPES)   # quick is a sub-grid
    assert set(QUICK_SEEDS) <= set(FULL_SEEDS)
    assert set(FABRICS) == {"1GbE", "10GbE", "40GbE"}
    assert FABRICS[BASE_FABRIC] == 1.0
    assert set(FULL_FABRICS) <= set(FABRICS)
    # fabric scales decrease with link speed
    assert FABRICS["1GbE"] > FABRICS["10GbE"] > FABRICS["40GbE"]
    assert BASE_REPLICATION == 1 and 3 in FULL_REPLICATIONS


def test_scaled_jobs_tracks_fleet_size():
    assert scaled_jobs("heavy_tail", 20) == PRESETS["heavy_tail"].num_jobs
    assert scaled_jobs("heavy_tail", 100) == 5 * PRESETS["heavy_tail"].num_jobs
    assert scaled_jobs("heavy_tail", 10) == PRESETS["heavy_tail"].num_jobs


def test_fleet_shape_lookup():
    spec = fleet_shape("50x2")
    assert (spec.num_machines, spec.vms_per_machine) == (50, 2)
    assert spec.replication == 1
    with pytest.raises(ValueError, match="unknown fleet shape"):
        fleet_shape("30x7")


def test_regime_spec_pairs_all_schedulers():
    spec = regime_spec("bursty", "20x2", seeds=(0, 1))
    assert tuple(s.label for s in spec.schedulers) == SCHEDULERS
    assert spec.n_cells() == 1 * 1 * len(SCHEDULERS) * 2
    # trace seed coupled to sim seed: placements re-roll per replication
    ref = spec.traces[0]
    assert ref.seed is None
    assert ref.config.num_jobs == scaled_jobs("bursty", 20)
    # base fabric leaves the cluster untouched; others scale the penalty
    assert spec.clusters[0].remote_penalty_scale == 1.0
    assert spec.clusters[0].replication == 1
    fab = regime_spec("bursty", "20x2", seeds=(0,), fabric="10GbE")
    assert fab.clusters[0].remote_penalty_scale == FABRICS["10GbE"]
    r3 = regime_spec("bursty", "20x2", seeds=(0,), replication=3)
    assert r3.clusters[0].replication == 3


def test_run_regimes_report_and_cache(tmp_path):
    n = len(SCHEDULERS)
    report = run_regimes(presets=("mix_small",), shapes=("20x2",),
                         seeds=(0, 1), cache_dir=tmp_path / "cache",
                         n_boot=200)
    assert report.simulated == 2 * n and report.cached == 0
    (cell,) = report.cells
    assert cell.verdict() in ("win", "loss", "tie")
    assert cell.adaptive_verdict() in ("win", "loss", "tie")
    assert cell.ra_verdict() in ("win", "loss", "tie")
    assert cell.delay_verdict() in ("win", "loss", "tie")
    assert cell.fabric == BASE_FABRIC
    assert cell.replication == 1
    assert cell.vs_fair.n_pairs == 2 and cell.vs_fifo.n_pairs == 2
    assert cell.adaptive_vs_fair.n_pairs == 2
    assert cell.ra_vs_fair.n_pairs == 2 and cell.delay_vs_fair.n_pairs == 2
    assert set(cell.locality) == set(SCHEDULERS)
    assert all(0.0 <= v <= 1.0 for v in cell.deadline_frac.values())
    # rerun: pure cache hit
    again = run_regimes(presets=("mix_small",), shapes=("20x2",),
                        seeds=(0, 1), cache_dir=tmp_path / "cache",
                        n_boot=200)
    assert again.simulated == 0 and again.cached == 2 * n
    assert again.cells[0].to_dict() == cell.to_dict()
    # machine-readable report round-trips through JSON
    out = report.save_json(tmp_path / "report.json")
    loaded = json.loads(out.read_text())
    assert loaded["cells"][0]["throughput_vs_fair"]["ci_lo_pct"] \
        <= loaded["cells"][0]["throughput_vs_fair"]["ci_hi_pct"]
    assert loaded["cells"][0]["verdict"] == cell.verdict()
    assert loaded["cells"][0]["adaptive_verdict"] == cell.adaptive_verdict()
    assert loaded["cells"][0]["ra_verdict"] == cell.ra_verdict()
    assert loaded["cells"][0]["delay_verdict"] == cell.delay_verdict()
    assert loaded["fabrics"] == ["1GbE"]
    assert loaded["replications"] == [1]
    # renders
    assert "adapt" in report.format()
    md = report.to_markdown()
    assert md.startswith("| regime |") and "mix_small" in md
    assert "adaptive vs fair" in md
    assert "adaptive_ra vs fair" in md and "delay vs fair" in md


def test_fabric_axis_extends_grid_and_reuses_cache(tmp_path):
    n = len(SCHEDULERS)
    base = run_regimes(presets=("mix_small",), shapes=("20x2",),
                       seeds=(0,), cache_dir=tmp_path / "cache", n_boot=100)
    assert base.simulated == n
    fab = run_regimes(presets=("mix_small",), shapes=("20x2",),
                      seeds=(0,), fabrics=("10GbE",),
                      cache_dir=tmp_path / "cache", n_boot=100)
    # base cells reused; only the 10GbE cell simulates
    assert fab.simulated == n and fab.cached == n
    assert [c.fabric for c in fab.cells] == ["1GbE", "10GbE"]
    assert fab.fabrics == ("1GbE", "10GbE")
    assert fab.cell("mix_small", "20x2", "10GbE").fabric == "10GbE"
    with pytest.raises(KeyError):
        fab.cell("mix_small", "20x2", "40GbE")
    with pytest.raises(ValueError, match="unknown fabric"):
        run_regimes(presets=("mix_small",), shapes=("20x2",), seeds=(0,),
                    fabrics=("100GbE",), cache_dir=tmp_path / "cache")


def test_replication_axis_extends_grid_and_reuses_cache(tmp_path):
    n = len(SCHEDULERS)
    base = run_regimes(presets=("mix_small",), shapes=("20x2",),
                       seeds=(0,), cache_dir=tmp_path / "cache", n_boot=100)
    assert base.simulated == n
    r3 = run_regimes(presets=("mix_small",), shapes=("20x2",),
                     seeds=(0,), replications=(3,),
                     cache_dir=tmp_path / "cache", n_boot=100)
    # base cells reused; only the replication-3 cell simulates
    assert r3.simulated == n and r3.cached == n
    assert [c.replication for c in r3.cells] == [1, 3]
    assert r3.replications == (1, 3)
    cell = r3.cell("mix_small", "20x2", replication=3)
    assert cell.replication == 3 and cell.fabric == BASE_FABRIC
    with pytest.raises(KeyError):
        r3.cell("mix_small", "20x2", replication=2)
    with pytest.raises(ValueError, match="replication"):
        run_regimes(presets=("mix_small",), shapes=("20x2",), seeds=(0,),
                    replications=(0,), cache_dir=tmp_path / "cache")


def test_fault_axis_extends_grid_and_reuses_cache(tmp_path):
    n = len(SCHEDULERS)
    base = run_regimes(presets=("mix_small",), shapes=("20x2",),
                       seeds=(0,), cache_dir=tmp_path / "cache", n_boot=100)
    assert base.simulated == n
    churn = run_regimes(presets=("mix_small",), shapes=("20x2",),
                        seeds=(0,), faults=("churn_hi",),
                        cache_dir=tmp_path / "cache", n_boot=100)
    # base cells reused; only the churn cell simulates (fault cells keep
    # their own cache keys: FaultConfig lands in the cluster descriptor)
    assert churn.simulated == n and churn.cached == n
    assert [c.faults for c in churn.cells] == ["none", "churn_hi"]
    assert churn.fault_profiles == ("none", "churn_hi")
    cell = churn.cell("mix_small", "20x2", faults="churn_hi")
    assert cell.faults == "churn_hi" and cell.fabric == BASE_FABRIC
    assert cell.to_dict()["faults"] == "churn_hi"
    with pytest.raises(KeyError):
        churn.cell("mix_small", "20x2", faults="churn_lo")
    with pytest.raises(ValueError, match="unknown fault profile"):
        run_regimes(presets=("mix_small",), shapes=("20x2",), seeds=(0,),
                    faults=("meteor",), cache_dir=tmp_path / "cache")
    # renders with the faults column
    assert "| faults |" in churn.to_markdown()


def test_fault_profiles_cover_acceptance_axes():
    """The atlas faults axis spans a crash-rate axis and a heterogeneity
    axis, and the base profile is the disabled default (so base cells'
    cache hashes are untouched by the fault layer)."""
    from repro_torch.core.types import FaultConfig
    from repro_torch.experiments.regimes import (BASE_FAULTS, FAULT_PROFILES,
                                                 FAULT_SHAPES, FULL_FAULTS)
    assert FAULT_PROFILES[BASE_FAULTS] == FaultConfig()
    assert len(FULL_FAULTS) >= 2
    rates = {FAULT_PROFILES[f].crash_mtbf
             for f in FULL_FAULTS if not FAULT_PROFILES[f].machine_classes}
    assert len(rates) >= 2                      # crash-rate axis
    assert any(FAULT_PROFILES[f].machine_classes
               for f in FULL_FAULTS)            # heterogeneity axis
    assert set(FAULT_SHAPES) <= set(FULL_SHAPES)
    spec = regime_spec("mix_small", "20x2", seeds=(0,), faults="churn_hi")
    assert spec.clusters[0].faults == FAULT_PROFILES["churn_hi"]
    assert spec.name.endswith("-churn_hi")


def test_swim_trace_column(tmp_path):
    """The SWIM-derived trace is a first-class atlas column: committed
    fixture, importable, cache-reusing, and rendered like any preset."""
    from repro_torch.experiments.regimes import SWIM_TRACES, scaled_jobs
    from repro_torch.simcluster.traces import Trace
    path = SWIM_TRACES["swim_fb"]
    assert path.exists()
    trace = Trace.load(path)
    assert len(trace.jobs) >= 50
    assert scaled_jobs("swim_fb", 20) == len(trace.jobs)
    n = len(SCHEDULERS)
    report = run_regimes(presets=(), shapes=("20x2",), seeds=(0,),
                         swim=("swim_fb",), cache_dir=tmp_path / "cache",
                         n_boot=100)
    assert report.simulated == n
    assert report.swim == ("swim_fb",)
    cell = report.cell("swim_fb", "20x2")
    assert cell.verdict() in ("win", "loss", "tie")
    assert "swim_fb" in report.to_markdown()
    with pytest.raises(ValueError, match="unknown SWIM trace"):
        run_regimes(presets=(), shapes=("20x2",), seeds=(0,),
                    swim=("swim_yahoo",), cache_dir=tmp_path / "cache")


# -- the flipped loss cell must not silently regress -------------------------

@pytest.fixture(scope="module")
def quick_cells(tmp_path_factory):
    """The --quick-compatible diurnal/20x2 cell, the paper closed mix, and
    the shuffle_heavy/20x2 cell, simulated once for the regression pins
    below."""
    cache = tmp_path_factory.mktemp("atlas-cache")
    diurnal = ExperimentSpec(
        name="pin-diurnal",
        traces=(regime_spec("diurnal", "20x2").traces[0],),
        clusters=(fleet_shape("20x2"),),
        schedulers=("proposed", "adaptive", "fair"),
        seeds=QUICK_SEEDS,
    )
    paper = ExperimentSpec(
        name="pin-paper",
        traces=(TraceRef(preset="paper"),),
        clusters=(ClusterSpec(replication=1),),
        schedulers=("proposed", "adaptive", "fair"),
        seeds=QUICK_SEEDS,
    )
    shuffle = ExperimentSpec(
        name="pin-shuffle",
        traces=(regime_spec("shuffle_heavy", "20x2").traces[0],),
        clusters=(fleet_shape("20x2"),),
        schedulers=("adaptive", "adaptive_ra", "fair"),
        seeds=QUICK_SEEDS,
    )
    return (run_experiment(diurnal, cache).by_scheduler(),
            run_experiment(paper, cache).by_scheduler(),
            run_experiment(shuffle, cache).by_scheduler())


def test_adaptive_flips_diurnal_loss_cell(quick_cells):
    """On the diurnal/20x2 loss cell the adaptive policy must beat the
    fixed policy outright and sit within noise of Fair (the committed
    8-seed atlas shows the full flip; this pin is the fast canary)."""
    by, _, _ = quick_cells
    vs_proposed = compare_throughput(by["proposed"], by["adaptive"])
    vs_fair = compare_throughput(by["fair"], by["adaptive"])
    assert vs_proposed.mean_gain_pct > 5.0     # measured ~+12.6%
    assert vs_fair.mean_gain_pct > -3.0        # measured ~-0.7%


def test_adaptive_preserves_closed_mix_win(quick_cells):
    """On the paper's closed mix the adaptive policy must keep the
    throughput win over Fair (the latch and gates must never fire there)
    and stay within noise of the fixed policy."""
    _, by, _ = quick_cells
    vs_fair = compare_throughput(by["fair"], by["adaptive"])
    vs_proposed = compare_throughput(by["proposed"], by["adaptive"])
    assert vs_fair.mean_gain_pct > 10.0        # measured ~+22.1%
    assert vs_proposed.mean_gain_pct > -30.0   # measured ~-15%, noisy cell


def test_reduce_aware_latch_fixes_shuffle_heavy_cell(quick_cells):
    """The adaptive_ra policy (reduce-aware overload latch + map-open crowd
    bar) must keep the shuffle_heavy/20x2 cell recovered: on the full grid
    it turns plain adaptive's loss vs Fair into a tie (8-seed: adaptive
    -4.4% [-6.5, -2.3] vs adaptive_ra -2.6% [-7.2, +1.5]).  Since the
    win-aware latch (wide-batch exemption + win_release) also unwedged the
    plain latch here, adaptive_ra's edge over it is within noise on this
    2-seed sub-grid — the pin only requires it never falls meaningfully
    behind, and that it still recovers strictly more locality."""
    _, _, by = quick_cells
    vs_adaptive = compare_throughput(by["adaptive"], by["adaptive_ra"])
    vs_fair = compare_throughput(by["fair"], by["adaptive_ra"])
    assert vs_adaptive.mean_gain_pct > -3.0    # measured ~-0.7% (quick),
    #                                            ~+1.6% on the full grid
    assert vs_fair.mean_gain_pct > -8.0        # measured ~-5.2% (quick,
    #                                            noisy; full grid ~-2.6%)
    # the reduce-aware variant must also recover locality, not just trade
    # it away: strictly more data-local launches than the plain latch
    loc_ra = sum(r.locality_rate for r in by["adaptive_ra"])
    loc_ad = sum(r.locality_rate for r in by["adaptive"])
    assert loc_ra >= loc_ad


# -- win-aware latch + churn relief: liveness wall and verdict pins -----------

LIVENESS_SEEDS = tuple(range(12))


def _traced_cell_run(preset, shape, policy, seed, faults):
    """One atlas cell run with the decision-trace bus on: the exact cell
    spec the atlas would sweep, one policy column, one seed."""
    from repro_torch.simcluster.sim import ClusterSim
    spec = regime_spec(preset, shape, seeds=(seed,), faults=faults)
    cluster = dataclasses.replace(
        spec.clusters[0],
        tracing=TraceConfig(enabled=True, launches=True, parks=True,
                            overload=True, faults=True))
    sched = PolicySpec.parse(policy).build(cluster)
    jobs = spec.traces[0].resolve(seed).job_specs(cluster)
    sim = ClusterSim(cluster, sched, seed=seed,
                     straggler_prob=spec.straggler_prob,
                     straggler_factor=spec.straggler_factor,
                     speculative=spec.speculative,
                     speculation_threshold=spec.speculation_threshold)
    return sim.run(jobs)


@pytest.mark.parametrize("policy", SCHEDULERS)
def test_latch_liveness_under_churn(policy):
    """Latch-liveness wall: every atlas policy column, churn_hi, 12 seeds.

    The property is twofold.  (1) Liveness proper: every attempt the run
    launches is resolved (finish or crash kill) — the latch may delay work
    but can never strand it, even on a fleet that crashes every ~60s.
    (2) The churn-relief standdown: on a crash-configured fleet the
    adaptive columns must never trip the overload latch at all (and so
    never deny a park behind it) — the latch misreading churn re-pends as
    an overload surge is exactly how pre-PR-8 adaptive surrendered the
    fixed policy's re-replication wins."""
    adaptive_cols = ("adaptive", "adaptive_ra")
    for seed in LIVENESS_SEEDS:
        res = _traced_cell_run("bursty", "20x2", policy, seed, "churn_hi")
        bus = res.trace
        assert bus.count("crash") > 0, "churn profile did not crash"
        assert bus.count("launch") == bus.count("finish") + bus.count("kill")
        if policy in adaptive_cols:
            assert bus.count("latch_trip") == 0
            assert all(d["gate"] != "overload_latch"
                       for _, k, d in bus.events if k == "park_deny")
        else:                      # no latch machinery in these columns
            assert bus.count("latch_trip") == 0
            assert bus.count("latch_release") == 0


def test_prechurn_latch_trips_but_never_wedges():
    """Ablation column (``crash_discount`` off — the pre-PR-8 churn latch):
    the latch does trip under churn, every release names a registered
    cause, and the win-aware release actually fires somewhere on the wall
    (the wide-batch signal is live, not vacuous).  A run may *end* latched
    — the plain latch's release is observed by the next arrival, and the
    tail drain has none — but liveness still holds: every attempt
    resolves, every job finishes."""
    abl = PolicySpec("adaptive", params={"crash_discount": False})
    trips = 0
    causes = set()
    for seed in LIVENESS_SEEDS:
        res = _traced_cell_run("heavy_tail", "20x2", abl, seed, "churn_hi")
        bus = res.trace
        assert bus.count("launch") == bus.count("finish") + bus.count("kill")
        trips += bus.count("latch_trip")
        causes |= {d["cause"] for _, k, d in bus.events
                   if k == "latch_release"}
    assert trips > 0
    assert causes and causes <= set(LATCH_RELEASE_CAUSES)
    assert "win_release" in causes


@pytest.fixture(scope="module")
def flip_cells(tmp_path_factory):
    """The two verdict cells the win-aware latch flips, at quick scale:
    the saturated closed mix at 50x2 (no faults) and saturated/20x2 under
    churn_hi."""
    cache = tmp_path_factory.mktemp("atlas-cache-pr8")
    sat = dataclasses.replace(
        regime_spec("saturated", "50x2", seeds=QUICK_SEEDS),
        name="pin-sat50", schedulers=("proposed", "adaptive", "fair"))
    churn = dataclasses.replace(
        regime_spec("saturated", "20x2", seeds=QUICK_SEEDS,
                    faults="churn_hi"),
        name="pin-sat20-churn", schedulers=("proposed", "adaptive", "fair"))
    return (run_experiment(sat, cache).by_scheduler(),
            run_experiment(churn, cache).by_scheduler())


def test_saturated_closed_mix_recovers_parking_win(flip_cells):
    """Win-aware latch pin, wide-batch side: on saturated/50x2 the adaptive
    column no longer surrenders the parking win to exact-Fair (+0.0): the
    wide-batch trip exemption and gate standdown recover most of the fixed
    policy's win (committed 8-seed atlas: adaptive +4.8% [+2.8, +7.1] vs
    Fair with proposed at +6.2% — 77% recovery, CI clear of zero)."""
    by, _ = flip_cells
    vs_fair = compare_throughput(by["fair"], by["adaptive"])
    vs_proposed = compare_throughput(by["proposed"], by["adaptive"])
    assert vs_fair.mean_gain_pct > 5.0         # measured ~+8.6% (quick)
    assert vs_proposed.mean_gain_pct > -3.0    # measured ~-1.1% (quick)


def test_churn_relief_never_loses_to_fixed(flip_cells):
    """Churn-relief pin: under churn_hi the relief stands every adaptive
    gate down from t=0 (crash-configured fleet), so the adaptive column
    replays the fixed policy's decisions bit-for-bit and the paired gain
    is exactly zero (the full 8-seed wall: +0.0 [+0.0, +0.0] on all five
    presets).  Any drift from 0.0 here means an adaptive code path fired
    mid-churn that the relief was supposed to stand down."""
    _, by = flip_cells
    vs_proposed = compare_throughput(by["proposed"], by["adaptive"])
    assert vs_proposed.mean_gain_pct == pytest.approx(0.0, abs=1e-9)
    # and standing down must not cost the churn win over Fair
    vs_fair = compare_throughput(by["fair"], by["adaptive"])
    assert vs_fair.mean_gain_pct > -3.0        # measured ~+1.6% (quick)
