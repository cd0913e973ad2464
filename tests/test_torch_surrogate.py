"""The port's fluid surrogate (M10) against the JAX package's, on the CPU.

* The copied modules (cluster specs, traces, the policy registry) give the
  original's values, byte for byte where they are serialized.
* ``build_cell`` and ``pack_cell`` give the original's arrays, bit for bit.
* The engine (the CUDA kernel's plain version on the CPU) gives the
  original's finish time for every job of 110 cells, and its counts; the
  launch masses, the locality rate and the per-step diagnostics agree to
  rounding (tolerances below, with their reason).
* The determinism contract of ``simcluster/surrogate.py`` holds: the port's
  copies of the original's pins.
* The calibration wall holds through the port: for every ``CALIBRATED``
  pair, each allowlisted policy's gain over ``fair`` from the port's
  ``run_surrogate`` lies inside the paired CI of the JAX package's event
  engine, and equals the JAX surrogate's gain.
* The cache, the device default and the kernel wrapper's input checks.

The kernel itself runs only on the card: ``chip_smoke.py`` holds it to this
plain version there.
"""
import dataclasses
import inspect
import json
import re

import numpy as np
import pytest
import torch

import repro.core.policies as jpol
import repro.core.types as jtypes
import repro.experiments.runner as jrunner
import repro.experiments.surrogate as jexp
import repro.simcluster.surrogate as jsur
import repro.simcluster.traces as jtraces
from repro.experiments.regimes import regime_spec
from repro.experiments.stats import compare_throughput as jax_compare_throughput
import repro_torch.core.policies as tpol
import repro_torch.core.types as ttypes
import repro_torch.experiments.runner as trunner
import repro_torch.experiments.surrogate as texp
import repro_torch.simcluster.surrogate as tsur
import repro_torch.simcluster.traces as ttraces
from repro_torch import spans
from repro_torch.experiments.stats import compare_throughput
from repro_torch.kernels import _build
from repro_torch.kernels.fluid_scan import kernel as k3
from repro_torch.kernels.fluid_scan import ops as fluid_ops
from repro_torch.kernels.fluid_scan import ref as k3ref

SUPPORTED = ["proposed", "fair", "fifo", "delay", "edf_nopark"]
CAL_PRESETS = ["heavy_tail", "diurnal", "bursty", "shuffle_heavy", "saturated"]
# launch masses and diagnostics: 1e-5 of their scale (see the parity fixture)
MASS_RTOL = 1e-5
LOCALITY_ATOL = 1e-6


def _fleet(mod, machines=20):
    return mod.ClusterSpec(num_machines=machines, vms_per_machine=2, replication=1)


def _cells(preset, seeds, machines=20):
    """The same cells through both packages: (jax cells, port cells)."""
    jc, tc = [], []
    for s in seeds:
        jt = jtraces.generate_trace(jtraces.PRESETS[preset], s)
        tt = ttraces.generate_trace(ttraces.PRESETS[preset], s)
        for p in SUPPORTED:
            jc.append(jsur.build_cell(jt, _fleet(jtypes, machines), p, s))
            tc.append(tsur.build_cell(tt, _fleet(ttypes, machines), p, s))
    return jc, tc


# ---------------------------------------------------------------------------
# the copies against their originals
# ---------------------------------------------------------------------------

def _specs(mod):
    """A default, a fault and a serving cluster, and one with adaptive
    overrides, built alike from either package's types."""
    faults = mod.FaultConfig(enabled=True, crash_mtbf=900.0, burst_rate=300.0,
                             machine_classes=(mod.MachineClass("old", weight=3, speed=1.3),
                                              mod.MachineClass("new", fabric=0.5)))
    serve = mod.ServeConfig(enabled=True, services=(
        mod.ServiceSpec(name="api", replicas=3, base_rps=20.0, diurnal_amplitude=0.4),))
    adaptive = mod.AdaptiveConfig(enabled=True, surge_width=0.0, overload_active_factor=0.7)
    return [mod.ClusterSpec(), mod.ClusterSpec(num_machines=50, faults=faults),
            mod.ClusterSpec(serve=serve, tracing=mod.TraceConfig(enabled=True)),
            mod.ClusterSpec(adaptive=adaptive, remote_penalty_scale=0.25)]


def test_cluster_spec_to_dict_equals_the_original():
    for j, t in zip(_specs(jtypes), _specs(ttypes)):
        d = t.to_dict()
        assert d == j.to_dict()
        assert json.dumps(d, sort_keys=True) == json.dumps(j.to_dict(), sort_keys=True)
        # tracing is a pure observer and always left out of the dict
        assert ttypes.ClusterSpec.from_dict(d) == dataclasses.replace(
            t, tracing=ttypes.TraceConfig())
        assert t.num_nodes == j.num_nodes


@pytest.mark.parametrize("preset", sorted(jtraces.PRESETS))
def test_generated_traces_are_byte_equal(preset):
    assert sorted(ttraces.PRESETS) == sorted(jtraces.PRESETS)
    for seed in (0, 1, 7):
        text = ttraces.generate_trace(ttraces.PRESETS[preset], seed).to_jsonl()
        assert text == jtraces.generate_trace(jtraces.PRESETS[preset], seed).to_jsonl()
        assert ttraces.Trace.from_jsonl(text).to_jsonl() == text


def test_paper_trace_and_rows_are_equal():
    for seed in (0, 3):
        assert ttraces.paper_trace(seed).to_jsonl() == jtraces.paper_trace(seed).to_jsonl()
    rows = [("grep", 2.0, 300.0, 0.0), ("sort", 4.5, 600.0, 12.5)]
    assert ttraces.trace_from_rows("r", rows, seed=5).to_jsonl() == \
        jtraces.trace_from_rows("r", rows, seed=5).to_jsonl()
    # replayed against a cluster: the same job specs, block placements included
    for t, j in zip(ttraces.paper_trace(2).job_specs(_fleet(ttypes)),
                    jtraces.paper_trace(2).job_specs(_fleet(jtypes))):
        assert t.to_dict() == j.to_dict()


@pytest.mark.parametrize("name", list(jpol.registered_policies()))
def test_policy_specs_equal_the_original(name):
    assert list(tpol.registered_policies()) == list(jpol.registered_policies())
    assert tpol.COMPONENT_AXES == jpol.COMPONENT_AXES
    t, j = tpol.PolicySpec.parse(name), jpol.PolicySpec.parse(name)
    assert t.cache_key() == j.cache_key()
    assert t.cache_descriptor() == j.cache_descriptor()
    assert t.components == j.components
    assert t.effective_params() == j.effective_params()
    assert t.label == j.label and t.to_dict() == j.to_dict()
    assert tpol.get_policy(name).description == jpol.get_policy(name).description
    # with an override of the first parameter: the same canonical form
    defaults = t.effective_params()
    if defaults:
        key = sorted(defaults)[0]
        value = defaults[key]
        other = (not value) if isinstance(value, bool) else value * 2 + 1
        spec = {"name": name, "params": {key: other}}
        assert tpol.PolicySpec.parse(json.dumps(spec)).cache_key() == \
            jpol.PolicySpec.parse(json.dumps(spec)).cache_key()
    with pytest.raises(tpol.PolicyError):
        tpol.PolicySpec(name, {"no_such_param": 1})


def test_partition_and_typed_rejections():
    supported, rejected = tpol.partition_policies(tsur.surrogate_supported)
    assert supported == SUPPORTED
    assert rejected == ["adaptive", "adaptive_ra", "harvest"]
    assert (supported, rejected) == jpol.partition_policies(jsur.surrogate_supported)
    for name in rejected:
        with pytest.raises(tsur.SurrogateUnsupported) as exc:
            tsur.lower_policy(tpol.PolicySpec.parse(name))
        assert exc.value.axis in ("park", "overload")
        assert exc.value.label == name
        assert isinstance(exc.value, ValueError)
    for name in supported:
        assert dataclasses.asdict(tsur.lower_policy(name)) == \
            dataclasses.asdict(jsur.lower_policy(name))


def test_constants_are_the_original_s():
    for name in ("DT", "PARK_SUCCESS", "PARK_WAIT", "PARK_CROWD_PENALTY",
                 "PARK_WAIT_CROWD", "REPARK_CROWD", "SAT_LO", "SAT_WIDTH",
                 "LOCALITY_DRAWS", "DELAY_BOOST", "DELAY_REMOTE_WAIT",
                 "NET_CONTENTION", "TAIL_INFLATION", "_FAIR_ITERS", "_RING",
                 "_EPS", "_INF", "SUPPORTED_COMPONENTS", "_JOB_FIELDS",
                 "_SCALAR_FIELDS"):
        assert getattr(tsur, name) == getattr(jsur, name), name
    assert tsur._RING == k3ref.RING
    assert tsur.SURROGATE_ENGINE_ID == jsur.SURROGATE_ENGINE_ID + "-torch"


@pytest.mark.parametrize("preset", CAL_PRESETS + ["mix_small"])
def test_build_and_pack_cell_are_bit_equal(preset):
    machines = 6 if preset == "mix_small" else 20
    jc, tc = _cells(preset, (0, 2), machines)
    for j, t in zip(jc, tc):
        for f in dataclasses.fields(j):
            a, b = getattr(j, f.name), getattr(t, f.name)
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype and np.array_equal(a, b), f.name
            elif f.name == "policy":
                assert dataclasses.asdict(a) == dataclasses.asdict(b)
            else:
                assert a == b, f.name
        pj, pt = jsur.pack_cell(j), tsur.pack_cell(t)
        assert list(pj) == list(pt)
        for k in pj:
            assert pj[k].dtype == pt[k].dtype and np.array_equal(pj[k], pt[k]), k
        assert (t.padded_jobs(), t.n_steps()) == (j.padded_jobs(), j.n_steps())
        # the static priority order: jnp.argsort's (stable) on the same keys
        order = tsur.priority_order(pt["prio_key"])
        assert np.array_equal(order, np.argsort(pj["prio_key"], kind="stable"))


# ---------------------------------------------------------------------------
# the engine against the original
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def parity():
    """110 cells (the five calibration presets at 20x2, seeds 0-3, and
    mix_small at 6x2, seeds 0-1, each under the five supported policies)
    through the JAX package's run_batch and the port's on the CPU, once."""
    jc, tc, presets = [], [], []
    for preset, seeds, machines in [(p, range(4), 20) for p in CAL_PRESETS] \
            + [("mix_small", range(2), 6)]:
        a, b = _cells(preset, seeds, machines)
        jc += a
        tc += b
        presets += [preset] * len(a)
    return presets, tc, jsur.run_batch(jc), tsur.run_batch(tc, device="cpu")


def _by_preset(parity, preset):
    presets, cells, ref, out = parity
    rows = [i for i, p in enumerate(presets) if p == preset]
    assert rows
    return [(cells[i], ref[i], out[i]) for i in rows]


PARITY_PRESETS = CAL_PRESETS + ["mix_small"]


@pytest.mark.parametrize("preset", PARITY_PRESETS)
def test_every_finish_time_equals_the_original(preset, parity):
    for cell, ref, out in _by_preset(parity, preset):
        assert [j.job_id for j in out.jobs] == [j.job_id for j in ref.jobs]
        assert [j.finish_time for j in out.jobs] == [j.finish_time for j in ref.jobs], \
            cell.policy
        assert [j.completion_time for j in out.jobs] == \
            [j.completion_time for j in ref.jobs]
        assert out.makespan == ref.makespan


@pytest.mark.parametrize("preset", PARITY_PRESETS)
def test_counts_equal_the_original(preset, parity):
    for _, ref, out in _by_preset(parity, preset):
        assert (out.jobs_total, out.jobs_finished, out.deadlines_met) == \
            (ref.jobs_total, ref.jobs_finished, ref.deadlines_met)
        assert [j.deadline_met for j in out.jobs] == [j.deadline_met for j in ref.jobs]
        assert out.latched_steps == ref.latched_steps
        assert out.throughput_jobs_per_hour() == ref.throughput_jobs_per_hour()


@pytest.mark.parametrize("preset", PARITY_PRESETS)
def test_locality_and_launch_mass_agree(preset, parity):
    """The locality rate within 1e-6; each job's local and remote launch mass
    within 1e-5 of the job's launched map mass (local + remote).  Not of each
    component alone: the priority allocator hands the marginal job
    ``capacity - before``, a difference of sums of the order of the map slots
    (80 at 20x2), whose rounding (about 8e-6 a step) the two packages take
    in other orders (XLA's, and the port's fixed tree); on a job of a few
    tasks that comes to 1.4e-5 of a component (bursty, proposed).  The JAX
    package itself moves per-job masses by up to 2.5e-5 of their own value
    when its inputs move by 2^-22 (measured on these cells)."""
    for _, ref, out in _by_preset(parity, preset):
        assert abs(out.locality_rate - ref.locality_rate) <= LOCALITY_ATOL
        for a, b in zip(ref.jobs, out.jobs):
            scale = a.local_map_launches + a.remote_map_launches
            assert abs(b.local_map_launches - a.local_map_launches) <= MASS_RTOL * scale
            assert abs(b.remote_map_launches - a.remote_map_launches) <= MASS_RTOL * scale


@pytest.mark.parametrize("preset", CAL_PRESETS)
def test_diag_agrees_with_the_original(preset):
    """run_cell(diag=True) over the whole horizon: every aggregate within 1e-5
    of its largest value over the run; the locality ratio ``lf`` weighted by
    the launched mass, since a ratio of a launch of 3e-5 tasks is rounding
    noise in either package (the JAX package's own lf moves by 1.4e-3 there
    when its inputs move by 2^-22)."""
    (j, *_), (t, *_) = _cells(preset, (1,))
    ref = jsur.run_cell(j, diag=True)
    out = tsur.run_cell(t, diag=True, device="cpu")
    assert list(out.diag) == list(k3ref.DIAG_FIELDS)
    assert set(out.diag) == set(ref.diag)
    assert out.steps_integrated == t.n_steps()
    assert [x.finish_time for x in out.jobs] == [x.finish_time for x in ref.jobs]
    for k in out.diag:
        a, b = np.asarray(ref.diag[k]), out.diag[k]
        assert a.shape == b.shape == (t.n_steps(),)
        if k == "lf":
            a, b = a * ref.diag["launched_m"], b * out.diag["launched_m"]
        scale = max(float(np.abs(a).max()), 1.0)
        assert float(np.abs(a - b).max()) <= MASS_RTOL * scale, k
    for k in ("active", "latch", "chi", "free_r", "launched_r"):
        assert np.array_equal(out.diag[k], np.asarray(ref.diag[k])), k


# ---------------------------------------------------------------------------
# the determinism contract (the port's copies of the original's pins)
# ---------------------------------------------------------------------------

_CLUSTER = ttypes.ClusterSpec(num_machines=6, vms_per_machine=2, replication=1)


def _cell(policy="proposed", seed=0, preset="mix_small", trace_seed=0,
          cluster=_CLUSTER):
    trace = ttraces.generate_trace(ttraces.PRESETS[preset], seed=trace_seed)
    return tsur.build_cell(trace, cluster, policy, seed)


def _fingerprint(res):
    return (res.makespan, res.jobs_total, res.jobs_finished,
            res.deadlines_met, res.locality_rate, res.latched_steps,
            tuple((j.job_id, j.finish_time, j.completion_time,
                   j.deadline_met, j.local_map_launches,
                   j.remote_map_launches) for j in res.jobs))


@pytest.mark.fuzz
@pytest.mark.parametrize("policy", SUPPORTED)
def test_batch_of_one_matches_run_cell(policy):
    cell = _cell(policy=policy)
    assert _fingerprint(tsur.run_batch([cell], device="cpu")[0]) == \
        _fingerprint(tsur.run_cell(cell, device="cpu"))


@pytest.mark.fuzz
def test_batch_order_and_size_invariance():
    """Results depend only on each cell's own inputs — never on batch
    composition.  Mixed presets force mixed padding buckets."""
    cells = [_cell(policy=p, seed=s, preset=pr)
             for p, s, pr in [("proposed", 0, "mix_small"),
                              ("fair", 1, "mix_small"),
                              ("delay", 2, "heavy_tail"),
                              ("fifo", 0, "heavy_tail"),
                              ("edf_nopark", 3, "mix_small"),
                              ("proposed", 1, "heavy_tail")]]
    base = [_fingerprint(r) for r in tsur.run_batch(cells, device="cpu")]
    flipped = [_fingerprint(r) for r in tsur.run_batch(cells[::-1], device="cpu")][::-1]
    assert base == flipped
    chunked = [_fingerprint(r) for chunk in (cells[:2], cells[2:5], cells[5:])
               for r in tsur.run_batch(chunk, device="cpu")]
    assert base == chunked


@pytest.mark.fuzz
def test_max_batch_override_is_result_invariant(monkeypatch):
    assert tsur._MAX_BATCH == 1024                     # pinned default
    cells = [_cell(policy=p, seed=s)
             for p, s in [("proposed", 0), ("fair", 1), ("fifo", 2),
                          ("delay", 0), ("proposed", 3)]]
    base = [_fingerprint(r) for r in tsur.run_batch(cells, device="cpu")]
    for cap in (1, 2, 3):
        assert base == [_fingerprint(r) for r in
                        tsur.run_batch(cells, max_batch=cap, device="cpu")], cap
    monkeypatch.setenv("REPRO_SURROGATE_MAX_BATCH", "2")
    assert base == [_fingerprint(r) for r in tsur.run_batch(cells, device="cpu")]
    assert base == [_fingerprint(r) for r in
                    tsur.run_batch(cells, max_batch=4, device="cpu")]


def test_max_batch_resolution_precedence(monkeypatch):
    monkeypatch.delenv("REPRO_SURROGATE_MAX_BATCH", raising=False)
    assert tsur._resolve_max_batch() == 1024
    assert tsur._resolve_max_batch(7) == 7
    monkeypatch.setenv("REPRO_SURROGATE_MAX_BATCH", "16")
    assert tsur._resolve_max_batch() == 16
    assert tsur._resolve_max_batch(3) == 3
    with pytest.raises(ValueError, match=">= 1"):
        tsur._resolve_max_batch(0)
    monkeypatch.setenv("REPRO_SURROGATE_MAX_BATCH", "-5")
    with pytest.raises(ValueError, match=">= 1"):
        tsur._resolve_max_batch()


@pytest.mark.fuzz
@pytest.mark.parametrize("seed", [0, 7])
def test_byte_determinism_per_config_seed(seed):
    a = _fingerprint(tsur.run_cell(_cell(seed=seed), device="cpu"))
    b = _fingerprint(tsur.run_cell(_cell(seed=seed), device="cpu"))
    assert a == b


@pytest.mark.fuzz
def test_seed_and_policy_actually_move_the_result():
    base = _fingerprint(tsur.run_cell(_cell(policy="proposed", seed=0), device="cpu"))
    assert _fingerprint(tsur.run_cell(_cell(policy="proposed", seed=1), device="cpu")) != base
    assert _fingerprint(tsur.run_cell(_cell(policy="fifo", seed=0), device="cpu")) != base


def test_early_exit_equals_the_whole_horizon():
    """The chunked early exit integrates fewer steps than the horizon and
    gives what the whole horizon (diag=True) gives."""
    cell = _cell(policy="delay", preset="heavy_tail", cluster=_fleet(ttypes))
    short = tsur.run_cell(cell, device="cpu")
    full = tsur.run_cell(cell, diag=True, device="cpu")
    assert short.steps_integrated < full.steps_integrated == cell.n_steps()
    assert short.steps_integrated % k3ref.CHUNK == 0
    assert _fingerprint(short) == _fingerprint(full)


# ---------------------------------------------------------------------------
# the plain version's fixed orders
# ---------------------------------------------------------------------------

def test_tree_sum_and_scan_orders():
    rng = np.random.default_rng(0)
    for n in (8, 16, 32, 64, 128, 2048):
        x = torch.from_numpy((rng.standard_normal((3, n))
                              * 2.0 ** rng.integers(-8, 8, (3, n))).astype(np.float32))
        s = k3ref._tree_sum(x)
        # the order: rows of 32 halved, then the rows halved
        rows = x.numpy().reshape(3, -1, min(n, 32))
        while rows.shape[-1] > 1:
            h = rows.shape[-1] // 2
            rows = rows[..., :h] + rows[..., h:]
        rows = rows[..., 0]
        while rows.shape[-1] > 1:
            h = rows.shape[-1] // 2
            rows = rows[..., :h] + rows[..., h:]
        assert np.array_equal(s.numpy(), rows[..., 0])
        # a row's sum does not depend on the rows beside it
        assert torch.equal(k3ref._tree_sum(x[1:2])[0], s[1])
        c = k3ref._cumsum(x)
        seq = x.numpy().copy()
        step = 1
        while step < n:
            seq = np.concatenate([seq[:, :step], seq[:, step:] + seq[:, :-step]], axis=1)
            step *= 2
        assert np.array_equal(c.numpy(), seq)
        np.testing.assert_allclose(c.numpy(), np.cumsum(x.numpy().astype(np.float64), 1),
                                   rtol=1e-4, atol=1e-4 * float(np.abs(x.numpy()).sum()))


def test_cuda_source_constants_match_the_python_ones():
    src = k3.SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kRing") == k3ref.RING
    assert const("kChunk") == k3ref.CHUNK
    assert const("kJobFields") == len(k3ref.JOB_FIELDS)
    assert const("kScalarFields") == len(k3ref.SCALAR_FIELDS)
    assert const("kDiag") == len(k3ref.DIAG_FIELDS)
    assert const("kMaxThreads") * const("kWide") == k3.MAX_JOBS
    assert const("kSmemRingJobs") == k3.SMEM_RING_JOBS
    fields = re.search(r"struct Physics \{(.*?)\};", src, re.S).group(1)
    floats = re.search(r"float (.*?);", fields, re.S).group(1)
    assert [f.strip() for f in floats.split(",")] == list(k3ref.FluidPhysics._fields[:14])
    assert "-fmad=false" in _build.SOURCE_FLAGS[k3.SOURCE.stem]
    assert "roundf(" not in src.replace("rintf(", "")


# ---------------------------------------------------------------------------
# the calibration wall, through the port
# ---------------------------------------------------------------------------

def _port_spec(spec):
    """The port's ExperimentSpec for a JAX package spec: the same traces,
    clusters, policies and seeds."""
    traces = tuple(trunner.TraceRef(
        config=ttraces.TraceConfig.from_dict(t.config.to_dict()), seed=t.seed)
        for t in spec.traces)
    clusters = tuple(ttypes.ClusterSpec.from_dict(c.to_dict()) for c in spec.clusters)
    return trunner.ExperimentSpec(name=spec.name, traces=traces, clusters=clusters,
                                  schedulers=tuple(s.label for s in spec.schedulers),
                                  seeds=spec.seeds)


@pytest.mark.parametrize("preset,shape", sorted(texp.CALIBRATED))
def test_calibration_wall_through_the_port(preset, shape, tmp_path):
    assert texp.CALIBRATED == jexp.CALIBRATED
    assert texp.CALIBRATION_SEEDS == jexp.CALIBRATION_SEEDS
    allow = texp.CALIBRATED[(preset, shape)]
    base = regime_spec(preset, shape, seeds=texp.CALIBRATION_SEEDS)
    spec = jrunner.ExperimentSpec(name=f"wall-{preset}-{shape}", traces=base.traces,
                                  clusters=base.clusters, schedulers=allow + ("fair",),
                                  seeds=texp.CALIBRATION_SEEDS)
    oracle = jrunner.run_experiment(spec, tmp_path / "oracle", workers=4).by_scheduler()
    jax_sur = jexp.run_surrogate(spec, tmp_path / "jax").by_scheduler()
    port_spec = _port_spec(spec)
    assert [c.descriptor() for c in port_spec.cells()] == [c.descriptor() for c in spec.cells()]
    sur = texp.run_surrogate(port_spec, tmp_path / "port", device="cpu").by_scheduler()
    for pol in allow:
        oc = jax_compare_throughput(oracle["fair"], oracle[pol])
        sc = compare_throughput(sur["fair"], sur[pol])
        assert oc.ci_lo_pct <= sc.mean_gain_pct <= oc.ci_hi_pct, (
            f"{preset}/{shape}/{pol}: port gain {sc.mean_gain_pct:+.2f}% outside "
            f"oracle CI [{oc.ci_lo_pct:+.2f}, {oc.ci_hi_pct:+.2f}]")
        assert sc.mean_gain_pct == \
            jax_compare_throughput(jax_sur["fair"], jax_sur[pol]).mean_gain_pct


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------

def _small_spec(schedulers=("proposed", "fair"), seeds=(0, 1)):
    return trunner.ExperimentSpec(
        name="sur-t", traces=(trunner.TraceRef(preset="mix_small", seed=0),),
        clusters=(_CLUSTER,), schedulers=schedulers, seeds=seeds)


def test_surrogate_rerun_hits_cache(tmp_path):
    first = texp.run_surrogate(_small_spec(), tmp_path, device="cpu")
    assert first.simulated == 4 and first.cached == 0
    again = texp.run_surrogate(_small_spec(), tmp_path, device="cpu")
    assert again.simulated == 0 and again.cached == 4

    def strip(r):
        return {k: v for k, v in r.to_dict().items() if k != "wall_time_s"}

    assert [strip(r) for r in first.records] == [strip(r) for r in again.records]


def test_descriptor_carries_the_port_engine_id(tmp_path):
    spec = _small_spec(seeds=(0,))
    texp.run_surrogate(spec, tmp_path, device="cpu")
    jspec = jrunner.ExperimentSpec(
        name="sur-t", traces=(jrunner.TraceRef(preset="mix_small", seed=0),),
        clusters=(jtypes.ClusterSpec(num_machines=6, vms_per_machine=2, replication=1),),
        schedulers=("proposed", "fair"), seeds=(0,))
    for cell, jcell in zip(spec.cells(), jspec.cells()):
        meta = json.loads((tmp_path / texp.surrogate_hash(cell) / "meta.json").read_text())
        assert meta["engine"] == "simcluster.surrogate/fluid-v1-torch"
        d = texp.surrogate_descriptor(cell)
        d.pop("engine")
        assert d == cell.descriptor() == jcell.descriptor()
        assert cell.cache_hash() == jcell.cache_hash()
        assert texp.surrogate_hash(cell) != jexp.surrogate_hash(jcell)


def test_unsupported_grid_rejected_before_any_work(tmp_path, monkeypatch):
    def no_work(*a, **k):
        raise AssertionError("integrated a cell")

    monkeypatch.setattr(fluid_ops, "fluid_scan", no_work)
    spec = _small_spec(schedulers=("proposed", "adaptive"))
    with pytest.raises(tsur.SurrogateUnsupported):
        texp.run_surrogate(spec, tmp_path, device="cpu")
    assert list(tmp_path.iterdir()) == []


# ---------------------------------------------------------------------------
# the device and the kernel wrapper
# ---------------------------------------------------------------------------

def test_entry_points_default_to_the_card(monkeypatch):
    for fn in (tsur.run_batch, tsur.run_cell, texp.run_surrogate):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = []
    monkeypatch.setattr(fluid_ops, "fluid_scan", lambda *a, **k: calls.append(a))
    cell = _cell()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsur.run_batch([cell])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsur.run_cell(cell)
    assert calls == []


def _inputs(C=2, Jp=16):
    jobs = torch.zeros((C, len(k3ref.JOB_FIELDS), Jp), dtype=torch.float32)
    order = torch.arange(Jp, dtype=torch.int32).repeat(C, 1)
    scalars = torch.zeros((C, len(k3ref.SCALAR_FIELDS)), dtype=torch.float32)
    return jobs, order, scalars


def test_wrapper_rejects_bad_inputs_before_any_launch(monkeypatch):
    def no_load():
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(k3, "load", no_load)
    jobs, order, scalars = _inputs()
    bad = [
        (dict(jobs=jobs.double()), "float32"),
        (dict(scalars=scalars.half()), "float32"),
        (dict(order=order.long()), "int32"),
        (dict(jobs=jobs[:, :9]), "shapes disagree"),
        (dict(order=order[:1]), "shapes disagree"),
        (dict(scalars=scalars[:, :10]), "shapes disagree"),
        (dict(jobs=jobs[0]), "expected"),
        (dict(jobs=torch.zeros((2, 10, 12)), order=order[:, :12]), "power of two"),
        (dict(jobs=torch.zeros((2, 10, 4)), order=order[:, :4]), "power of two"),
        (dict(jobs=torch.zeros((2, 10, 4096)),
              order=torch.zeros((2, 4096), dtype=torch.int32)), "power of two"),
        (dict(jobs=jobs.transpose(1, 2).contiguous().transpose(1, 2)), "contiguous"),
    ]
    for change, match in bad:
        args = dict(jobs=jobs, order=order, scalars=scalars)
        args.update(change)
        for fn in (k3.fluid_scan_cuda, fluid_ops.fluid_scan):
            with pytest.raises(ValueError, match=match):
                fn(args["jobs"], args["order"], args["scalars"], tsur.PHYSICS, n_steps=256)
    with pytest.raises(ValueError, match="n_steps"):
        k3.fluid_scan_cuda(jobs, order, scalars, tsur.PHYSICS, n_steps=0)
    # good inputs on the CPU: the kernel wrapper refuses them, the op runs the
    # plain version and counts no launch
    with pytest.raises(ValueError, match="CUDA tensors"):
        k3.fluid_scan_cuda(jobs, order, scalars, tsur.PHYSICS, n_steps=256)
    before = spans.counters()["kernel.fluid_scan"]
    out = fluid_ops.fluid_scan(jobs, order, scalars, tsur.PHYSICS, n_steps=256)
    assert spans.counters()["kernel.fluid_scan"] == before
    assert out["steps"].tolist() == [0, 0]         # no real job: nothing to run
    assert out["finish"].shape == (2, 16)
