"""The port's elastic fleet (``repro_torch.elastic``) against the JAX
package's, on the CPU.

``ChipPool`` and ``FleetJob.demanded_chips`` are pure Python: both packages'
are driven with the same calls and must agree exactly.  The scheduler runs
the JAX package's three demo jobs (two layers of width 128, fp32) under a
deterministic clock (every call advances it by one) with host 1 failed at a
fixed rebalance, in both packages: the reference in a subprocess with eight
fake CPU devices (``tests/fleet_reference_main.py``), the port through
``examples/deadline_fleet_torch.py``'s job factory on eight chips of the CPU,
both from the same numpy parameters.  Events, each job's steps, resizes and
chips and the reconfiguration count must be equal; the final params agree
at 1e-5 but for elements Adam moved apart near a zero gradient, each within
2 lr a step (``tests/test_torch_train.py``'s bound).  The data-parallel step
at widths 1, 2 and 4 gives the reference's loss and gradient (as Adam saw
it: m / (1 - b1) after one step) within fp32 2e-5 relative to max|ref|.
Then both examples run as a user runs them.
"""
import importlib.util
import itertools
import json
import os
import random
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.elastic import ChipPool as JaxPool
from repro.elastic import FleetJob as JaxJob
from repro.models.common import get_model as jax_model
from repro_torch.elastic import ChipPool, EstimatorBridge, FleetJob, FleetScheduler
from repro_torch.launch.mesh import ChipMesh
from repro_torch.models.common import tree_leaves
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.testing import from_jax_params, rel_err, to_jax_layout

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
EXAMPLES = ROOT / "examples"

STEPS = 8                       # the demo's --steps: urgent and mid 8, lazy 4
DEADLINES = (24.0, 30.0, 1000.0)  # clock units: every clock() call is one
FAIL_AT_REBALANCE = 2
WIDTHS = (1, 2, 4)
DP_TOL = 2e-5
PARAM_TOL = 1e-5
LR = 1e-3                       # the demo jobs' AdamW lr


def _example(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


FLEET_EXAMPLE = _example("deadline_fleet_torch")


def _np_params(seed):
    """A numpy tree in the JAX layout of the demo model, each leaf normal
    with the JAX init's own standard deviation (norm scales around 1)."""
    jcfg = jax_smoke("tinyllama-1.1b").replace(num_layers=2, d_model=128, n_heads=4,
                                              n_kv_heads=2, d_ff=256)
    init = jax_model(jcfg).init(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        a = np.asarray(tree, np.float32)
        noise = rng.standard_normal(a.shape).astype(np.float32)
        return 1 + 0.1 * noise if name == "scale" else noise * a.std()
    return walk(init)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flatten(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


def _counting_clock():
    ticks = itertools.count()
    return lambda: next(ticks) * 1.0


def _fail_at(n):
    calls = itertools.count(1)
    return lambda: next(calls) == n


# -- ChipPool ------------------------------------------------------------------------

def test_chip_pool_aq_rq():
    """tests/test_fleet.py's case on the port."""
    pool = ChipPool([object() for _ in range(8)], chips_per_host=4)
    got = pool.allocate("a", 6, preferred_hosts=(0,))
    assert len(got) == 6
    assert {pool.host_of(c) for c in got[:4]} == {0}   # locality preference
    pool.park_grow("b", host=1)
    pool.release([got[-1]])                            # a chip on host 1
    assert pool.match() == [("b", got[-1])]
    assert pool.fail_host(0) == ["a"]
    assert all(pool.owner[c] is None for c in range(4))


def _pool_state(pool):
    return (dict(pool.owner), [list(q) for q in pool.aq], [list(q) for q in pool.rq],
            sorted(pool.dead_hosts), pool.reconfigurations, pool.free_chips())


@pytest.mark.parametrize("seed", range(4))
def test_chip_pool_random_sequence_equals_reference(seed):
    """A seeded random sequence of allocate, release, park, match and fail
    calls on both packages' pools (12 chips, 3 hosts): equal owner maps, AQ,
    RQ, grants, dead hosts and counts after every call."""
    rng = random.Random(seed)
    jobs = ["a", "b", "c", "d"]
    port, ref = ChipPool([None] * 12, 4), JaxPool([None] * 12, 4)
    for _ in range(200):
        op = rng.choice(["allocate", "allocate", "release", "park", "match", "match",
                         "fail"])
        if op == "allocate":
            args = (rng.choice(jobs), rng.randint(0, 5),
                    tuple(rng.sample(range(3), rng.randint(0, 2))))
        elif op == "release":
            args = (rng.sample(range(12), rng.randint(0, 3)),)
        elif op == "park":
            args = (rng.choice(jobs), rng.randrange(3))
        elif op == "fail":
            if rng.random() > 0.1:
                continue
            args = (rng.randrange(3),)
        else:
            args = ()
        method = {"park": "park_grow", "fail": "fail_host"}.get(op, op)
        assert getattr(port, method)(*args) == getattr(ref, method)(*args), (op, args)
        assert _pool_state(port) == _pool_state(ref), (op, args)


# -- Eq. 10 --------------------------------------------------------------------------

def test_demanded_chips_equals_reference():
    """``demanded_chips`` over a grid of steps, step times, widths,
    deadlines and clocks, and ``EstimatorBridge.demand``, equal to the
    reference's."""
    from repro.elastic import EstimatorBridge as JaxBridge
    n = 0
    for total, step, width, deadline, now, t, pool in itertools.product(
            (1, 10, 300), (0, 3, 9, 300), (0, 1, 3, 8), (0.5, 60.0, 3600.0),
            (0.0, 30.0, 5000.0), (None, 0.01, 0.7, 4.0), (4, 8, 256)):
        jobs = []
        for cls in (FleetJob, JaxJob):
            j = cls("j", deadline=deadline, total_steps=total, make_step=None,
                    min_chips=1 + (width > 3))
            j.step, j.chips = step, list(range(width))
            j.submitted_at = 2.0
            if t is not None:
                j.step_times = [t * (1 + 0.1 * k) for k in range(10)]
            jobs.append(j)
        assert jobs[0].t_step() == jobs[1].t_step()
        assert jobs[0].demanded_chips(now, pool) == jobs[1].demanded_chips(now, pool)
        if t is not None and total > step:
            args = (total - step, t, width, deadline - now, pool)
            assert EstimatorBridge.demand(*args) == JaxBridge.demand(*args)
        n += 1
    assert n == 3 * 4 * 4 * 3 * 3 * 4 * 3


# -- the scheduler and the data-parallel step against the reference ------------------

@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's fleet and data-parallel steps, run once in a
    subprocess with eight fake devices, and the numpy params they started
    from."""
    src, out = tmp_path_factory.mktemp("fleet_in"), tmp_path_factory.mktemp("fleet_out")
    params = {seed: _np_params(seed) for seed in (1, 2, 3)}
    for seed, tree in params.items():
        np.savez(src / f"params_{seed}.npz", **_flatten(tree))
    (src / "config.json").write_text(json.dumps({
        "steps": STEPS, "deadlines": DEADLINES, "fail_at_rebalance": FAIL_AT_REBALANCE,
        "widths": WIDTHS}))
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    run = subprocess.run([sys.executable, str(ROOT / "tests" / "fleet_reference_main.py"),
                          str(src), str(out)], env=env, capture_output=True,
                         text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    return params, out


def _tiny():
    cfg = FLEET_EXAMPLE.tiny_config()       # the smoke recipe: fp32, as the bounds assume
    assert cfg.param_dtype == cfg.compute_dtype == torch.float32
    return cfg


@pytest.fixture(scope="module")
def port_fleet(reference, tmp_path_factory):
    params, _ = reference
    cfg = _tiny()
    pool = ChipPool(FLEET_EXAMPLE.chip_devices("cpu"), chips_per_host=4)
    fleet = FleetScheduler(pool, str(tmp_path_factory.mktemp("fleet_ckpt")),
                           clock=_counting_clock())
    FLEET_EXAMPLE.submit_demo_jobs(
        fleet, STEPS, deadlines=DEADLINES, cfg=cfg,
        init=lambda seed, place: from_jax_params(cfg, params[seed], place))
    FLEET_EXAMPLE.run_with_failure(fleet, 1, _fail_at(FAIL_AT_REBALANCE),
                                   rebalance_every=3, ckpt_every=4, max_ticks=600)
    return fleet


def test_fleet_events_equal_reference(reference, port_fleet):
    ref = json.loads((reference[1] / "fleet.json").read_text())
    assert port_fleet.events == ref["events"]
    # the scenario moves chips every way the scheduler can
    kinds = " | ".join(port_fleet.events)
    for word in ("resize", "FAILED; affected=", "recovered", "done"):
        assert word in kinds, word
    assert port_fleet.pool.reconfigurations >= 1          # an AQ/RQ grant


def test_fleet_jobs_equal_reference(reference, port_fleet):
    ref = json.loads((reference[1] / "fleet.json").read_text())
    jobs = {j.job_id: {"step": j.step, "resizes": j.resizes, "chips": j.chips}
            for j in port_fleet.jobs.values()}
    assert jobs == ref["jobs"]
    assert port_fleet.pool.reconfigurations == ref["reconfigurations"]
    assert all(j.done for j in port_fleet.jobs.values())


@pytest.mark.parametrize("job_id", ["job-urgent", "job-mid", "job-lazy"])
def test_fleet_final_params_match_reference(reference, port_fleet, job_id):
    """Each job's params after the run (resizes, restores and the failure
    included) against the reference's: at 1e-5 of the leaf's max|param|
    but for at most 1e-4 of the elements, each within 2 lr of every step the
    job took."""
    job = port_fleet.jobs[job_id]
    got = _flatten(to_jax_layout(_tiny(), job.state["params"]))
    with np.load(reference[1] / f"final_{job_id}.npz") as z:
        ref = {k: z[k] for k in z.files}
    assert sorted(got) == sorted(ref)
    n_off, worst = 0, 0.0
    for key in ref:
        diff = np.abs(got[key] - ref[key])
        off = diff > PARAM_TOL * (np.abs(ref[key]).max() + 1e-9)
        n_off += int(off.sum())
        worst = max(worst, float(diff.max()))
    n = sum(v.size for v in ref.values())
    assert n_off <= 1e-4 * n, (n_off, worst)
    assert worst <= 2 * LR * job.step, (n_off, worst)


@pytest.mark.parametrize("width", WIDTHS)
def test_data_parallel_step_matches_reference(reference, width):
    """The example's data-parallel step at ``width`` chips of the CPU (row
    shards through ``make_train_step``'s accumulation) against the
    reference's jitted step with the batch sharded over ``width`` devices:
    the loss, and every leaf of the gradient Adam saw, within 2e-5 of the
    reference's max."""
    params, out = reference
    cfg = _tiny()
    make_step = FLEET_EXAMPLE.make_job_factory(
        1, STEPS, cfg, init=lambda seed, place: from_jax_params(cfg, params[seed], place))
    step, state, place = make_step(ChipMesh(["cpu"] * width))
    assert place == torch.device("cpu")
    state = step(state)
    loss = float(make_step.losses[-1])
    b1 = AdamWConfig().b1
    seen = _flatten(to_jax_layout(cfg, state["opt"]["m"]))
    with np.load(out / f"dp_{width}.npz") as z:
        assert abs(loss - float(z["loss"])) / abs(float(z["loss"])) < DP_TOL
        for key, m in seen.items():
            assert rel_err(m / (1 - b1), z[key]) < DP_TOL, key


def test_data_parallel_step_over_devices_equals_one_device():
    """Where the chips are distinct devices the step runs each row shard on
    its chip's device and sums there: on two distinct CPU devices objects
    (``cpu`` and ``cpu:0``) it gives the one-device accumulation's
    result."""
    cfg = _tiny()
    opt_cfg = AdamWConfig(lr=LR, warmup_steps=0)
    batch = {"tokens": torch.randint(1, cfg.vocab_size, (8, 16)),
             "labels": torch.randint(1, cfg.vocab_size, (8, 16))}
    results = []
    for devices in ([torch.device("cpu")] * 2,
                    [torch.device("cpu"), torch.device("cpu", 0)]):
        step = FLEET_EXAMPLE.data_parallel_step(cfg, opt_cfg, devices, 8)
        params = from_jax_params(cfg, _np_params(1), "cpu")
        p, o, m = step(params, adamw_init(params), batch)
        results.append((float(m["loss"]), [x.clone() for x in tree_leaves(o["m"])]))
    (l1, m1), (l2, m2) = results
    assert abs(l1 - l2) <= 1e-6 * abs(l1)
    for a, b in zip(m1, m2):
        assert rel_err(b, a) < 1e-5


# -- the examples, as a user runs them ------------------------------------------------

def _run_example(args, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, *map(str, args)], env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_deadline_fleet_example_on_the_cpu():
    out = _run_example([EXAMPLES / "deadline_fleet_torch.py", "--device", "cpu",
                        "--steps", "8", "--fail-after", "1.0"])
    assert out.returncode == 0, out.stderr[-2000:]
    assert "OK" in out.stdout
    assert "FAILED; affected=" in out.stdout        # host failure happened
    assert "recovered" in out.stdout                # ...and was recovered


def test_train_100m_example_runs_and_resumes(tmp_path):
    ck = tmp_path / "ck"
    first = _run_example([EXAMPLES / "train_100m_torch.py", "--preset", "tiny",
                          "--device", "cpu", "--ckpt-dir", ck])
    assert first.returncode == 0, first.stderr[-2000:]
    assert "Eq.10 min-chips for deadline" in first.stdout
    assert (ck / "step_60" / "manifest.json").exists()
    again = _run_example([EXAMPLES / "train_100m_torch.py", "--preset", "tiny",
                          "--device", "cpu", "--ckpt-dir", ck])
    assert again.returncode == 0, again.stderr[-2000:]
    assert "restored from checkpoint step 60" in again.stdout


@pytest.mark.parametrize("example", ["deadline_fleet_torch.py", "train_100m_torch.py"])
def test_examples_refuse_to_run_without_a_card(example):
    """Without ``--device cpu`` each example wants the card; with none
    visible it exits non-zero and names the way out."""
    out = _run_example([EXAMPLES / example], timeout=120)
    assert out.returncode != 0
    assert "--device cpu" in out.stderr
