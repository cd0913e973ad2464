"""Batched fluid surrogate of the event engine, on the card.

The port of the JAX package's ``simcluster/surrogate.py``.  The event
simulator prices every heartbeat, launch and finish as a discrete event —
exact, but one Python process per cell.  This module trades task-level
exactness for orders of magnitude in throughput: each cell (trace × policy ×
seed) becomes a fixed-timestep **fluid** model whose state is arrays over
jobs — pending map/reduce task mass, slot allocations, locality fractions,
latch state.  The original advances it with ``lax.scan`` over time and
``jax.vmap`` over cells; here one launch of a hand-written CUDA kernel (K3,
``repro_torch.kernels.fluid_scan``) integrates every cell of a (jobs, steps)
bucket over its whole horizon, one block a cell.  On the CPU the same step
runs as the kernel's plain PyTorch version.

What is modeled (the mesoscale):

* slot capacity (``num_nodes × base_map_slots`` map, same for reduce) and
  per-step allocation by policy ordering — EDF (static deadline priority),
  FIFO (static submission priority), fair deficit (equal-share
  waterfilling);
* the map→reduce phase barrier (reduces only after the job's map mass
  drains, as Algorithm 2 line 10);
* data locality as a hit probability: a free slot finds a local block with
  ``1 − (1 − c/N)^p`` for ``p`` pending tasks whose blocks each live on
  ``c`` distinct nodes of ``N`` — wide backlogs run local, job tails go
  remote, which is the entire economics of delay scheduling and parking;
* the paper's parking mechanism (``park: fixed``) as a conversion of the
  non-local flow into local launches that pay a reconfiguration wait
  instead of the remote-read penalty;
* delay scheduling (``locality_delay``) as an exponent boost on the
  locality hit probability;
* the latching overload detector (``overload: latch``): when the queued
  map backlog and the active-job crowd cross the ``AdaptiveConfig`` entry
  bars, ordering degenerates to fair and parking suspends until the
  cluster drains.

What is **not** modeled — and raises ``SurrogateUnsupported`` instead of
silently answering wrong: the pressure-adaptive park gates (``park:
adaptive``) and the reduce-aware latch (``overload: reduce_aware``); the
policies ``adaptive``, ``adaptive_ra`` and ``harvest`` stay oracle-only.

Determinism contract (pinned by ``tests/test_torch_surrogate.py`` on the
CPU and by ``chip_smoke.py`` on the card): per (config, seed) the result is
byte-stable; a batch of one equals ``run_cell`` bit for bit; and a cell's
result is invariant to the batch it rides in, its place there and the
sub-batch cap — padding buckets (``_bucket``) are a function of the cell
alone, and the kernel and its plain version take every sum in one fixed
order within the cell.  The two devices agree on every finish time, not
bit for bit (``exp`` and ``log1p`` round differently on each).

Cells, packing and results are the original's, copied; the engine id
differs, so the port's cached cells never share a hash with the original's.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.policies import PolicySpec
from repro_torch.core.types import AdaptiveConfig, ClusterSpec
from repro_torch.kernels.fluid_scan import ops as fluid_ops
from repro_torch.kernels.fluid_scan.ref import (DIAG_FIELDS, JOB_FIELDS,
                                                SCALAR_FIELDS, FluidPhysics)
from repro_torch.simcluster.traces import Trace, _stable_seed

#: engine identity stamped into cache descriptors: the original's id with a
#: ``-torch`` suffix, so the two packages' cells hash apart
SURROGATE_ENGINE_ID = "simcluster.surrogate/fluid-v1-torch"

#: component vocabulary the lowering can express.  Everything else is
#: oracle-only and raises ``SurrogateUnsupported``.
SUPPORTED_COMPONENTS: Dict[str, Tuple[str, ...]] = {
    "ordering": ("edf", "fair_deficit", "fifo"),
    "park": ("off", "fixed"),
    "overload": ("none", "latch"),
}

_ORDERING_CODES = {"edf": 0, "fifo": 1, "fair_deficit": 2}

# -- fluid-model calibration constants ---------------------------------------
# Fitted against paired event-engine cells on the regime atlas (the
# differential wall in tests/test_surrogate.py re-checks the fit on every
# run); they are physics of the mesoscale model, not per-preset knobs.
#: integrator step, seconds of simulated time (2× the heartbeat interval:
#: fine enough that a 20 s map task spans >3 steps, coarse enough that a
#: 3600 s trace is ~600 steps)
DT = 6.0
#: fraction of parked (non-local) map candidates whose reconfiguration
#: resolves locally before the patience bound expires, on an uncrowded
#: cluster; crowding degrades it (see the crowd coupling below)
PARK_SUCCESS = 1.0
#: mean extra seconds a successfully parked map waits for its donor core
#: on an uncrowded cluster (hotplug latency + offer queueing)
PARK_WAIT = 6.0
# crowd coupling — the mesoscale form of the event engine's measured
# park economics: with many active jobs per machine, per-job shares sit
# far below job widths, donor offers queue behind stale ones, waits
# stretch toward the 30 s patience and expired parks still pay the
# remote read afterwards.  χ = clip(active_jobs / machines, 0, 1):
#: park win probability shrinks as (1 − slope × χ)
PARK_CROWD_PENALTY = 1.0
#: successful-park wait grows to PARK_WAIT × (1 + slope × χ)
PARK_WAIT_CROWD = 0.5
#: above χ ≈ 0.6 the donor pool is exhausted and expired parks re-park
#: (depth 2) before finally reading remote: the patience bound stretches
#: by up to this factor at full saturation — the regime that separates
#: synchronized-burst traces (which spike to χ = 1) from steady backlogs
REPARK_CROWD = 6.0
#: saturation ramp for the repark stretch: saturate = clip((χ_raw − SAT_LO)
#: / SAT_WIDTH, 0, 1) on the *uncapped* active/machines ratio, so only
#: backlogs that outrun the fleet (χ_raw → 1+) pay the full stretch
SAT_LO = 0.75
SAT_WIDTH = 0.3
#: effective placement draws per launch for the non-delay schedulers —
#: the event engine's offer scan finds a local-feasible task ~this many
#: times more often than a single uniform draw would (fair and fifo both
#: measure ~0.2 locality against a 1/machines ~ 0.05 uniform baseline)
LOCALITY_DRAWS = 8.0
#: delay scheduling: extra locality draws per skipped offer (multiplies
#: the hit-probability exponent by 1 + boost × locality_delay)
DELAY_BOOST = 0.35
#: delay scheduling's price: a task that gives up and goes remote first
#: sat out its full skip budget — its launch pays an extra
#: ``locality_delay × DELAY_REMOTE_WAIT`` seconds of ring lag
DELAY_REMOTE_WAIT = 2.0
#: fabric contention: remote map reads this step slow each other down by
#: 1 + slope × (remote launch mass / map slots) — a priority wave that
#: sends most of the queue remote at once pays more per read than fair's
#: trickle of the same total remote mass
NET_CONTENTION = 1.25
#: mean task-duration inflation from the straggler process net of
#: speculative re-execution (p × (factor−1), roughly halved by speculation)
TAIL_INFLATION = 1.04
#: waterfilling iterations for the fair-share allocator (exact once the
#: distinct binding demand levels are below this; J ≤ 64 needs few)
_FAIR_ITERS = 8
#: in-flight ring depth, steps: launched tasks occupy their slots for
#: their quantized service time via a (jobs × _RING) delay ring; service
#: lags clip to _RING − 1 (= 378 s at DT, far above any per-task time)
_RING = 64
_EPS = 1e-6
_INF = np.float32(3.0e9)


class SurrogateUnsupported(ValueError):
    """A policy contains a component the fluid surrogate cannot model.

    Carries the offending axis/value so callers can report *why* a policy
    is oracle-only rather than silently approximating it."""

    def __init__(self, label: str, axis: str, value: str):
        self.label = label
        self.axis = axis
        self.value = value
        super().__init__(
            f"policy {label!r} is oracle-only: component {axis}={value!r} "
            f"has no surrogate transition (supported: "
            f"{SUPPORTED_COMPONENTS.get(axis, ())})")


@dataclass(frozen=True)
class LoweredPolicy:
    """A ``PolicySpec`` compiled to the surrogate's scalar program."""

    ordering: int          # _ORDERING_CODES
    park: int              # 0 = off, 1 = fixed
    overload: int          # 0 = none, 1 = latch
    locality_delay: float  # delay-scheduling offers (fair-family only)
    max_wait: float        # park patience bound, seconds (park policies)


def lower_policy(policy) -> LoweredPolicy:
    """Lower a policy value (spec / name / dict / JSON) to the surrogate
    program, or raise :class:`SurrogateUnsupported` — never a silent
    approximation of an unmodeled component."""
    spec = PolicySpec.parse(policy)
    comps = spec.components
    for axis in ("ordering", "park", "overload"):
        value = comps.get(axis)
        if value not in SUPPORTED_COMPONENTS[axis]:
            raise SurrogateUnsupported(spec.label, axis, str(value))
    params = spec.effective_params()
    park = 1 if comps["park"] == "fixed" else 0
    return LoweredPolicy(
        ordering=_ORDERING_CODES[comps["ordering"]],
        park=park,
        overload=1 if comps["overload"] == "latch" else 0,
        locality_delay=float(params.get("locality_delay", 0) or 0),
        max_wait=float(params.get("max_wait", 30.0)) if park else 0.0)


def surrogate_supported(policy) -> bool:
    """True when :func:`lower_policy` would accept this policy."""
    try:
        lower_policy(policy)
        return True
    except SurrogateUnsupported:
        return False


# ---------------------------------------------------------------------------
# cell construction (host side, numpy)
# ---------------------------------------------------------------------------

def _bucket(n: int, base: int) -> int:
    """Smallest ``base × 2^k`` ≥ n — a deterministic function of the cell
    alone, so padded shapes (and therefore results) cannot depend on what
    else shares the batch."""
    size = base
    while size < n:
        size *= 2
    return size


@dataclass
class SurrogateCellInputs:
    """One cell's arrays, unpadded (jobs axis = J), plus static scalars."""

    # per-job arrays, float32/np
    submit: np.ndarray          # absolute submit time
    dl_abs: np.ndarray          # absolute deadline
    u_m: np.ndarray             # map tasks
    v_r: np.ndarray             # reduce tasks
    map_t: np.ndarray           # mean local map-task seconds (jittered)
    red_t: np.ndarray           # mean reduce-task seconds (jittered)
    c_repl: np.ndarray          # mean distinct replica nodes per map block
    # cell scalars
    n_nodes: int
    n_machines: int
    map_slots: float
    red_slots: float
    remote_mult: float          # remote map duration multiplier
    policy: LoweredPolicy
    # latch entry bars (AdaptiveConfig defaults unless the cluster overrides)
    overload_pending_factor: float
    overload_active_factor: float
    horizon: float
    job_ids: List[str]
    workloads: List[str]
    input_gb: List[float]
    deadlines_rel: np.ndarray

    @property
    def n_jobs(self) -> int:
        return int(self.submit.shape[0])

    def padded_jobs(self) -> int:
        return _bucket(self.n_jobs, 8)

    def n_steps(self) -> int:
        return _bucket(int(math.ceil(self.horizon / DT)), 256)


def build_cell(trace: Trace, cluster: ClusterSpec, policy,
               seed: int) -> SurrogateCellInputs:
    """Compile one (trace, cluster, policy) cell to surrogate inputs.

    Uses the *actual* trace jobs — submit times, task counts, profiles,
    deadlines and the per-seed block placements — so the surrogate shares
    every input the event engine sees and approximates only the dynamics.
    ``seed`` additionally drives a small per-job duration jitter standing
    in for the event engine's per-task lognormal draw."""
    lowered = lower_policy(policy)
    jobs = trace.job_specs(cluster)
    n = len(jobs)
    if n == 0:
        raise ValueError("surrogate cell needs at least one job")
    rng = np.random.default_rng(
        _stable_seed("surrogate-jitter", trace.name, trace.seed, seed))
    submit = np.array([j.submit_time for j in jobs], np.float32)
    dl_rel = np.array([j.deadline for j in jobs], np.float32)
    u_m = np.array([j.u_m for j in jobs], np.float32)
    v_r = np.array([j.v_r for j in jobs], np.float32)
    # per-job mean durations; the phase mean over u_m iid task draws
    # concentrates ∝ 1/sqrt(u_m), which the jitter std reproduces
    map_t = np.empty(n, np.float32)
    red_t = np.empty(n, np.float32)
    c_repl = np.empty(n, np.float32)
    for i, j in enumerate(jobs):
        prof = j.profile
        cv = getattr(prof, "time_cv", 0.08)
        z_m, z_r = rng.standard_normal(2)
        jitter_m = math.exp(cv * z_m / math.sqrt(max(j.u_m, 1)))
        jitter_r = math.exp(cv * z_r / math.sqrt(max(j.v_r, 1)))
        map_t[i] = prof.map_time * TAIL_INFLATION * jitter_m
        red_t[i] = ((prof.reduce_time + j.u_m * prof.shuffle_time_per_pair)
                    * TAIL_INFLATION * jitter_r)
        if j.block_placement:
            c_repl[i] = float(np.mean(
                [len(set(p)) for p in j.block_placement[:j.u_m]]))
        else:
            c_repl[i] = float(min(cluster.replication, cluster.num_nodes))
    # remote penalty is profile-uniform today (1.0); keep the first job's
    # profile as the cell's fabric calibration like the event engine does
    rp = jobs[0].profile.remote_penalty
    remote_mult = 1.0 + rp * cluster.remote_penalty_scale
    map_slots = float(cluster.num_nodes * cluster.base_map_slots)
    red_slots = float(cluster.num_nodes * cluster.base_reduce_slots)
    total_work = (float(np.sum(u_m * map_t)) * remote_mult / map_slots
                  + float(np.sum(v_r * red_t)) / red_slots)
    horizon = float(np.max(submit)) + 3.0 * total_work + 900.0
    adaptive = cluster.adaptive if isinstance(cluster.adaptive,
                                              AdaptiveConfig) else AdaptiveConfig()
    return SurrogateCellInputs(
        submit=submit, dl_abs=submit + dl_rel, u_m=u_m, v_r=v_r,
        map_t=map_t, red_t=red_t, c_repl=c_repl,
        n_nodes=cluster.num_nodes, n_machines=cluster.num_machines,
        map_slots=map_slots, red_slots=red_slots, remote_mult=remote_mult,
        policy=lowered,
        overload_pending_factor=adaptive.overload_pending_factor,
        overload_active_factor=adaptive.overload_active_factor,
        horizon=horizon,
        job_ids=[j.job_id for j in jobs],
        workloads=[j.profile.name for j in jobs],
        input_gb=[j.input_size_gb for j in jobs],
        deadlines_rel=dl_rel)


#: names and order of the per-job tensor rows handed to the kernel
_JOB_FIELDS = JOB_FIELDS
#: per-cell scalar rows
_SCALAR_FIELDS = SCALAR_FIELDS

#: the constants above, as the fluid scan takes them
PHYSICS = FluidPhysics(
    dt=DT, park_success=PARK_SUCCESS, park_wait=PARK_WAIT,
    park_crowd_penalty=PARK_CROWD_PENALTY, park_wait_crowd=PARK_WAIT_CROWD,
    repark_crowd=REPARK_CROWD, sat_lo=SAT_LO, sat_width=SAT_WIDTH,
    locality_draws=LOCALITY_DRAWS, delay_boost=DELAY_BOOST,
    delay_remote_wait=DELAY_REMOTE_WAIT, net_contention=NET_CONTENTION,
    eps=_EPS, inf=float(_INF), fair_iters=_FAIR_ITERS)


def pack_cell(cell: SurrogateCellInputs) -> Dict[str, np.ndarray]:
    """Pad one cell's arrays to its job bucket and stack the kernel inputs.
    Padding jobs carry zero mass and a pad mask of 0 — they can never
    activate, allocate, or finish."""
    jp = cell.padded_jobs()
    n = cell.n_jobs

    def pad(a: np.ndarray, fill: float = 0.0) -> np.ndarray:
        out = np.full(jp, fill, np.float32)
        out[:n] = a.astype(np.float32)
        return out

    pol = cell.policy
    # priority key: FIFO sorts by submission, EDF by absolute deadline;
    # fair ignores the key entirely.  jnp.argsort is stable, so ties
    # resolve by job index — the event schedulers' admission-seq tiebreak.
    if pol.ordering == _ORDERING_CODES["fifo"]:
        prio = cell.submit.copy()
    else:
        prio = cell.dl_abs.copy()
    def lag(seconds: np.ndarray) -> np.ndarray:
        return np.clip(np.round(seconds / DT), 1, _RING - 1)

    jobs = {
        "submit": pad(cell.submit, fill=_INF),
        "dl_abs": pad(cell.dl_abs, fill=_INF),
        "map_mass0": pad(cell.u_m),
        "red_mass0": pad(cell.v_r),
        "lag_ml": pad(lag(cell.map_t), fill=1.0),
        "lag_mr": pad(lag(cell.map_t * cell.remote_mult), fill=1.0),
        "lag_rr": pad(lag(cell.red_t), fill=1.0),
        "c_over_n": pad(np.minimum(cell.c_repl / cell.n_nodes, 0.999)),
        "prio_key": pad(prio, fill=_INF),
        "pad_mask": pad(np.ones(n, np.float32)),
    }
    scalars = {
        "map_slots": cell.map_slots,
        "red_slots": cell.red_slots,
        "machines": float(cell.n_machines),
        "remote_mult": cell.remote_mult,
        "ordering": float(pol.ordering),
        "park": float(pol.park),
        "overload": float(pol.overload),
        "locality_delay": pol.locality_delay,
        "max_wait": pol.max_wait,
        "pending_bar": cell.overload_pending_factor * cell.map_slots,
        "active_bar": cell.overload_active_factor * cell.n_machines,
    }
    packed = {k: jobs[k] for k in _JOB_FIELDS}
    packed.update({k: np.float32(scalars[k]) for k in _SCALAR_FIELDS})
    return packed


def priority_order(prio_key: np.ndarray) -> np.ndarray:
    """A cell's static priority order: a stable sort of its keys, as
    ``jnp.argsort`` is stable (ties, and the padding jobs' ``_INF`` keys,
    keep job order — the event schedulers' admission-seq tiebreak)."""
    return np.argsort(prio_key, kind="stable").astype(np.int32)


#: cells per sub-batch in run_batch.  On the card a sub-batch is one kernel
#: launch, one block a cell, and the bench grid's 1000 cells of one bucket
#: fit one launch (about eight waves of 132 blocks, since 128 KB of rings
#: leave room for one block an SM); on the CPU the plain version's cost is
#: per step, not per cell, so larger batches are cheaper there too.
#: Overridable per call (``run_batch(..., max_batch=...)``) or process-wide
#: via ``REPRO_SURROGATE_MAX_BATCH``; per-cell results are independent of the
#: sub-batch split, so overrides only move the launch count.
_MAX_BATCH = 1024


def _resolve_max_batch(max_batch: Optional[int] = None) -> int:
    """Sub-batch cap for ``run_batch``: explicit kwarg beats the
    ``REPRO_SURROGATE_MAX_BATCH`` env var beats the built-in default."""
    if max_batch is None:
        env = os.environ.get("REPRO_SURROGATE_MAX_BATCH")
        if env:
            max_batch = int(env)
        else:
            return _MAX_BATCH
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    return max_batch


def _device(device) -> torch.device:
    """The device to integrate on; the card unless the caller names another.
    No fallback: asking for the card on a machine without one raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the fluid surrogate runs on the card by default and no CUDA device "
            "is available: pass device='cpu' to run the plain version")
    return dev


def _stack(cells: Sequence["SurrogateCellInputs"], device: torch.device
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's inputs for cells of one bucket: jobs [C, 10, Jp] and
    scalars [C, 11] float32, the priority order [C, Jp] int32."""
    packed = [pack_cell(c) for c in cells]
    jobs = np.stack([np.stack([q[k] for k in _JOB_FIELDS]) for q in packed])
    scalars = np.array([[q[k] for k in _SCALAR_FIELDS] for q in packed],
                       dtype=np.float32)
    order = np.stack([priority_order(q["prio_key"]) for q in packed])
    return (torch.from_numpy(jobs).to(device), torch.from_numpy(order).to(device),
            torch.from_numpy(scalars).to(device))


def _integrate(cells: Sequence["SurrogateCellInputs"], n_steps: int,
               device: torch.device, diag: bool = False
               ) -> List[Dict[str, np.ndarray]]:
    """One launch (or one plain-version run) over cells of one bucket; each
    cell's outputs as numpy arrays."""
    jobs, order, scalars = _stack(cells, device)
    out = fluid_ops.fluid_scan(jobs, order, scalars, PHYSICS, n_steps=n_steps,
                               diag=diag)
    out = {k: v.cpu().numpy() for k, v in out.items()}
    return [{k: v[row] for k, v in out.items()} for row in range(len(cells))]


# ---------------------------------------------------------------------------
# results
# ---------------------------------------------------------------------------

@dataclass
class SurrogateJob:
    job_id: str
    workload: str
    input_gb: float
    submit_time: float
    deadline: float              # relative
    finish_time: Optional[float]
    completion_time: Optional[float]
    deadline_met: bool
    local_map_launches: float
    remote_map_launches: float


@dataclass
class SurrogateResult:
    """Per-cell estimates, mirroring the ``SimResult`` metric surface the
    warehouse consumes (throughput/locality/deadlines)."""

    makespan: float
    jobs_total: int
    jobs_finished: int
    deadlines_met: int
    locality_rate: float
    latched_steps: float
    jobs: List[SurrogateJob]
    # per-step cluster aggregates, present when run with diag=True
    diag: Optional[Dict[str, np.ndarray]] = None
    # steps the scan integrated before its early exit (the whole horizon
    # with diag=True)
    steps_integrated: Optional[int] = None

    def throughput_jobs_per_hour(self) -> float:
        if self.makespan <= 0:
            return 0.0
        return self.jobs_finished * 3600.0 / self.makespan


def _unpack_result(cell: SurrogateCellInputs, out: Dict[str, np.ndarray]
                   ) -> SurrogateResult:
    n = cell.n_jobs
    finish = np.asarray(out["finish"][:n], np.float64)
    local = np.asarray(out["local"][:n], np.float64)
    remote = np.asarray(out["remote"][:n], np.float64)
    latched = float(np.asarray(out["latched_steps"]))
    finished = finish < float(_INF)
    jobs: List[SurrogateJob] = []
    deadlines = 0
    for i in range(n):
        ft = float(finish[i]) if finished[i] else None
        ct = None if ft is None else ft - float(cell.submit[i])
        met = ft is not None and ft <= float(cell.dl_abs[i]) + 1e-6
        deadlines += int(met)
        jobs.append(SurrogateJob(
            job_id=cell.job_ids[i], workload=cell.workloads[i],
            input_gb=float(cell.input_gb[i]),
            submit_time=float(cell.submit[i]),
            deadline=float(cell.deadlines_rel[i]),
            finish_time=ft, completion_time=ct, deadline_met=met,
            local_map_launches=float(local[i]),
            remote_map_launches=float(remote[i])))
    makespan = float(np.max(finish[finished])) if finished.any() \
        else cell.horizon
    launches = float(local.sum() + remote.sum())
    return SurrogateResult(
        makespan=makespan, jobs_total=n,
        jobs_finished=int(finished.sum()), deadlines_met=deadlines,
        locality_rate=float(local.sum()) / launches if launches else 0.0,
        latched_steps=latched, jobs=jobs,
        steps_integrated=int(out["steps"]) if "steps" in out else None)


def run_cell(cell: SurrogateCellInputs, diag: bool = False, *,
             device="cuda") -> SurrogateResult:
    """Integrate one cell: a batch of one.  ``diag=True`` runs the whole
    horizon and attaches the per-step cluster aggregates as ``result.diag``
    (dict of time-series arrays) for calibration probes.  ``device`` is the
    card unless the caller names another (``"cpu"``: the plain version)."""
    out = _integrate([cell], cell.n_steps(), _device(device), diag=diag)[0]
    traj = out.pop("diag", None)
    result = _unpack_result(cell, out)
    if traj is not None:
        result.diag = {k: traj[:, i] for i, k in enumerate(DIAG_FIELDS)}
    return result


def run_batch(cells: Sequence[SurrogateCellInputs], *,
              max_batch: Optional[int] = None,
              device="cuda") -> List[SurrogateResult]:
    """Integrate many cells, grouped by (jobs, steps) bucket and run in
    sub-batches of ``max_batch`` (default ``_MAX_BATCH``, overridable via
    ``REPRO_SURROGATE_MAX_BATCH``): on the card one kernel launch a
    sub-batch.  Results come back in input order and are bit-identical to
    ``run_cell`` on each cell alone, whatever the sub-batch cap."""
    cap = _resolve_max_batch(max_batch)
    dev = _device(device)
    groups: Dict[Tuple[int, int], List[int]] = {}
    for i, cell in enumerate(cells):
        groups.setdefault((cell.padded_jobs(), cell.n_steps()), []).append(i)
    results: List[Optional[SurrogateResult]] = [None] * len(cells)
    for (_, ts), idxs in groups.items():
        for lo in range(0, len(idxs), cap):
            part = idxs[lo:lo + cap]
            outs = _integrate([cells[i] for i in part], ts, dev)
            for i, out in zip(part, outs):
                results[i] = _unpack_result(cells[i], out)
    return results  # type: ignore[return-value]
