"""Fleet scheduler: the paper's algorithms running a multi-job pool of chips,
the JAX package's ``elastic/fleet.py`` on the port.

Mapping:
  map task        -> one microbatch train step
  map slot        -> one chip in a job's data-parallel mesh
  t_m             -> measured per-step time (per chip-normalized)
  Eq. 10          -> minimum chips for the job to hit its deadline
  Algorithm 1     -> chip Assign/Release queues per *host* (4 chips/host);
                     a job wanting a chip on the host that stores its data
                     shards parks a grow-request; jobs past their demand
                     release chips; matches move a chip between jobs
  vCPU hot-plug   -> checkpoint -> rebuild the step on the resized mesh ->
                     restore (a step binds its devices when it is built, so
                     "hot-plug" happens at step boundaries)
  heartbeat       -> per-step completion callbacks

Fault tolerance: a failed host's chips are dropped from the pool; affected
jobs resize-restore from their last checkpoint.  Straggling hosts are
drained the same way (straggler mitigation = elastic shrink away from the
slow host).

A chip is an index into ``ChipPool.devices``, a list of ``torch.device``s;
several chips may name one device (logical chips of one card, as the
example's pool on one H100).  A job's mesh is a ``launch.mesh.ChipMesh``:
one ``("data",)`` axis holding its chips' devices in chip order.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.core.estimator import min_slots
from repro_torch.launch.mesh import ChipMesh


@dataclass
class FleetJob:
    job_id: str
    deadline: float                     # seconds from submission
    total_steps: int
    make_step: Callable                 # (mesh) -> (step_fn, state, place)
    preferred_hosts: Tuple[int, ...] = ()   # where its data shards live
    min_chips: int = 1
    # runtime state
    chips: List[int] = field(default_factory=list)     # chip ids
    step: int = 0
    submitted_at: float = 0.0
    finished_at: Optional[float] = None
    step_times: List[float] = field(default_factory=list)
    resizes: int = 0
    state: object = None
    step_fn: Optional[Callable] = None

    @property
    def done(self) -> bool:
        return self.step >= self.total_steps

    def t_step(self) -> Optional[float]:
        if not self.step_times:
            return None
        recent = self.step_times[-8:]
        return sum(recent) / len(recent)

    def demanded_chips(self, now: float, total_chips: int) -> int:
        """Eq. 10 with u_m = remaining steps, work ∝ chips·time."""
        t = self.t_step()
        if t is None:
            return max(self.min_chips, len(self.chips) or 1)
        remaining = self.total_steps - self.step
        if remaining <= 0:
            return 0
        time_left = max(self.deadline - (now - self.submitted_at), 1e-3)
        # one "map task" = one step at current width; normalize to chip-steps
        chip_seconds = remaining * t * max(len(self.chips), 1)
        d = min_slots(u_m=remaining, v_r=1,
                      t_m=chip_seconds / remaining, t_r=0.0, t_s=0.0,
                      deadline=time_left, max_map_slots=total_chips)
        want = max(self.min_chips, min(d.n_m, total_chips))
        # snap UP to a power of two: allocations are mesh slices
        snapped = 1
        while snapped < want:
            snapped *= 2
        return min(snapped, total_chips)


class ChipPool:
    """Host-grouped chip inventory with AQ/RQ per host (Algorithm 1)."""

    def __init__(self, devices: Sequence, chips_per_host: int = 4):
        self.devices = list(devices)
        self.chips_per_host = chips_per_host
        self.num_hosts = (len(self.devices) + chips_per_host - 1) // chips_per_host
        self.owner: Dict[int, Optional[str]] = {i: None for i in range(len(self.devices))}
        self.dead_hosts: set = set()
        self.aq: List[Deque[str]] = [deque() for _ in range(self.num_hosts)]
        self.rq: List[Deque[int]] = [deque() for _ in range(self.num_hosts)]
        self.reconfigurations = 0

    def host_of(self, chip: int) -> int:
        return chip // self.chips_per_host

    def free_chips(self, host: Optional[int] = None) -> List[int]:
        return [c for c, o in self.owner.items()
                if o is None and self.host_of(c) not in self.dead_hosts
                and (host is None or self.host_of(c) == host)]

    def allocate(self, job_id: str, n: int,
                 preferred_hosts: Sequence[int] = ()) -> List[int]:
        got = []
        for h in preferred_hosts:
            for c in self.free_chips(h):
                if len(got) >= n:
                    break
                self.owner[c] = job_id
                got.append(c)
        for c in self.free_chips():
            if len(got) >= n:
                break
            self.owner[c] = job_id
            got.append(c)
        return got

    def release(self, chips: Sequence[int]) -> None:
        for c in chips:
            self.owner[c] = None
            self.rq[self.host_of(c)].append(c)

    def park_grow(self, job_id: str, host: int) -> None:
        self.aq[host].append(job_id)

    def match(self) -> List[Tuple[str, int]]:
        """AQ/RQ pairing per host -> (job, chip) grants."""
        grants = []
        for h in range(self.num_hosts):
            while self.aq[h] and self.rq[h]:
                job = self.aq[h].popleft()
                chip = self.rq[h].popleft()
                if self.owner.get(chip) is not None:
                    continue            # stale offer
                self.owner[chip] = job
                grants.append((job, chip))
                self.reconfigurations += 1
        return grants

    def fail_host(self, host: int) -> List[str]:
        """Kill a host; returns affected job ids."""
        self.dead_hosts.add(host)
        affected = set()
        for c in range(host * self.chips_per_host,
                       min((host + 1) * self.chips_per_host, len(self.devices))):
            if self.owner[c] is not None:
                affected.add(self.owner[c])
            self.owner[c] = None
        return sorted(affected)


class EstimatorBridge:
    """Keeps the paper symbols visible for tests: A=u_m·t_m etc."""

    @staticmethod
    def demand(remaining_steps: int, t_step: float, width: int,
               time_left: float, total_chips: int) -> int:
        """The fewest devices that finish ``remaining_steps`` steps of
        ``t_step`` seconds on ``width`` devices within ``time_left``."""
        chip_seconds = remaining_steps * t_step * max(width, 1)
        d = min_slots(u_m=remaining_steps, v_r=1,
                      t_m=chip_seconds / remaining_steps, t_r=0.0, t_s=0.0,
                      deadline=max(time_left, 1e-3),
                      max_map_slots=total_chips)
        return d.n_m


class FleetScheduler:
    """EDF + Eq.-10 demands + AQ/RQ chip movement, at step granularity.

    ``run`` drives all jobs cooperatively (round-robin one step per tick) —
    a stand-in for per-job processes on a real fleet.  Resizes happen at
    step boundaries via checkpoint -> rebuild -> restore.

    A job's ``make_step(mesh)`` returns ``(step_fn, state, place)``:
    ``step_fn(state) -> state``, the fresh state (a tree of tensors, the
    template a restore fills), and the device a restore puts every leaf on
    (the job's first chip's), where the JAX package's returns shardings.
    """

    def __init__(self, pool: ChipPool, ckpt_root: str,
                 clock: Callable[[], float] = time.monotonic):
        self.pool = pool
        self.ckpt_root = ckpt_root
        self.clock = clock
        self.jobs: Dict[str, FleetJob] = {}
        self.events: List[str] = []

    # -- lifecycle -----------------------------------------------------------
    def submit(self, job: FleetJob) -> None:
        job.submitted_at = self.clock()
        self.jobs[job.job_id] = job
        want = max(job.min_chips, 1)
        chips = self.pool.allocate(job.job_id, want, job.preferred_hosts)
        job.chips = chips
        self._build(job)
        self.events.append(f"submit {job.job_id} chips={chips}")

    def _mesh(self, job: FleetJob) -> ChipMesh:
        return ChipMesh([self.pool.devices[c] for c in job.chips])

    def _build(self, job: FleetJob, restore: bool = True) -> None:
        mesh = self._mesh(job)
        step_fn, state, place = job.make_step(mesh)
        ck = f"{self.ckpt_root}/{job.job_id}"
        last = latest_step(ck) if restore else None
        if last is not None:
            state = restore_checkpoint(ck, last, state, place)
            job.step = last
        job.step_fn, job.state = step_fn, state

    # -- elastic resize ---------------------------------------------------------
    def _resize(self, job: FleetJob, new_chips: List[int]) -> None:
        ck = f"{self.ckpt_root}/{job.job_id}"
        save_checkpoint(ck, job.step, job.state)
        self.pool.release([c for c in job.chips if c not in new_chips])
        job.chips = new_chips
        job.resizes += 1
        self._build(job)
        self.events.append(f"resize {job.job_id} -> {len(new_chips)} chips")

    # -- scheduling tick -----------------------------------------------------
    def rebalance(self) -> None:
        now = self.clock()
        total = len([c for c in self.pool.owner
                     if self.pool.host_of(c) not in self.pool.dead_hosts])
        active = [j for j in self.jobs.values() if not j.done]
        # EDF order for grants
        active.sort(key=lambda j: j.submitted_at + j.deadline)
        for job in active:
            demand = job.demanded_chips(now, total)
            have = len(job.chips)
            if demand > have:
                # grow: prefer hosts holding the job's data (locality);
                # park on AQ, and claim any free chips right away
                free = self.pool.allocate(job.job_id, demand - have,
                                          job.preferred_hosts)
                if free:
                    self._resize(job, job.chips + free)
                for h in (job.preferred_hosts or range(self.pool.num_hosts)):
                    if len(job.chips) >= demand:
                        break
                    self.pool.park_grow(job.job_id, h)
            elif demand < have and have > job.min_chips:
                # release surplus (Algorithm 1's RQ registration)
                surplus = min(have - max(demand, job.min_chips), have - 1)
                if surplus > 0:
                    keep = job.chips[:have - surplus]
                    self._resize(job, keep)
        # AQ/RQ matching -> grants
        grants: Dict[str, List[int]] = {}
        for job_id, chip in self.pool.match():
            grants.setdefault(job_id, []).append(chip)
        for job_id, chips in grants.items():
            job = self.jobs[job_id]
            if job.done:
                self.pool.release(chips)
                continue
            self._resize(job, job.chips + chips)

    def handle_host_failure(self, host: int) -> None:
        affected = self.pool.fail_host(host)
        self.events.append(f"host {host} FAILED; affected={affected}")
        for job_id in affected:
            job = self.jobs[job_id]
            survivors = [c for c in job.chips
                         if self.pool.host_of(c) not in self.pool.dead_hosts]
            for c in survivors:
                self.pool.owner[c] = job.job_id
            if not survivors:
                survivors = self.pool.allocate(job.job_id, 1,
                                               job.preferred_hosts)
            job.chips = survivors
            self._build(job)        # restore from last checkpoint
            self.events.append(
                f"recovered {job_id} on {len(survivors)} chips @step {job.step}")

    # -- driver -----------------------------------------------------------------
    def _wait(self, job: FleetJob) -> None:
        """Block until the job's devices have run what its step launched, so
        that a step time is the device's, not the launches'."""
        for dev in {self.pool.devices[c] for c in job.chips}:
            dev = torch.device(dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def run(self, *, rebalance_every: int = 4, ckpt_every: int = 8,
            max_ticks: int = 10_000) -> None:
        tick = 0
        while any(not j.done for j in self.jobs.values()) and tick < max_ticks:
            tick += 1
            for job in list(self.jobs.values()):
                if job.done or job.step_fn is None:
                    continue
                t0 = self.clock()
                job.state = job.step_fn(job.state)
                self._wait(job)
                job.step_times.append(self.clock() - t0)
                job.step += 1
                if job.step % ckpt_every == 0:
                    save_checkpoint(f"{self.ckpt_root}/{job.job_id}", job.step,
                                    job.state)
                if job.done:
                    job.finished_at = self.clock()
                    self.pool.release(job.chips)
                    job.chips = []
                    self.events.append(f"done {job.job_id} step={job.step}")
            if tick % rebalance_every == 0:
                self.rebalance()
