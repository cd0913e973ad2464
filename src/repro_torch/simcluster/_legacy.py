"""Frozen copy of the seed (pre-index) scheduling/simulation engine.

This is the port's own copy of the JAX package's ``simcluster/_legacy.py``
(pure Python).  Every class it uses (``OnlineEstimator``, the types,
``Launch``, ``RunningTask`` and ``SimResult``) comes from the port, so its
results are the port's own classes; a test holds them, dumped, byte-equal
to the original's.

This module preserves the original O(jobs × tasks) hot paths exactly as they
shipped in the seed commit: list-rebuild task scans, full cross-job
``has_local_pending`` walks, per-heartbeat speculation rescans, and the
all-machines reconfigurator sweeps.  It exists for two reasons only:

* the decision-parity tests pin the optimized engine to these semantics —
  fixed-seed paper-cluster runs must reproduce the legacy ``SimResult``
  metrics exactly;
* ``scripts/bench_torch_sim.py`` measures the indexed engine's speedup against
  this baseline.

Do not "fix" or optimize anything here; behavioural drift silently weakens
the parity contract.  The only differences from the seed files are renames
(``Legacy*`` prefixes) and imports.
"""
from __future__ import annotations

import heapq
import math
from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, Dict, List, Optional, Set, Tuple

import random

from repro_torch.core.estimator import OnlineEstimator
from repro_torch.core.types import (ClusterSpec, JobRuntime, JobSpec, TaskId,
                                    TaskKind)
from repro_torch.core.scheduler import Launch


# ---------------------------------------------------------------------------
# Reconfigurator (seed core/reconfigurator.py)
# ---------------------------------------------------------------------------
@dataclass
class LegacyParkedTask:
    task: TaskId
    target_vm: int
    parked_at: float


@dataclass
class LegacyPendingPlug:
    machine: int
    from_vm: int
    to_vm: int
    task: TaskId
    ready_at: float


class LegacyReconfigurator:
    """Seed AQ/RQ tracker: every query scans full queues / all machines."""

    def __init__(self, spec: ClusterSpec, max_wait: float = 15.0):
        self.spec = spec
        self.max_wait = max_wait
        self.vcpus: List[int] = [spec.base_map_slots] * spec.num_nodes
        self.aq: List[Deque[LegacyParkedTask]] = [
            deque() for _ in range(spec.num_machines)]
        self.rq: List[Deque[int]] = [deque() for _ in range(spec.num_machines)]
        self.in_flight: List[LegacyPendingPlug] = []
        self.validator: Optional[Callable[[int], bool]] = None
        self.stats = {"reconfigurations": 0, "parked": 0, "expired": 0,
                      "total_wait": 0.0}

    def _valid_donor(self, vm: int) -> bool:
        if self.vcpus[vm] <= self.spec.min_vcpus_per_vm:
            return False
        return self.validator(vm) if self.validator is not None else True

    def aq_len(self, vm: int) -> int:
        return sum(1 for t in self.aq[self.spec.machine_of(vm)]
                   if t.target_vm == vm)

    def rq_len(self, vm: int) -> int:
        return sum(1 for cand in self.rq[self.spec.machine_of(vm)]
                   if cand != vm and self._valid_donor(cand))

    def park_task(self, task: TaskId, target_vm: int, now: float) -> None:
        self.aq[self.spec.machine_of(target_vm)].append(
            LegacyParkedTask(task, target_vm, now))
        self.stats["parked"] += 1

    def release_core(self, vm: int, now: float) -> None:
        if self.vcpus[vm] <= self.spec.min_vcpus_per_vm:
            return
        self.rq[self.spec.machine_of(vm)].append(vm)

    def cancel_parked(self, task: TaskId) -> bool:
        for q in self.aq:
            for item in list(q):
                if item.task == task:
                    q.remove(item)
                    return True
        return False

    def match(self, now: float, donor_ok=None) -> List[LegacyPendingPlug]:
        started = []
        for m in range(self.spec.num_machines):
            while self.aq[m] and self.rq[m]:
                parked = self.aq[m].popleft()
                donor = None
                while self.rq[m]:
                    cand = self.rq[m].popleft()
                    if (cand != parked.target_vm and self._valid_donor(cand)
                            and (donor_ok is None or donor_ok(cand))):
                        donor = cand
                        break
                if donor is None:
                    self.aq[m].appendleft(parked)
                    break
                if self.vcpus[parked.target_vm] >= self.spec.max_vcpus_per_vm:
                    self.rq[m].append(donor)
                    self.aq[m].append(parked)
                    break
                self.vcpus[donor] -= 1
                plug = LegacyPendingPlug(m, donor, parked.target_vm,
                                         parked.task,
                                         now + self.spec.hotplug_latency)
                self.in_flight.append(plug)
                started.append(plug)
                self.stats["reconfigurations"] += 1
                self.stats["total_wait"] += now - parked.parked_at
        return started

    def complete_plugs(self, now: float) -> List[LegacyPendingPlug]:
        done = [p for p in self.in_flight if p.ready_at <= now]
        self.in_flight = [p for p in self.in_flight if p.ready_at > now]
        for p in done:
            self.vcpus[p.to_vm] += 1
        return done

    def expire_stale(self, now: float) -> List[LegacyParkedTask]:
        out = []
        for q in self.aq:
            for item in list(q):
                if now - item.parked_at > self.max_wait:
                    q.remove(item)
                    out.append(item)
                    self.stats["expired"] += 1
        return out

    @property
    def total_vcpus(self) -> int:
        return sum(self.vcpus) + len(self.in_flight)


# ---------------------------------------------------------------------------
# Schedulers (seed core/scheduler.py + core/baselines.py)
# ---------------------------------------------------------------------------
class LegacySchedulerBase:
    """Seed bookkeeping: unstarted sets rebuilt by scanning range(u_m)."""

    name = "base"
    uses_reconfig = False

    def __init__(self, spec: ClusterSpec):
        self.spec = spec
        self.jobs: Dict[str, JobRuntime] = {}
        self.order: List[str] = []

    def job_added(self, job: JobSpec, now: float) -> None:
        rt = JobRuntime(spec=job)
        self.jobs[job.job_id] = rt
        self.order.append(job.job_id)
        self.on_job_added(rt, now)

    def on_job_added(self, job: JobRuntime, now: float) -> None:
        pass

    def task_started(self, task: TaskId, node: int, now: float) -> None:
        job = self.jobs[task.job_id]
        if task.kind == TaskKind.MAP:
            job.running_map[task.index] = node
        else:
            job.running_reduce[task.index] = node

    def task_finished(self, task: TaskId, node: int, now: float,
                      duration: float) -> None:
        job = self.jobs[task.job_id]
        if task.kind == TaskKind.MAP:
            job.running_map.pop(task.index, None)
            job.completed_map.add(task.index)
            job.map_durations.append(duration)
        else:
            job.running_reduce.pop(task.index, None)
            job.completed_reduce.add(task.index)
            job.reduce_durations.append(duration)
        if job.finished and job.finish_time is None:
            job.finish_time = now
        self.on_task_finished(job, task, now)

    def on_task_finished(self, job: JobRuntime, task: TaskId,
                         now: float) -> None:
        pass

    def _unstarted_map_tasks(self, job: JobRuntime) -> List[int]:
        done = job.completed_map
        running = job.running_map
        return [i for i in range(job.spec.u_m)
                if i not in done and i not in running]

    def _unstarted_reduce_tasks(self, job: JobRuntime) -> List[int]:
        done = job.completed_reduce
        running = job.running_reduce
        return [i for i in range(job.spec.v_r)
                if i not in done and i not in running]

    def _local_map_candidates(self, job: JobRuntime, node: int) -> List[int]:
        return [i for i in self._unstarted_map_tasks(job)
                if node in job.spec.block_placement[i]]

    def active_jobs(self) -> List[JobRuntime]:
        return [self.jobs[j] for j in self.order if not self.jobs[j].finished]

    def select(self, node: int, free_map: int, free_reduce: int,
               now: float) -> List[Launch]:
        raise NotImplementedError


class LegacyCompletionTimeScheduler(LegacySchedulerBase):
    name = "proposed"
    uses_reconfig = True

    def __init__(self, spec: ClusterSpec,
                 reconfig: Optional[LegacyReconfigurator] = None,
                 estimator: Optional[OnlineEstimator] = None):
        super().__init__(spec)
        self.reconfig = reconfig or LegacyReconfigurator(spec)
        self.estimator = estimator or OnlineEstimator()
        self.parked: Set[TaskId] = set()
        self.no_park: Set[TaskId] = set()
        self.park_depth = 2
        self.max_slots = spec.num_nodes * spec.base_map_slots

    def on_job_added(self, job: JobRuntime, now: float) -> None:
        self._recompute_demand(job, now)

    def on_task_finished(self, job: JobRuntime, task: TaskId,
                         now: float) -> None:
        self._recompute_demand(job, now)

    def _recompute_demand(self, job: JobRuntime, now: float) -> None:
        job.demand = self.estimator.demand(
            job, now, max_map_slots=self.max_slots,
            max_reduce_slots=self.max_slots)

    def _scheduled_maps(self, job: JobRuntime) -> int:
        parked = sum(1 for t in self.parked if t.job_id == job.spec.job_id
                     and t.kind == TaskKind.MAP)
        return len(job.running_map) + parked

    def select(self, node: int, free_map: int, free_reduce: int,
               now: float) -> List[Launch]:
        out: List[Launch] = []
        jobs = self.active_jobs()
        bootstrap = [j for j in jobs if not j.started]
        edf = sorted((j for j in jobs if j.started),
                     key=lambda j: j.absolute_deadline)
        for phase in ("demand", "backfill", "remote_fill"):
            if phase == "demand":
                ordered = bootstrap + edf
            else:
                ordered = sorted(jobs, key=lambda j: j.absolute_deadline)
            if phase == "remote_fill":
                m = self.spec.machine_of(node)
                pending = sum(1 for p in self.reconfig.aq[m]
                              if p.target_vm != node)
                while (free_map > 0 and pending > 0
                       and self.reconfig.vcpus[node]
                       > self.spec.min_vcpus_per_vm):
                    self.reconfig.release_core(node, now)
                    free_map -= 1
                    pending -= 1
            for job in ordered:
                if free_map <= 0 and free_reduce <= 0:
                    break
                demand = job.demand
                n_m = demand.n_m if demand else 1
                n_r = demand.n_r if demand else 1
                if phase != "demand":
                    n_m, n_r = job.spec.u_m, job.spec.v_r
                if not job.map_finished:
                    while free_map > 0 and self._scheduled_maps(job) < n_m:
                        launch = self._assign_map(
                            job, node, now,
                            allow_park=(phase != "remote_fill"))
                        if launch is None:
                            break
                        if launch.via_reconfig:
                            pass
                        else:
                            out.append(launch)
                            free_map -= 1
                            job.running_map[launch.task.index] = launch.node
                            if launch.local:
                                job.local_map_launches += 1
                            else:
                                job.remote_map_launches += 1
                elif not job.finished:
                    unstarted = self._unstarted_reduce_tasks(job)
                    while (free_reduce > 0 and unstarted
                           and len(job.running_reduce) < n_r):
                        idx = unstarted.pop(0)
                        t = TaskId(job.spec.job_id, TaskKind.REDUCE, idx)
                        out.append(Launch(t, node, local=True))
                        job.running_reduce[idx] = node
                        free_reduce -= 1
        return out

    def _assign_map(self, job: JobRuntime, node: int, now: float,
                    allow_park: bool = True) -> Optional[Launch]:
        local = self._local_map_candidates(job, node)
        if local:
            idx = local[0]
            return Launch(TaskId(job.spec.job_id, TaskKind.MAP, idx), node,
                          local=True)
        unstarted = [i for i in self._unstarted_map_tasks(job)
                     if TaskId(job.spec.job_id, TaskKind.MAP, i)
                     not in self.parked]
        if not unstarted:
            return None
        idx = unstarted[0]
        task = TaskId(job.spec.job_id, TaskKind.MAP, idx)
        placement = job.spec.block_placement[idx]
        slack = job.absolute_deadline - now
        deadline_critical = slack <= 3.0 * self.reconfig.max_wait
        if task in self.no_park or deadline_critical or not allow_park:
            return Launch(task, node, local=False)
        s_rq = sorted(placement, key=lambda v: -self.reconfig.rq_len(v))
        if self.reconfig.rq_len(s_rq[0]) > 0:
            p = s_rq[0]
        else:
            p = min(placement, key=lambda v: self.reconfig.aq_len(v))
            if len(self.reconfig.aq[self.spec.machine_of(p)]) >= self.park_depth:
                return None
        self.reconfig.park_task(task, p, now)
        self.reconfig.release_core(node, now)
        self.parked.add(task)
        return Launch(task, p, local=True, via_reconfig=True)

    def has_local_pending(self, vm: int) -> bool:
        for job in self.active_jobs():
            if job.map_finished:
                continue
            for i in self._unstarted_map_tasks(job):
                if vm in job.spec.block_placement[i]:
                    return True
        return False

    def parked_task_launched(self, task: TaskId, node: int,
                             now: float) -> None:
        self.parked.discard(task)
        job = self.jobs[task.job_id]
        job.running_map[task.index] = node
        job.local_map_launches += 1
        job.reconfig_map_launches += 1

    def parked_task_expired(self, task: TaskId, now: float) -> None:
        self.parked.discard(task)
        self.no_park.add(task)


class LegacyFairScheduler(LegacySchedulerBase):
    name = "fair"

    def __init__(self, spec: ClusterSpec, locality_delay: int = 0):
        super().__init__(spec)
        self.locality_delay = locality_delay
        self._skips: Dict[str, int] = {}

    def _running_slots(self, job: JobRuntime) -> int:
        return len(job.running_map) + len(job.running_reduce)

    def select(self, node: int, free_map: int, free_reduce: int,
               now: float) -> List[Launch]:
        out: List[Launch] = []
        while free_map > 0 or free_reduce > 0:
            jobs = [j for j in self.active_jobs()]
            if not jobs:
                break
            jobs.sort(key=lambda j: (self._running_slots(j),
                                     j.spec.submit_time))
            launched = False
            for job in jobs:
                jid = job.spec.job_id
                if free_map > 0 and not job.map_finished:
                    local = self._local_map_candidates(job, node)
                    if local:
                        idx = local[0]
                        self._skips[jid] = 0
                        t = TaskId(jid, TaskKind.MAP, idx)
                        out.append(Launch(t, node, local=True))
                        job.running_map[idx] = node
                        job.local_map_launches += 1
                        free_map -= 1
                        launched = True
                        break
                    unstarted = self._unstarted_map_tasks(job)
                    if unstarted:
                        if self._skips.get(jid, 0) < self.locality_delay:
                            self._skips[jid] = self._skips.get(jid, 0) + 1
                            continue
                        self._skips[jid] = 0
                        idx = unstarted[0]
                        t = TaskId(jid, TaskKind.MAP, idx)
                        out.append(Launch(t, node, local=False))
                        job.running_map[idx] = node
                        job.remote_map_launches += 1
                        free_map -= 1
                        launched = True
                        break
                if free_reduce > 0 and job.map_finished and not job.finished:
                    unstarted = self._unstarted_reduce_tasks(job)
                    if unstarted:
                        idx = unstarted[0]
                        t = TaskId(jid, TaskKind.REDUCE, idx)
                        out.append(Launch(t, node, local=True))
                        job.running_reduce[idx] = node
                        free_reduce -= 1
                        launched = True
                        break
            if not launched:
                break
        return out


class LegacyFIFOScheduler(LegacySchedulerBase):
    name = "fifo"

    def select(self, node: int, free_map: int, free_reduce: int,
               now: float) -> List[Launch]:
        out: List[Launch] = []
        for jid in self.order:
            job = self.jobs[jid]
            if job.finished:
                continue
            while free_map > 0 and not job.map_finished:
                local = self._local_map_candidates(job, node)
                cand = local or self._unstarted_map_tasks(job)
                if not cand:
                    break
                idx = cand[0]
                is_local = bool(local)
                out.append(Launch(TaskId(jid, TaskKind.MAP, idx), node,
                                  local=is_local))
                job.running_map[idx] = node
                if is_local:
                    job.local_map_launches += 1
                else:
                    job.remote_map_launches += 1
                free_map -= 1
            while (free_reduce > 0 and job.map_finished and not job.finished):
                unstarted = self._unstarted_reduce_tasks(job)
                if not unstarted:
                    break
                idx = unstarted[0]
                out.append(Launch(TaskId(jid, TaskKind.REDUCE, idx), node,
                                  local=True))
                job.running_reduce[idx] = node
                free_reduce -= 1
            if free_map <= 0 and free_reduce <= 0:
                break
        return out


# ---------------------------------------------------------------------------
# Simulator (seed simcluster/sim.py)
# ---------------------------------------------------------------------------
from repro_torch.simcluster.sim import RunningTask, SimResult  # noqa: E402


class LegacyClusterSim:
    """Seed discrete-event loop: per-heartbeat full rescans everywhere."""

    def __init__(self, spec: ClusterSpec, scheduler: LegacySchedulerBase, *,
                 seed: int = 0, straggler_prob: float = 0.03,
                 straggler_factor: float = 3.0, speculative: bool = True,
                 speculation_threshold: float = 2.0):
        self.spec = spec
        self.sched = scheduler
        self.rng = random.Random(seed)
        self.straggler_prob = straggler_prob
        self.straggler_factor = straggler_factor
        self.speculative = speculative
        self.spec_threshold = speculation_threshold

        n = spec.num_nodes
        self.map_running: List[List[RunningTask]] = [[] for _ in range(n)]
        self.red_running: List[List[RunningTask]] = [[] for _ in range(n)]
        self.live: Dict[Tuple[TaskId, bool], RunningTask] = {}
        self.finished_tasks: set = set()
        self.spec_launched: set = set()
        self.n_speculative = 0
        self.events: List[Tuple[float, int, str, object]] = []
        self._seq = 0
        self.events_processed = 0
        self.reconfig: Optional[LegacyReconfigurator] = getattr(
            scheduler, "reconfig", None) if scheduler.uses_reconfig else None
        if self.reconfig is not None:
            self.reconfig.validator = lambda vm: self.free_map(vm) > 0

    def map_capacity(self, node: int) -> int:
        if self.reconfig is not None:
            return self.reconfig.vcpus[node]
        return self.spec.base_map_slots

    def free_map(self, node: int) -> int:
        return self.map_capacity(node) - len(self.map_running[node])

    def free_reduce(self, node: int) -> int:
        return self.spec.base_reduce_slots - len(self.red_running[node])

    def _push(self, t: float, kind: str, data=None) -> None:
        self._seq += 1
        heapq.heappush(self.events, (t, self._seq, kind, data))

    def _jitter(self, cv: float) -> float:
        if cv <= 0:
            return 1.0
        sigma = math.sqrt(math.log(1 + cv * cv))
        return self.rng.lognormvariate(-sigma * sigma / 2, sigma)

    def task_duration(self, job: JobRuntime, task: TaskId,
                      local: bool) -> float:
        prof = job.spec.profile
        if task.kind == TaskKind.MAP:
            base = prof.map_time
            if not local:
                base *= 1.0 + prof.remote_penalty
        else:
            base = prof.reduce_time + job.spec.u_m * prof.shuffle_time_per_pair
        d = base * self._jitter(prof.time_cv)
        if self.rng.random() < self.straggler_prob:
            d *= self.straggler_factor
        return d

    def run(self, jobs: List[JobSpec], until: float = 10_000_000.0) -> SimResult:
        for job in jobs:
            self._push(job.submit_time, "submit", job)
        for node in range(self.spec.num_nodes):
            self._push(
                self.spec.heartbeat_interval * (1 + node / self.spec.num_nodes),
                "heartbeat", node)
        now = 0.0
        while self.events:
            now, _, kind, data = heapq.heappop(self.events)
            if now > until:
                break
            self.events_processed += 1
            if kind == "submit":
                self.sched.job_added(data, now)
            elif kind == "finish":
                self._on_finish(data, now)
            elif kind == "plug":
                self._on_plug_ready(now)
            elif kind == "heartbeat":
                node = data
                self._heartbeat(node, now)
                if any(not j.finished for j in self.sched.jobs.values()) or \
                        not self.sched.jobs:
                    self._push(now + self.spec.heartbeat_interval, "heartbeat",
                               node)
        result = SimResult(
            scheduler=self.sched.name,
            jobs=self.sched.jobs,
            makespan=max((j.finish_time or now)
                         for j in self.sched.jobs.values())
            if self.sched.jobs else 0.0,
            reconfig_stats=dict(self.reconfig.stats) if self.reconfig else {},
            speculative_launches=self.n_speculative,
            events_processed=self.events_processed,
        )
        return result

    def _launch(self, launch: Launch, now: float,
                speculative: bool = False) -> None:
        job = self.sched.jobs[launch.task.job_id]
        dur = self.task_duration(job, launch.task, launch.local)
        rt = RunningTask(launch.task, launch.node, now, now + dur,
                         launch.local, speculative)
        if launch.task.kind == TaskKind.MAP:
            self.map_running[launch.node].append(rt)
        else:
            self.red_running[launch.node].append(rt)
        self.live[(launch.task, speculative)] = rt
        self._push(rt.finish, "finish", rt)

    def _on_finish(self, rt: RunningTask, now: float) -> None:
        if (rt.task, rt.speculative) not in self.live:
            return
        del self.live[(rt.task, rt.speculative)]
        lst = (self.map_running if rt.task.kind == TaskKind.MAP
               else self.red_running)[rt.node]
        if rt in lst:
            lst.remove(rt)
        if rt.task in self.finished_tasks:
            return
        self.finished_tasks.add(rt.task)
        twin_key = (rt.task, not rt.speculative)
        if twin_key in self.live:
            twin = self.live.pop(twin_key)
            tl = (self.map_running if rt.task.kind == TaskKind.MAP
                  else self.red_running)[twin.node]
            if twin in tl:
                tl.remove(twin)
        self.sched.task_finished(rt.task, rt.node, now, now - rt.start)
        if self.reconfig is not None and rt.task.kind == TaskKind.MAP:
            vm = rt.node
            if (self.free_map(vm) > 0
                    and (self.reconfig.vcpus[vm] > self.spec.base_map_slots
                         or (isinstance(self.sched,
                                        LegacyCompletionTimeScheduler)
                             and not self.sched.has_local_pending(vm)))):
                self.reconfig.release_core(vm, now)
            self._match_reconfig(now)

    def _on_plug_ready(self, now: float) -> None:
        if self.reconfig is None:
            return
        for plug in self.reconfig.complete_plugs(now):
            task = plug.task
            job = self.sched.jobs.get(task.job_id)
            if job is None or task.index in job.completed_map:
                continue
            self.sched.parked_task_launched(task, plug.to_vm, now)
            self._launch(Launch(task, plug.to_vm, local=True,
                                via_reconfig=True), now)

    def _match_reconfig(self, now: float) -> None:
        if self.reconfig is None:
            return
        started = self.reconfig.match(
            now, donor_ok=lambda vm: self.free_map(vm) > 0)
        for plug in started:
            self._push(plug.ready_at, "plug", None)

    def _heartbeat(self, node: int, now: float) -> None:
        if self.reconfig is not None:
            for parked in self.reconfig.expire_stale(now):
                if isinstance(self.sched, LegacyCompletionTimeScheduler):
                    self.sched.parked_task_expired(parked.task, now)
            self._match_reconfig(now)
        fm, fr = self.free_map(node), self.free_reduce(node)
        if fm > 0 or fr > 0:
            for launch in self.sched.select(node, fm, fr, now):
                self._launch(launch, now)
            self._match_reconfig(now)
        if self.speculative:
            self._maybe_speculate(node, now)

    def _maybe_speculate(self, node: int, now: float) -> None:
        if self.free_map(node) <= 0:
            return
        for job in self.sched.jobs.values():
            if job.finished or not job.map_durations:
                continue
            mean = sum(job.map_durations) / len(job.map_durations)
            for idx, vnode in list(job.running_map.items()):
                task = TaskId(job.spec.job_id, TaskKind.MAP, idx)
                key = (task, False)
                if key not in self.live or task in self.spec_launched:
                    continue
                rt = self.live[key]
                if now - rt.start > self.spec_threshold * mean:
                    self.spec_launched.add(task)
                    self.n_speculative += 1
                    local = node in job.spec.block_placement[idx]
                    self._launch(Launch(task, node, local=local), now,
                                 speculative=True)
                    return
