"""Discrete-event simulator of the virtualized MapReduce cluster (paper §5).

This is the port's own copy of the JAX package's ``simcluster/sim.py``: the
event engine, pure Python on the host, and the fluid surrogate's oracle.
It draws from ``random.Random(seed)`` in the original's order and breaks heap
ties by the original's sequence numbers, so its ``RunRecord`` dumps are
byte-equal to the original's (a test holds them so).

Models: physical machines hosting VMs, per-VM map/reduce slots, HDFS-style
replicated block placement, remote-read penalty for non-local map tasks,
heartbeats (3 s), vCPU hot-plug latency, per-task duration jitter,
stragglers + speculative re-execution.

The simulator is scheduler-agnostic: any ``SchedulerBase`` subclass plugs in.
For ``CompletionTimeScheduler`` the per-VM map capacity follows the
reconfigurator's live vCPU counts (Algorithm 1); baselines keep the static
slot configuration — exactly the comparison of paper §5.

Engine notes (vs. the frozen seed engine in
``repro_torch.simcluster._legacy``):

* **Speculation is incremental.**  The seed rescanned every running map of
  every job on every heartbeat.  Here each job keeps an insertion-ordered
  run queue (same order as ``running_map`` dict insertion, which the seed
  iterated) plus a lazy wake-time heap: a job is only examined once
  ``head_start + threshold × mean`` has passed.  Every event that can make
  a job eligible earlier (new sample changing the mean, new running task)
  pushes a fresh wake entry, so no eligibility point is missed.  The chosen
  (job, task) is identical to the seed scan: first job in submission order,
  first running map in insertion order.
* **Heartbeats stop when idle and re-arm on submit.**  The seed re-armed a
  node's heartbeat only while some *current* job was unfinished — a job
  submitted after an idle gap was never scheduled (deadlock), while a run
  with no jobs ticked forever.  Heartbeat chains now die when there is no
  active job, and every ``submit`` event revives dead chains.
* **Fault injection** (``ClusterSpec.faults``, off by default — see
  ``FaultConfig``): per-machine crash/restart processes with exponential
  up/down times, loss + deterministic re-execution of the crashed node's
  running tasks, re-replication of dead blocks after a grace window,
  correlated straggler bursts, and heterogeneous machine classes.  Every
  fault draw comes from dedicated per-machine RNG streams (seeded by the
  sim seed + machine id only), so the disabled path consumes zero draws
  from the duration RNG — decision parity with the legacy engine is
  untouched — and an enabled run's fault schedule is reproducible
  byte-for-byte per (config, seed).  Down nodes stop heartbeating (their
  chain epoch is bumped, so stale chains die on pop) and restart re-arms
  them; fault chains suspend while the cluster is idle and revive on
  submit, exactly like heartbeat chains, so a drained run terminates.
* ``events_processed`` counts processed events for benchmarking.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.core.reconfigurator import Reconfigurator
from repro_torch.core.scheduler import CompletionTimeScheduler, Launch, SchedulerBase
from repro_torch.core.tracing import FaultEvent, TraceBus
from repro_torch.core.types import ClusterSpec, JobRuntime, JobSpec, TaskId, TaskKind


@dataclass
class RunningTask:
    task: TaskId
    node: int
    start: float
    finish: float
    local: bool
    speculative: bool = False
    # set by _kill_running when a crash kills this attempt: its pending
    # finish event is void (the task may re-launch under the same live key)
    dead: bool = False
    # set when speculation cancels this attempt (its twin finished first):
    # distinguishes an already-killed attempt's stale finish from the
    # reconfig double-launch loser, which is dropped silently otherwise
    cancelled: bool = False


@dataclass
class SimResult:
    scheduler: str
    jobs: Dict[str, JobRuntime]
    makespan: float
    reconfig_stats: Dict[str, float] = field(default_factory=dict)
    speculative_launches: int = 0
    events_processed: int = 0
    # fault injection (empty when FaultConfig is off): per-kind counters
    # and the (time, kind, machine) event log — the log is the
    # determinism pin's artifact (same config+seed => byte-identical)
    fault_stats: Dict[str, int] = field(default_factory=dict)
    fault_log: List[FaultEvent] = field(default_factory=list)
    # decision-trace bus (ClusterSpec.tracing; None when tracing is off)
    trace: Optional[TraceBus] = None
    # serving layer (empty when ServeConfig is off): whole-run latency/
    # SLO/harvest stats plus the per-tick request log — the log is the
    # determinism pin's artifact (same config+seed => byte-identical)
    serve_stats: Dict[str, object] = field(default_factory=dict)
    serve_log: List[list] = field(default_factory=list)

    # -- derived metrics ----------------------------------------------------
    def completion_time(self, job_id: str) -> float:
        j = self.jobs[job_id]
        return (j.finish_time or math.inf) - j.spec.submit_time

    def throughput_jobs_per_hour(self) -> float:
        done = [j for j in self.jobs.values() if j.finish_time is not None]
        if not done or self.makespan <= 0:
            return 0.0
        return len(done) * 3600.0 / self.makespan

    def deadlines_met(self) -> int:
        return sum(1 for j in self.jobs.values()
                   if j.finish_time is not None
                   and j.finish_time <= j.absolute_deadline + 1e-9)

    def locality_rate(self) -> float:
        loc = sum(j.local_map_launches for j in self.jobs.values())
        tot = loc + sum(j.remote_map_launches for j in self.jobs.values())
        return loc / tot if tot else 0.0


class _SpecQueue:
    """Insertion-ordered running-map queue of one job, for speculation.

    Mirrors ``running_map`` dict-key order exactly: a re-launch of an index
    already present (parked task also launched directly) keeps its original
    position, like a dict key re-assignment.  Entries are (idx, append-time
    start); the *live* RunningTask's start is authoritative — a later
    re-launch refreshes it, which the eligibility walk accounts for.
    """

    __slots__ = ("entries", "head", "present")

    def __init__(self) -> None:
        self.entries: List[Tuple[int, float]] = []
        self.head = 0
        self.present: Set[int] = set()

    def append(self, idx: int, start: float) -> None:
        if idx not in self.present:
            self.present.add(idx)
            self.entries.append((idx, start))

    def compact(self) -> None:
        if self.head > 64 and self.head * 2 > len(self.entries):
            self.entries = self.entries[self.head:]
            self.head = 0


class ClusterSim:
    def __init__(self, spec: ClusterSpec, scheduler: SchedulerBase, *,
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
        # -- heartbeat liveness (deadlock/churn fix) -------------------------
        self._hb_dead: Set[int] = set()
        self._pending_submits = 0
        # -- incremental speculation state -----------------------------------
        self._spec_q: Dict[str, _SpecQueue] = {}
        self._job_seq: Dict[str, int] = {}
        # (wake_time, job_seq, job_id): job may have an eligible straggler
        # at wake_time; lazy — revalidated on pop
        self._spec_wake: List[Tuple[float, int, str]] = []
        # (job_seq, job_id): jobs whose wake time has passed
        self._spec_ready: List[Tuple[int, str]] = []
        self._spec_ready_set: Set[str] = set()
        self.reconfig: Optional[Reconfigurator] = getattr(
            scheduler, "reconfig", None) if scheduler.uses_reconfig else None
        if self.reconfig is not None:
            self.reconfig.validator = lambda vm: self.free_map(vm) > 0
        # -- decision-trace bus (TraceConfig; None = off, zero overhead) -----
        self.trace: Optional[TraceBus] = None
        if spec.tracing.enabled:
            self.trace = TraceBus(spec.tracing)
            # one bus shared by every decision maker: the scheduler and the
            # reconfigurator emit through the same sink, so the exported
            # trace interleaves launches, parks and latch flips in time order
            scheduler.trace = self.trace
            if self.reconfig is not None:
                self.reconfig.trace = self.trace
            self._next_pressure = 0.0
        # -- fault injection (FaultConfig; None = disabled, zero overhead) ---
        self.faults = spec.faults if spec.faults.enabled else None
        self.down_nodes: Set[int] = set()
        # FaultEvent named tuples: json.dumps renders them byte-identically
        # to the bare (time, kind, machine) tuples of earlier versions, so
        # the byte-reproducibility pins in tests/test_faults.py hold
        self.fault_log: List[FaultEvent] = []
        self.fault_stats = {"crashes": 0, "restarts": 0, "tasks_lost": 0,
                            "tasks_reexecuted": 0, "blocks_rereplicated": 0,
                            "bursts": 0}
        if self.faults is not None:
            m = spec.num_machines
            self.machine_up: List[bool] = [True] * m
            # dedicated per-machine streams: fault schedules are a function
            # of (config, seed, machine) and never touch self.rng, so the
            # duration/straggler draw order is identical with faults off
            self._crash_rng = [random.Random(f"{seed}:fault-crash:{i}")
                               for i in range(m)]
            self._burst_rng = [random.Random(f"{seed}:fault-burst:{i}")
                               for i in range(m)]
            self._machine_epoch: List[int] = [0] * m
            self._node_epoch: List[int] = [0] * spec.num_nodes
            self._burst_until: List[float] = [0.0] * m
            # lost (non-speculative) tasks not yet relaunched — drained by
            # _launch; the chaos audits assert it empties by sim end
            self.lost_pending: Set[TaskId] = set()
            # fault chains suspended because the cluster went idle; the
            # next submit revives them (same liveness rule as heartbeats)
            self._idle_crash_chains: Set[int] = set()
            self._idle_burst_chains: Set[int] = set()
        # -- serving layer (ServeConfig; None = disabled, zero overhead) -----
        # lazy import: serving pulls latency percentiles from
        # repro_torch.experiments.stats, whose package imports this module
        self.serving = None
        self._serve_idle = False
        if spec.serve.active:
            from repro_torch.simcluster.serving import ServingLayer
            self.serving = ServingLayer(spec, seed, sched=scheduler,
                                        reconfig=self.reconfig,
                                        trace=self.trace)

    # -- capacities ----------------------------------------------------------
    def map_capacity(self, node: int) -> int:
        cap = (self.reconfig.vcpus[node] if self.reconfig is not None
               else self.spec.base_map_slots)
        if self.serving is not None:
            # pinned service cores are carved out of the VM's map slots; a
            # harvest borrow shrinks the reservation (never the reconfig's
            # vcpu ledger), a preemptive return grows it back — free_map
            # may then go transiently negative: running maps drain, no new
            # ones launch
            cap -= self.serving.reserved[node]
        return cap

    def free_map(self, node: int) -> int:
        return self.map_capacity(node) - len(self.map_running[node])

    def free_reduce(self, node: int) -> int:
        return self.spec.base_reduce_slots - len(self.red_running[node])

    # -- event machinery ----------------------------------------------------
    def _push(self, t: float, kind: str, data=None) -> None:
        self._seq += 1
        heapq.heappush(self.events, (t, self._seq, kind, data))

    # -- duration model -------------------------------------------------------
    def _jitter(self, cv: float) -> float:
        if cv <= 0:
            return 1.0
        sigma = math.sqrt(math.log(1 + cv * cv))
        return self.rng.lognormvariate(-sigma * sigma / 2, sigma)

    def task_duration(self, job: JobRuntime, task: TaskId, local: bool,
                      node: Optional[int] = None, now: float = 0.0) -> float:
        prof = job.spec.profile
        mc = None
        if self.faults is not None and node is not None:
            # heterogeneous machine class of the hosting node (the base
            # class — all multipliers 1.0 — for a homogeneous fleet)
            mc = self.faults.machine_class(self.spec.machine_of(node))
        if task.kind == TaskKind.MAP:
            base = prof.map_time
            if not local:
                # remote_penalty_scale calibrates the fabric (1GbE -> 40GbE);
                # at the default 1.0 the product is bit-identical to the
                # seed's bare `prof.remote_penalty` (x * 1.0 == x in IEEE754)
                penalty = prof.remote_penalty * self.spec.remote_penalty_scale
                if mc is not None and mc.fabric != 1.0:
                    penalty *= mc.fabric
                base *= 1.0 + penalty
        else:
            # reduce = copy (one stream per mapper) + sort/reduce compute
            base = prof.reduce_time + job.spec.u_m * prof.shuffle_time_per_pair
        if mc is not None and mc.speed != 1.0:
            base *= mc.speed
        d = base * self._jitter(prof.time_cv)
        if self.rng.random() < self.straggler_prob:
            d *= self.straggler_factor
        if (self.faults is not None and node is not None
                and now < self._burst_until[self.spec.machine_of(node)]):
            # correlated straggler episode on this machine
            d *= self.faults.burst_slowdown
        return d

    # -- main loop --------------------------------------------------------------
    def run(self, jobs: List[JobSpec], until: float = 10_000_000.0) -> SimResult:
        faults = self.faults
        if faults is not None:
            # re-replication mutates block placements in place: give this
            # run its own placement lists so a caller-shared JobSpec (e.g.
            # the fuzz harness running one scenario through two engines)
            # never sees another run's mutations
            jobs = [dataclasses.replace(
                j, block_placement=[tuple(p) for p in j.block_placement])
                for j in jobs]
        self._pending_submits = len(jobs)
        for job in jobs:
            self._push(job.submit_time, "submit", job)
        for node in range(self.spec.num_nodes):
            self._push(self.spec.heartbeat_interval * (1 + node / self.spec.num_nodes),
                       "heartbeat", node if faults is None else (node, 0))
        if faults is not None:
            if faults.crash_mtbf > 0:
                for m in range(self.spec.num_machines):
                    self._push(faults.crash_warmup + self._next_uptime(m),
                               "crash", m)
            if faults.burst_rate > 0:
                for m in range(self.spec.num_machines):
                    self._push(self._burst_rng[m].expovariate(
                        1.0 / faults.burst_rate), "burst", m)
        if self.serving is not None:
            # one global serve chain at the heartbeat interval; like the
            # heartbeat/fault chains it dies when the cluster drains and
            # the next submit revives it (arrivals are generated from the
            # replicas' own streams at the next tick, so a revived tick
            # covers the whole idle gap with correctly-timed requests)
            self._push(self.spec.heartbeat_interval, "serve", None)
        now = 0.0
        while self.events:
            now, _, kind, data = heapq.heappop(self.events)
            if now > until:
                break
            self.events_processed += 1
            if kind == "submit":
                self._pending_submits -= 1
                self._job_seq[data.job_id] = len(self._job_seq)
                self.sched.job_added(data, now)
                if self.trace is not None and self.trace.launches:
                    rt_job = self.sched.jobs[data.job_id]
                    self.trace.emit(now, "job_submit", {
                        "job": data.job_id, "maps": data.u_m,
                        "reduces": data.v_r,
                        "deadline": rt_job.absolute_deadline})
                if self._hb_dead:
                    # revive heartbeat chains that stopped while the cluster
                    # was idle — without this, a job submitted after an idle
                    # gap would never be scheduled (seed deadlock)
                    if faults is None:
                        for node in sorted(self._hb_dead):
                            self._push(
                                now + self.spec.heartbeat_interval
                                * (1 + node / self.spec.num_nodes),
                                "heartbeat", node)
                        self._hb_dead.clear()
                    else:
                        # down nodes stay dead — their restart re-arms them
                        for node in sorted(self._hb_dead - self.down_nodes):
                            self._push(
                                now + self.spec.heartbeat_interval
                                * (1 + node / self.spec.num_nodes),
                                "heartbeat", (node, self._node_epoch[node]))
                            self._hb_dead.discard(node)
                if faults is not None:
                    self._revive_fault_chains(now)
                if self._serve_idle:
                    self._serve_idle = False
                    self._push(now + self.spec.heartbeat_interval,
                               "serve", None)
            elif kind == "finish":
                self._on_finish(data, now)
            elif kind == "plug":
                self._on_plug_ready(now)
            elif kind == "heartbeat":
                if faults is None:
                    node = data
                else:
                    node, epoch = data
                    if (epoch != self._node_epoch[node]
                            or node in self.down_nodes):
                        # stale chain (the node crashed since this beat was
                        # armed) or currently-down node: the chain dies
                        # here; the machine's restart arms a fresh one
                        continue
                self._heartbeat(node, now)
                if self.sched.has_active_jobs() or (
                        not self.sched.jobs and self._pending_submits > 0):
                    self._push(now + self.spec.heartbeat_interval, "heartbeat",
                               node if faults is None
                               else (node, self._node_epoch[node]))
                else:
                    # idle: let this chain die instead of ticking forever;
                    # the next submit revives it
                    self._hb_dead.add(node)
            elif kind == "serve":
                self._on_serve_tick(now)
            elif kind == "crash":
                self._on_crash(data, now)
            elif kind == "restart":
                self._on_restart(data, now)
            elif kind == "burst":
                self._on_burst(data, now)
            elif kind == "rereplicate":
                self._on_rereplicate(data[0], data[1], now)
        result = SimResult(
            scheduler=self.sched.name,
            jobs=self.sched.jobs,
            makespan=max((j.finish_time or now) for j in self.sched.jobs.values())
            if self.sched.jobs else 0.0,
            reconfig_stats=dict(self.reconfig.stats) if self.reconfig else {},
            speculative_launches=self.n_speculative,
            events_processed=self.events_processed,
            fault_stats=dict(self.fault_stats) if faults is not None else {},
            fault_log=list(self.fault_log),
            trace=self.trace,
            serve_stats=(self.serving.stats()
                         if self.serving is not None else {}),
            serve_log=(list(self.serving.log)
                       if self.serving is not None else []),
        )
        return result

    # -- handlers -------------------------------------------------------------
    def _launch(self, launch: Launch, now: float, speculative: bool = False) -> None:
        job = self.sched.jobs[launch.task.job_id]
        dur = self.task_duration(job, launch.task, launch.local,
                                 launch.node, now)
        if (self.faults is not None and not speculative
                and launch.task in self.lost_pending):
            self.lost_pending.discard(launch.task)
            self.fault_stats["tasks_reexecuted"] += 1
        rt = RunningTask(launch.task, launch.node, now, now + dur,
                         launch.local, speculative)
        if launch.task.kind == TaskKind.MAP:
            self.map_running[launch.node].append(rt)
            if not speculative:
                jid = launch.task.job_id
                q = self._spec_q.get(jid)
                if q is None:
                    q = self._spec_q[jid] = _SpecQueue()
                q.append(launch.task.index, now)
                if job.map_durations:
                    mean = job.map_duration_sum / len(job.map_durations)
                    self._spec_push_wake(
                        jid, now + self.spec_threshold * mean)
        else:
            self.red_running[launch.node].append(rt)
        self.live[(launch.task, speculative)] = rt
        self._push(rt.finish, "finish", rt)
        tr = self.trace
        if tr is not None and tr.launches:
            tr.emit(now, "launch", {
                "task": launch.task, "job": launch.task.job_id,
                "tkind": launch.task.kind.value, "node": launch.node,
                "machine": self.spec.machine_of(launch.node),
                "local": launch.local, "spec": speculative,
                "via_reconfig": launch.via_reconfig})

    def _on_finish(self, rt: RunningTask, now: float) -> None:
        if rt.dead:
            # a crash killed this attempt: its finish is void.  The task
            # may already be re-running under the same live key — without
            # this check the stale finish would complete the task early
            # and strand the re-execution's RunningTask in its slot.
            # (A *cancelled* duplicate is the next check: its live key is
            # gone.  The key-membership semantics below stay byte-exact
            # with the frozen engine for every non-crash path.)
            return
        if (rt.task, rt.speculative) not in self.live:
            # cancelled duplicate.  The frozen engine leaves a reconfig
            # double-launch's losing attempt in its running list forever
            # (a one-slot leak, bit-exactly mirrored while faults are
            # off); under churn a leaked slot compounds with crash
            # capacity loss, so the fault-aware engine frees it here.
            if self.faults is not None:
                lst = (self.map_running if rt.task.kind == TaskKind.MAP
                       else self.red_running)[rt.node]
                if rt in lst:
                    lst.remove(rt)
            if self.trace is not None and self.trace.launches \
                    and not rt.cancelled:
                # the reconfig double-launch loser: twin-cancelled attempts
                # already emitted their kill at cancellation time
                self.trace.emit(now, "kill", {
                    "task": rt.task, "job": rt.task.job_id,
                    "tkind": rt.task.kind.value, "node": rt.node,
                    "spec": rt.speculative, "start": rt.start,
                    "cause": "stale_duplicate"})
            return
        del self.live[(rt.task, rt.speculative)]
        lst = (self.map_running if rt.task.kind == TaskKind.MAP
               else self.red_running)[rt.node]
        if rt in lst:
            lst.remove(rt)
        if rt.task in self.finished_tasks:
            return
        self.finished_tasks.add(rt.task)
        # cancel the twin if speculation duplicated this task
        twin_key = (rt.task, not rt.speculative)
        if twin_key in self.live:
            twin = self.live.pop(twin_key)
            twin.cancelled = True
            tl = (self.map_running if rt.task.kind == TaskKind.MAP
                  else self.red_running)[twin.node]
            if twin in tl:
                tl.remove(twin)
            if self.trace is not None and self.trace.launches:
                self.trace.emit(now, "kill", {
                    "task": twin.task, "job": twin.task.job_id,
                    "tkind": twin.task.kind.value, "node": twin.node,
                    "spec": twin.speculative, "start": twin.start,
                    "cause": "twin_cancel"})
        self.sched.task_finished(rt.task, rt.node, now, now - rt.start)
        tr = self.trace
        if tr is not None and tr.launches:
            tr.emit(now, "finish", {
                "task": rt.task, "job": rt.task.job_id,
                "tkind": rt.task.kind.value, "node": rt.node,
                "machine": self.spec.machine_of(rt.node),
                "start": rt.start, "duration": now - rt.start,
                "local": rt.local, "spec": rt.speculative})
            fin_job = self.sched.jobs[rt.task.job_id]
            if fin_job.all_done and fin_job.finish_time == now:
                tr.emit(now, "job_finish", {
                    "job": rt.task.job_id,
                    "duration": now - fin_job.spec.submit_time,
                    "deadline_met": now <= fin_job.absolute_deadline + 1e-9})
        if rt.task.kind == TaskKind.MAP:
            # the job's mean map duration changed: its head straggler may
            # now cross the speculation threshold earlier (or at all)
            jid = rt.task.job_id
            job = self.sched.jobs[jid]
            q = self._spec_q.get(jid)
            if q is not None and job.running_map and job.map_durations:
                mean = job.map_duration_sum / len(job.map_durations)
                head = self._spec_head_start(q, job)
                if head is not None:
                    self._spec_push_wake(
                        jid, max(now, head + self.spec_threshold * mean))
        # Paper §4.1: "the target system will soon have a free core, as a
        # task finishes in one of the VMs, and a local task is not found for
        # the VM" — on every map finish, a VM with no local pending work
        # offers its freed core if a neighbour VM has a parked task waiting.
        if self.reconfig is not None and rt.task.kind == TaskKind.MAP:
            vm = rt.node
            if self.reconfig.adaptive.enabled:
                # release-interval hook: every map finish frees a core on vm
                # (whether or not it is offered below) — feed the machine's
                # core-free EWMA so park_decision can price the wait
                self.reconfig.observe_core_free(vm, now)
            if (self.free_map(vm) > 0
                    and (self.reconfig.vcpus[vm] > self.spec.base_map_slots
                         or (isinstance(self.sched, CompletionTimeScheduler)
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
        started = self.reconfig.match(now, donor_ok=lambda vm: self.free_map(vm) > 0)
        for plug in started:
            self._push(plug.ready_at, "plug", None)

    def _heartbeat(self, node: int, now: float) -> None:
        # expire stale parked tasks back to the scheduler for remote launch
        if self.reconfig is not None:
            for parked in self.reconfig.expire_stale(now):
                if isinstance(self.sched, CompletionTimeScheduler):
                    self.sched.parked_task_expired(parked.task, now)
            self._match_reconfig(now)
        fm, fr = max(0, self.free_map(node)), self.free_reduce(node)
        if fm > 0 or fr > 0:
            for launch in self.sched.select(node, fm, fr, now):
                self._launch(launch, now)
            self._match_reconfig(now)   # pair fresh AQ entries immediately
        if self.speculative:
            self._maybe_speculate(node, now)
        tr = self.trace
        if (tr is not None and tr.pressure_every > 0.0
                and now >= self._next_pressure):
            self._next_pressure = now + tr.pressure_every
            self._emit_pressure(now)

    def _emit_pressure(self, now: float) -> None:
        """Periodic cluster pressure snapshot (TraceConfig.pressure_every):
        the same incremental signals park_decision and the overload latch
        read, so a timeline of these explains every admission flip."""
        sched = self.sched
        data: Dict[str, object] = {
            "active_jobs": len(sched.active),
            "pending_maps": sched.total_pending_maps,
            "ready_reduces": sched.ready_pending_reduces,
            "map_open_jobs": sched.map_open_jobs,
            "overload": bool(getattr(sched, "overload_mode", False)),
            "down_nodes": len(self.down_nodes),
        }
        rc = self.reconfig
        if rc is not None:
            data["parked"] = sum(len(q) for q in rc.aq)
            data["rq_depth"] = list(rc.rq_depth)
            data["fail_streak"] = list(rc.fail_streak)
            data["offer_ewma"] = list(rc.offer_ewma)
            data["free_ewma"] = list(rc.free_ewma)
            data["park_outcome_ewma"] = rc.park_outcome_ewma
        self.trace.emit(now, "pressure", data)

    # -- serving layer (ServeConfig; handler unreachable when off) ------------
    def _on_serve_tick(self, now: float) -> None:
        """One global serve tick: advance every replica's arrival stream,
        drain its queue, fold latency/SLO counters, run harvest.  The
        chain follows the heartbeat liveness rule so a drained run
        terminates; a revived tick covers the idle gap exactly (arrivals
        carry their true times)."""
        if not (self.sched.has_active_jobs() or self._pending_submits > 0):
            self._serve_idle = True
            return
        self.serving.tick(now)
        self._push(now + self.spec.heartbeat_interval, "serve", None)

    # -- fault injection (FaultConfig; handlers unreachable when off) ---------
    def _fault_live(self) -> bool:
        """Fault chains follow the heartbeat liveness rule: they tick only
        while there is (or will be) work, so a drained run terminates."""
        return self.sched.has_active_jobs() or self._pending_submits > 0

    def _next_uptime(self, machine: int) -> float:
        f = self.faults
        mtbf = f.crash_mtbf * f.machine_class(machine).mtbf_scale
        return self._crash_rng[machine].expovariate(1.0 / mtbf)

    def _revive_fault_chains(self, now: float) -> None:
        f = self.faults
        for m in sorted(self._idle_crash_chains):
            self._push(now + self._next_uptime(m), "crash", m)
        self._idle_crash_chains.clear()
        for m in sorted(self._idle_burst_chains):
            self._push(now + self._burst_rng[m].expovariate(
                1.0 / f.burst_rate), "burst", m)
        self._idle_burst_chains.clear()

    def _machine_nodes(self, machine: int) -> List[int]:
        vpm = self.spec.vms_per_machine
        return list(range(machine * vpm, (machine + 1) * vpm))

    def _on_crash(self, machine: int, now: float) -> None:
        f = self.faults
        if not self._fault_live():
            self._idle_crash_chains.add(machine)
            return
        self.machine_up[machine] = False
        self.fault_stats["crashes"] += 1
        self.fault_log.append(FaultEvent(now, "crash", machine))
        nodes = self._machine_nodes(machine)
        if self.trace is not None and self.trace.faults:
            self.trace.emit(now, "crash", {
                "machine": machine, "nodes": nodes,
                "running": sum(len(self.map_running[v])
                               + len(self.red_running[v]) for v in nodes)})
        self.down_nodes.update(nodes)
        for v in nodes:
            # bump the chain epoch: any pending heartbeat of this node is
            # now stale and dies on pop (restart arms the next chain)
            self._node_epoch[v] += 1
        for v in nodes:
            for rt in self.map_running[v] + self.red_running[v]:
                self._kill_running(rt, now)
            self.map_running[v].clear()
            self.red_running[v].clear()
        if self.reconfig is not None:
            # cancelled AQ entries and aborted in-flight plugs: their tasks
            # are still pending and re-enter normal scheduling
            for task in self.reconfig.machine_down(machine, now):
                self.sched.parked_task_crashed(task, now)
        self.sched.node_down(nodes, now)
        if self.serving is not None:
            # chaos interaction: the machine's service replicas go down —
            # in-window arrivals shed, borrowed cores return immediately
            self.serving.machine_down(machine, now)
        self._push(now + self._crash_rng[machine].expovariate(
            1.0 / f.crash_mttr), "restart", machine)
        self._push(now + f.rereplicate_after, "rereplicate",
                   (machine, self._machine_epoch[machine]))

    def _kill_running(self, rt: RunningTask, now: float) -> None:
        """A crash killed this running task.  A speculative copy simply
        dies (the original keeps running and may be re-speculated); losing
        the original also kills any surviving speculative twin — the
        attempt's lineage is re-executed from scratch — and hands the task
        back to the scheduler (``task_lost`` restores the pending state)."""
        key = (rt.task, rt.speculative)
        if key not in self.live:
            return                        # already resolved this instant
        del self.live[key]
        rt.dead = True                    # voids the pending finish event
        self.fault_stats["tasks_lost"] += 1
        tr = self.trace
        if tr is not None and tr.launches:
            tr.emit(now, "kill", {
                "task": rt.task, "job": rt.task.job_id,
                "tkind": rt.task.kind.value, "node": rt.node,
                "spec": rt.speculative, "start": rt.start, "cause": "crash"})
        if rt.speculative:
            self.spec_launched.discard(rt.task)
            return
        twin = self.live.pop((rt.task, True), None)
        if twin is not None:
            twin.dead = True
            tl = (self.map_running if rt.task.kind == TaskKind.MAP
                  else self.red_running)[twin.node]
            if twin in tl:
                tl.remove(twin)
            self.spec_launched.discard(rt.task)
            if tr is not None and tr.launches:
                tr.emit(now, "kill", {
                    "task": twin.task, "job": twin.task.job_id,
                    "tkind": twin.task.kind.value, "node": twin.node,
                    "spec": True, "start": twin.start, "cause": "crash"})
        self.lost_pending.add(rt.task)
        self.sched.task_lost(rt.task, rt.node, now)

    def _on_restart(self, machine: int, now: float) -> None:
        f = self.faults
        self.machine_up[machine] = True
        self._machine_epoch[machine] += 1
        self.fault_stats["restarts"] += 1
        self.fault_log.append(FaultEvent(now, "restart", machine))
        if self.trace is not None and self.trace.faults:
            self.trace.emit(now, "restart", {"machine": machine})
        nodes = self._machine_nodes(machine)
        self.down_nodes.difference_update(nodes)
        if self.reconfig is not None:
            self.reconfig.machine_restarted(machine, now)
        if self.serving is not None:
            self.serving.machine_restarted(machine, now)
        self.sched.node_up(nodes, now)
        for v in nodes:
            # fresh heartbeat chain (the crash staled the old one); if the
            # cluster is idle the chain dies into _hb_dead as usual
            self._hb_dead.discard(v)
            self._push(now + self.spec.heartbeat_interval
                       * (1 + v / self.spec.num_nodes),
                       "heartbeat", (v, self._node_epoch[v]))
        if self._fault_live():
            self._push(now + self._next_uptime(machine), "crash", machine)
        else:
            self._idle_crash_chains.add(machine)

    def _on_burst(self, machine: int, now: float) -> None:
        f = self.faults
        if not self._fault_live():
            self._idle_burst_chains.add(machine)
            return
        self._burst_until[machine] = now + f.burst_duration
        self.fault_stats["bursts"] += 1
        self.fault_log.append(FaultEvent(now, "burst", machine))
        if self.trace is not None and self.trace.faults:
            self.trace.emit(now, "burst", {
                "machine": machine, "until": self._burst_until[machine],
                "slowdown": f.burst_slowdown})
        self._push(now + self._burst_rng[machine].expovariate(
            1.0 / f.burst_rate), "burst", machine)

    def _on_rereplicate(self, machine: int, epoch: int, now: float) -> None:
        """Grace window elapsed with the machine still down: every pending
        map block whose replicas are *all* on crashed nodes gets one new
        replica (restored from the durable store) on a surviving node —
        deterministically the nearest live node id after the block's
        primary — restoring schedulable locality.  Blocks with a live
        replica are left alone (the scheduler already reaches them)."""
        if self.machine_up[machine] or self._machine_epoch[machine] != epoch:
            return                        # restarted before the window
        n = self.spec.num_nodes
        down = self.down_nodes
        count = 0
        for job in list(self.sched.active.values()):
            placement = job.spec.block_placement
            for idx in sorted(job.pending_map):
                pl = placement[idx]
                if not pl or any(v not in down for v in pl):
                    continue
                new = next((c for k in range(1, n)
                            if (c := (pl[0] + k) % n) not in down), None)
                if new is None:
                    continue              # whole cluster down
                placement[idx] = pl + (new,)
                heapq.heappush(job._local_heaps.setdefault(new, []), idx)
                self.sched.local_pending_count[new] += 1
                count += 1
        if count:
            self.fault_stats["blocks_rereplicated"] += count
            self.fault_log.append(FaultEvent(now, "rereplicate", machine))
            if self.trace is not None and self.trace.faults:
                self.trace.emit(now, "rereplicate",
                                {"machine": machine, "blocks": count})

    # -- incremental speculative execution ------------------------------------
    def _spec_push_wake(self, jid: str, wake: float) -> None:
        # nudge the wake a hair early: `start + θ·mean` can round *above* the
        # exact eligibility boundary `now - start > θ·mean`; waking early is
        # harmless (candidates are revalidated with the exact expression),
        # waking late would miss the seed's pick
        heapq.heappush(self._spec_wake,
                       (wake - 1e-6, self._job_seq.get(jid, 0), jid))

    def _spec_head_start(self, q: _SpecQueue, job: JobRuntime) -> Optional[float]:
        """Drop permanently-dead head entries; return the head's *recorded*
        (append-time) start.  Recorded starts are non-decreasing along the
        queue and never exceed the live start, so a wake computed from the
        head's recorded start lower-bounds every entry's eligibility time —
        even when a re-launch refreshed some entry's live start.  An early
        wake only costs one extra revalidation."""
        entries, running = q.entries, job.running_map
        while q.head < len(entries):
            idx, start = entries[q.head]
            if idx not in running or TaskId(
                    job.spec.job_id, TaskKind.MAP, idx) in self.spec_launched:
                q.present.discard(idx)
                q.head += 1
                continue
            q.compact()
            return start
        q.compact()
        return None

    def _spec_candidate(self, job: JobRuntime, q: _SpecQueue,
                        now: float) -> Optional[TaskId]:
        """First speculation-eligible running map in insertion order.

        Append-time starts are non-decreasing, so once an entry whose live
        start equals its recorded start is ineligible, every later entry is
        too, and the walk stops.  An entry whose start was *refreshed* by a
        re-launch (live start > recorded) does not bound its successors, so
        the walk continues past it — matching the seed's full dict scan.
        """
        if not job.map_durations:
            return None
        threshold = (self.spec_threshold
                     * (job.map_duration_sum / len(job.map_durations)))
        entries, running = q.entries, job.running_map
        jid = job.spec.job_id
        i = q.head
        while i < len(entries):
            idx, rec_start = entries[i]
            task = TaskId(jid, TaskKind.MAP, idx)
            if idx not in running or task in self.spec_launched:
                if i == q.head:           # permanently dead: drop from head
                    q.present.discard(idx)
                    q.head += 1
                i += 1
                continue
            rt = self.live.get((task, False))
            if rt is None:
                i += 1                    # running but not live: seed skips it
                continue
            if now - rt.start > threshold:
                return task
            if rt.start <= rec_start:
                return None               # unrefreshed + ineligible: walk ends
            i += 1                        # refreshed entry: keep scanning
        return None

    def _maybe_speculate(self, node: int, now: float) -> None:
        """Hadoop-style speculative re-execution of straggling maps.

        Identical decisions to the seed's per-heartbeat full rescan, found
        via the lazy wake heap: first submitted job with an eligible
        straggler, earliest-launched eligible map of that job."""
        if self.free_map(node) <= 0:
            return
        wake, ready, ready_set = (self._spec_wake, self._spec_ready,
                                  self._spec_ready_set)
        while wake and wake[0][0] <= now:
            _, seq, jid = heapq.heappop(wake)
            if jid not in ready_set:
                ready_set.add(jid)
                heapq.heappush(ready, (seq, jid))
        while ready:
            seq, jid = ready[0]
            job = self.sched.jobs[jid]
            q = self._spec_q.get(jid)
            task = (None if (job.finished or q is None)
                    else self._spec_candidate(job, q, now))
            if task is not None:
                self.spec_launched.add(task)
                self.n_speculative += 1
                idx = task.index
                local = node in job.spec.block_placement[idx]
                self._launch(Launch(task, node, local=local), now,
                             speculative=True)
                return
            # not eligible now: drop from the ready set and, if the job still
            # has a live head, schedule its next possible eligibility time
            heapq.heappop(ready)
            ready_set.discard(jid)
            if q is not None and not job.finished and job.map_durations:
                head = self._spec_head_start(q, job)
                if head is not None:
                    mean = job.map_duration_sum / len(job.map_durations)
                    self._spec_push_wake(
                        jid, max(now, head + self.spec_threshold * mean))
