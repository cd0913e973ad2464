"""Completion-time based scheduler — paper §4.2, Algorithm 2 (+ Algorithm 1
for map-task assignment through resource reconfiguration).

This is the port's own copy of the JAX package's ``core/scheduler.py`` (pure
Python; a test holds the event engine's records byte-equal to the
original's, over every registered policy).

Policy, exactly as the paper states it:

* jobs with no completed or running tasks take precedence (oldest first) so
  the online estimator can bootstrap (initial tasks give the Eq.-1 sample);
* remaining jobs are sorted by EDF (ascending deadline);
* a job only receives map slots while ``scheduled_maps < n_m`` and reduce
  slots while ``scheduled_reduces < n_r`` (Eq. 10 demand, recomputed on every
  task completion with remaining work and remaining time);
* reduces launch only after the job's map phase finishes (Algorithm 2 l.10);
* map assignment prefers a data-local task on the heartbeating node; a
  non-local candidate is parked for VM reconfiguration on a node that holds
  its data (Algorithm 1): AQ entry on the data node's machine, RQ entry on
  the heartbeating node's machine.

Implementation note — incremental indices.  Per-heartbeat work is
O(active work at this node), not O(jobs × tasks): the per-job pending sets
and the per-node ``node -> pending local map ids`` inverted index live on
``JobRuntime`` (see ``core/types.py``); this module adds the cross-job
aggregates (per-node local-pending counters, maintained EDF order, global
pending-work counters, per-job parked counts).  Decision order is identical
to the seed implementation — pinned in the JAX package by
``tests/test_parity.py`` against its frozen seed engine.
"""
from __future__ import annotations

import bisect
import heapq
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.core.estimator import OnlineEstimator
from repro_torch.core.reconfigurator import Reconfigurator
from repro_torch.core.types import (ClusterSpec, JobRuntime, JobSpec, TaskId,
                                    TaskKind)


@dataclass
class Launch:
    """Scheduler decision: run task on node (immediately)."""
    task: TaskId
    node: int
    local: bool
    via_reconfig: bool = False


class SchedulerBase:
    """Common bookkeeping shared by all scheduler policies.

    Maintains, incrementally across task lifecycle transitions:

    * ``active`` — unfinished jobs in submission order (dict removal keeps
      ``active_jobs()`` O(active), not O(all jobs ever));
    * ``local_pending_count[node]`` — how many (job, map task) pending pairs
      have a replica on ``node``, so ``has_local_pending`` is O(1);
    * ``total_pending_maps`` / ``ready_pending_reduces`` — global counters
      that let ``select`` return immediately when the offered slots cannot
      possibly be used (idle-heartbeat churn fix).
    """

    name = "base"
    uses_reconfig = False
    # set by PolicySpec.build: the spec this instance was constructed from
    policy = None
    # harvest policy component (repro_torch.core.policies axis "harvest"): when
    # True and ServeConfig is active, the serving layer borrows idle
    # service cores for the batch side (repro_torch.simcluster.serving).  Set by
    # harvest-policy builders; read-only for the engine, so non-harvest
    # policies are untouched.
    harvest = False
    # decision-trace bus (repro_torch.core.tracing.TraceBus); attached by the
    # simulator when ClusterSpec.tracing is enabled, None otherwise.  Every
    # emission site is behind a single `is None` guard and draws from no
    # RNG, so tracing-off is bit-exact and tracing-on changes no decision.
    trace = None

    @classmethod
    def from_policy(cls, policy, spec: ClusterSpec):
        """Construct a scheduler from a policy value (a ``PolicySpec``, a
        registered name, or policy JSON/dict) — see ``repro_torch.core.policies``."""
        from repro_torch.core.policies import build_policy
        return build_policy(policy, spec)

    def __init__(self, spec: ClusterSpec):
        self.spec = spec
        self.jobs: Dict[str, JobRuntime] = {}
        self.order: List[str] = []          # submission order
        self.active: Dict[str, JobRuntime] = {}   # insertion == submission
        # active jobs that have no completed or running task yet (paper
        # Algorithm 2 bootstrap precedence), in submission order
        self.bootstrap: Dict[str, JobRuntime] = {}
        self.local_pending_count: List[int] = [0] * spec.num_nodes
        self.total_pending_maps = 0
        self.ready_pending_reduces = 0
        # active jobs whose map phase is still open — with
        # total_pending_maps this gives the backlog's mean job width
        # (the adaptive park-admission signal), maintained at the same
        # transitions as the map_done flag
        self.map_open_jobs = 0
        # fault integration (FaultConfig): nodes currently crashed.  Always
        # empty when faults are off, so every guard on it is parity-inert.
        self.down_nodes: Set[int] = set()

    # -- lifecycle ----------------------------------------------------------
    def job_added(self, job: JobSpec, now: float) -> None:
        rt = JobRuntime(spec=job, seq=len(self.order))
        self.jobs[job.job_id] = rt
        self.order.append(job.job_id)
        self.active[job.job_id] = rt
        self.bootstrap[job.job_id] = rt
        self.total_pending_maps += job.u_m
        self.map_open_jobs += 1
        counts = self.local_pending_count
        for placement in job.block_placement[:job.u_m]:
            for node in set(placement):
                counts[node] += 1
        self.on_job_added(rt, now)

    def on_job_added(self, job: JobRuntime, now: float) -> None:
        pass

    def task_started(self, task: TaskId, node: int, now: float) -> None:
        job = self.jobs[task.job_id]
        if task.kind == TaskKind.MAP:
            self._start_map(job, task.index, node)
        else:
            self._start_reduce(job, task.index, node)

    def task_finished(self, task: TaskId, node: int, now: float,
                      duration: float) -> None:
        job = self.jobs[task.job_id]
        if task.kind == TaskKind.MAP:
            job.running_map.pop(task.index, None)
            self._drop_pending_map(job, task.index)   # defensive: no-op if started
            job.completed_map.add(task.index)
            job.map_durations.append(duration)
            job.map_duration_sum += duration
            if not job.map_done and job.map_finished:
                job.map_done = True
                self.map_open_jobs -= 1
                # reduces become schedulable the moment the map phase ends
                self.ready_pending_reduces += len(job.pending_reduce)
        else:
            job.running_reduce.pop(task.index, None)
            if task.index in job.pending_reduce:      # defensive
                job.pending_reduce.discard(task.index)
                if job.map_done:
                    self.ready_pending_reduces -= 1
            job.completed_reduce.add(task.index)
            job.reduce_durations.append(duration)
            job.reduce_duration_sum += duration
        if not job.all_done and job.finished:
            job.all_done = True
            if job.finish_time is None:
                job.finish_time = now
            self.active.pop(job.spec.job_id, None)
            self._job_deactivated(job)
        self.on_task_finished(job, task, now)

    def _job_deactivated(self, job: JobRuntime) -> None:
        pass

    def on_task_finished(self, job: JobRuntime, task: TaskId, now: float) -> None:
        pass

    # -- fault integration (FaultConfig; never called when faults are off) --
    def node_down(self, nodes: List[int], now: float) -> None:
        """Simulator hook: these nodes just crashed.  Down nodes stop
        heartbeating (so ``select`` is never offered their slots) and are
        excluded as park targets until they restart."""
        self.down_nodes.update(nodes)
        self.on_nodes_down(nodes, now)

    def node_up(self, nodes: List[int], now: float) -> None:
        self.down_nodes.difference_update(nodes)
        self.on_nodes_up(nodes, now)

    def on_nodes_down(self, nodes: List[int], now: float) -> None:
        pass

    def on_nodes_up(self, nodes: List[int], now: float) -> None:
        pass

    def task_lost(self, task: TaskId, node: int, now: float) -> None:
        """A node crash killed this *running* task: make it schedulable
        again.  The exact inverse of the start transition — restores the
        pending sets, the lazy heaps (popped entries never resurface on
        their own, so the index is pushed back), ``total_pending_maps``,
        the per-node local counters, and the bootstrap precedence set when
        a job loses every task it ever ran.  ``map_open_jobs`` needs no
        recount: a running map implies the phase was still open, and a
        lost reduce cannot reopen a finished map phase."""
        job = self.jobs[task.job_id]
        if task.kind == TaskKind.MAP:
            if job.running_map.pop(task.index, None) is None:
                return                       # already resolved (twin finished)
            if task.index in job.completed_map or task.index in job.pending_map:
                return
            self._repend_map(job, task.index)
        else:
            if job.running_reduce.pop(task.index, None) is None:
                return
            if (task.index in job.completed_reduce
                    or task.index in job.pending_reduce):
                return
            job.pending_reduce.add(task.index)
            heapq.heappush(job._pending_reduce_heap, task.index)
            if job.map_done:
                self.ready_pending_reduces += 1
        if job.has_progress and not job.started:
            # the job lost every task it ever ran: it needs a bootstrap
            # probe again (Algorithm 2's precedence set) so the estimator
            # can re-seed — it re-enters at the back of the set, which only
            # reorders against other re-bootstrapped jobs
            job.has_progress = False
            self.bootstrap[job.spec.job_id] = job
        self.on_task_lost(job, task, now)

    def _repend_map(self, job: JobRuntime, idx: int) -> None:
        """Inverse of ``_drop_pending_map`` + the heap pops it implies."""
        job.pending_map.add(idx)
        heapq.heappush(job._pending_map_heap, idx)
        self.total_pending_maps += 1
        placement = job.spec.block_placement
        if idx < len(placement):
            counts = self.local_pending_count
            for node in set(placement[idx]):
                counts[node] += 1
                heapq.heappush(job._local_heaps.setdefault(node, []), idx)

    def on_task_lost(self, job: JobRuntime, task: TaskId, now: float) -> None:
        pass

    def parked_task_crashed(self, task: TaskId, now: float) -> None:
        """The machine holding this task's AQ entry (or in-flight plug)
        crashed; the task is still pending and simply re-enters normal
        scheduling."""
        pass

    # -- indexed transitions -------------------------------------------------
    def _drop_pending_map(self, job: JobRuntime, idx: int) -> bool:
        """Remove idx from the job's pending set + per-node counters."""
        if idx not in job.pending_map:
            return False
        job.pending_map.discard(idx)
        self.total_pending_maps -= 1
        placement = job.spec.block_placement
        if idx < len(placement):
            counts = self.local_pending_count
            for node in set(placement[idx]):
                counts[node] -= 1
        return True

    def _start_map(self, job: JobRuntime, idx: int, node: int) -> None:
        job.running_map[idx] = node
        self._drop_pending_map(job, idx)
        if not job.has_progress:
            job.has_progress = True
            self.bootstrap.pop(job.spec.job_id, None)

    def _start_reduce(self, job: JobRuntime, idx: int, node: int) -> None:
        job.running_reduce[idx] = node
        if not job.has_progress:
            job.has_progress = True
            self.bootstrap.pop(job.spec.job_id, None)
        if idx in job.pending_reduce:
            job.pending_reduce.discard(idx)
            if job.map_done:
                self.ready_pending_reduces -= 1

    # -- helpers --------------------------------------------------------------
    def _unstarted_map_tasks(self, job: JobRuntime) -> List[int]:
        """Full unstarted list — O(pending); kept for tests/introspection.
        Hot paths use the first_pending_* index queries instead."""
        return sorted(job.pending_map)

    def _unstarted_reduce_tasks(self, job: JobRuntime) -> List[int]:
        return sorted(job.pending_reduce)

    def _local_map_candidates(self, job: JobRuntime, node: int) -> List[int]:
        return sorted(i for i in job.pending_map
                      if node in job.spec.block_placement[i])

    def active_jobs(self) -> List[JobRuntime]:
        return list(self.active.values())

    def has_active_jobs(self) -> bool:
        return bool(self.active)

    def has_local_pending(self, vm: int) -> bool:
        """Does any active job still have an unstarted map task whose data
        lives on ``vm``?  O(1) via the per-node pending counters."""
        return self.local_pending_count[vm] > 0

    # subclasses implement:
    def select(self, node: int, free_map: int, free_reduce: int,
               now: float) -> List[Launch]:
        raise NotImplementedError


class CompletionTimeScheduler(SchedulerBase):
    """The paper's proposed scheduler (Algorithm 2 + Algorithm 1)."""

    name = "proposed"
    uses_reconfig = True

    #: overload-policy vocabulary (the policy registry's ``overload`` axis):
    #: ``none`` never enters the latch, ``latch`` is the sticky-until-drain
    #: detector, ``reduce_aware`` keys the latch on map-side pressure only
    OVERLOAD_POLICIES = ("none", "latch", "reduce_aware")

    def __init__(self, spec: ClusterSpec, reconfig: Optional[Reconfigurator] = None,
                 estimator: Optional[OnlineEstimator] = None, *,
                 park_depth: int = 2, parking: bool = True,
                 overload: str = "latch"):
        super().__init__(spec)
        if overload not in self.OVERLOAD_POLICIES:
            raise ValueError(f"unknown overload policy {overload!r}; "
                             f"one of {self.OVERLOAD_POLICIES}")
        self.reconfig = reconfig or Reconfigurator(spec)
        self.estimator = estimator or OnlineEstimator()
        self.adaptive = self.reconfig.adaptive
        self.overload_policy = overload
        # park-admission switch: False = the edf_nopark ablation — every
        # non-local candidate launches remotely at once, and the simulator
        # skips the reconfigurator integration entirely (static capacity)
        self.parking = parking
        if not parking:
            self.uses_reconfig = False      # instance attr shadows the class
        self.parked: Set[TaskId] = set()
        self._parked_maps_per_job: Dict[str, int] = {}
        # tasks whose reconfiguration wait expired once run remotely instead
        # of re-parking (bounds per-task wait at max_wait)
        self.no_park: Set[TaskId] = set()
        # max parked tasks per target machine's AQ
        self.park_depth = park_depth
        self.max_slots = spec.num_nodes * spec.base_map_slots
        # adaptive overload detection: active jobs whose absolute deadline
        # has passed (completion-time goal lost), materialized lazily from a
        # deadline min-heap as the clock advances — O(1) amortized per job
        self.overdue: Set[str] = set()
        self._overdue_heap: List[Tuple[float, int, str]] = []
        # hysteresis latch: overload mode persists through the drain until
        # the map backlog genuinely clears (a surge's damage is done in its
        # tail, which sits below any instantaneous entry threshold)
        self.overload_mode = False
        # active jobs ordered by (absolute deadline, admission seq): the
        # admission tiebreak reproduces the seed's stable sort exactly;
        # _edf_jobs mirrors _edf with the JobRuntime objects so select
        # iterates without rebuilding a list
        self._edf: List[Tuple[float, int, str]] = []
        self._edf_jobs: List[JobRuntime] = []
        # fault integration: crashed machines, maintained by on_nodes_down/
        # on_nodes_up so the overload latch prices pressure against the
        # *effective* capacity (0 whenever faults are off)
        self._machines_down = 0
        # re-pend debt: map tasks a crash threw back into the pending sets
        # and that have not been rescheduled yet.  The latch already priced
        # this work in the first time around — counting it again makes
        # churn read as a fresh overload surge while the crash is also
        # *lowering* the trip bars (slots/machines shrink with the fleet).
        # Only populated when adaptive.enabled and crash_discount are on,
        # so every other configuration keeps the set empty for free.
        self._repend_debt: Set[TaskId] = set()
        # relief latch: once _churn_relief sees a live churn signal it
        # stays true for the rest of the run — the locality the crashes
        # destroyed never fully recovers, so the gates stay stood down.
        # A fleet *configured* crash-prone arms it from t=0: the prologue
        # before the first crash already runs on borrowed locality, and
        # parks denied there are wins surrendered once the churn starts.
        self._relief_sticky = (
            self.adaptive.enabled and self.adaptive.crash_discount
            and spec.faults.enabled and spec.faults.crash_mtbf > 0.0)

    # -- Algorithm 2 line 2 + lines 17-20 ----------------------------------
    def on_job_added(self, job: JobRuntime, now: float) -> None:
        entry = (job.absolute_deadline, job.seq, job.spec.job_id)
        i = bisect.bisect_left(self._edf, entry)
        self._edf.insert(i, entry)
        self._edf_jobs.insert(i, job)
        if self.adaptive.enabled:
            heapq.heappush(self._overdue_heap, entry)
            if self.overload_mode and len(self.active) == 1:
                # this job found a fully-drained cluster (select never runs
                # while idle, so the latch cannot observe the drain itself):
                # the pressured epoch ended — release the overload latch
                self.overload_mode = False
                if self.trace is not None and self.trace.overload:
                    self.trace.emit(now, "latch_release",
                                    {"cause": "empty_cluster",
                                     "job": job.spec.job_id})
        self._recompute_demand(job, now)

    def _job_deactivated(self, job: JobRuntime) -> None:
        entry = (job.absolute_deadline, job.seq, job.spec.job_id)
        i = bisect.bisect_left(self._edf, entry)
        if i < len(self._edf) and self._edf[i] == entry:
            del self._edf[i]
            del self._edf_jobs[i]
        self.overdue.discard(job.spec.job_id)

    def _sync_overdue(self, now: float) -> None:
        """Move newly-overdue jobs off the deadline heap into ``overdue``
        (jobs that already finished are skipped — deactivation removed them
        from ``active`` and keeps them out of ``overdue``)."""
        heap = self._overdue_heap
        while heap and heap[0][0] < now:
            _, _, jid = heapq.heappop(heap)
            if jid in self.active:
                self.overdue.add(jid)

    def _wide_batch(self, pending: int) -> bool:
        """True when the queued map backlog averages at least
        ``AdaptiveConfig.surge_width`` pending maps per map-open job — a
        *healthy wide batch* (the paper's closed-mix regime at saturation,
        or churn re-pending lost work), not the many-small-jobs surge the
        overload latch exists for.  Measured at the latch trip on the
        regime atlas: saturated/50x2 and 100x2 sit at ~28 pending maps per
        open job, while the diurnal / bursty / churn surges the latch
        correctly catches sit at 3-5 (and never exceed ~14 while held).
        ``surge_width == 0`` disables the signal (pre-PR-8 behavior)."""
        a = self.adaptive
        return (a.surge_width > 0.0 and self.map_open_jobs > 0
                and pending >= a.surge_width * self.map_open_jobs)

    def _churn_relief(self, now: float) -> bool:
        """True once the cluster has churned: a machine is down, a
        crash-lost map is still waiting to reschedule (_repend_debt), or
        either has already happened this run (sticky: the locality damage
        from a crash outlives the repair — replicas come back on *other*
        machines — so there is no point the gates' calibration becomes
        trustworthy again).  Churn is the fixed policy's best regime — re-replication
        starves locality, so parked maps win big — and the adaptive
        signals' worst misread: re-pended lost work inflates ``pending``
        exactly while the crash lowers the trip bars (slots/machines track
        the surviving fleet), crashed donors read as core starvation, and
        the between-crash gap windows still run on locality the churn
        already destroyed.  While this holds, the latch stands down and
        park admission reverts to the fixed policy's gates.  Off with
        ``crash_discount`` (the pre-PR-8 churn behavior), and always False
        when faults are off."""
        if not self.adaptive.crash_discount:
            return False
        if self._machines_down > 0 or self._repend_debt:
            self._relief_sticky = True
            return True
        return self._relief_sticky

    def _overload_check(self, now: float) -> bool:
        """Latching overload detector over the incremental pressure state.

        Enter when the queued map backlog exceeds the entry fraction of
        cluster slots *and* active jobs outnumber the entry fraction of
        machines (many small jobs squeezed through shares far below their
        width — the Fair regime); leave only once the cluster has fully
        drained (hysteresis: the makespan damage of a surge happens in its
        drain tail, which sits below any instantaneous entry threshold).
        The ``overdue`` set (active jobs past their deadline) is kept in
        sync here as an observable signal.

        ``reduce_aware`` variant (the ``adaptive_ra`` policy): the latch is
        a *map-side* pressure response — parking and EDF slot allocation
        only shape the map phase — so the crowd bar counts **map-open**
        jobs rather than all active jobs (a fleet of long reduce tails is
        not an overload), and the latch releases as soon as the map
        backlog drains instead of waiting for the full cluster drain
        (shuffle-heavy mixes hold reduce backlogs for most of the run,
        which kept the plain latch stuck and parking suspended — the
        shuffle_heavy/20x2 −3.7% regression)."""
        self._sync_overdue(now)
        a = self.adaptive
        pending = self.total_pending_maps
        reduce_aware = self.overload_policy == "reduce_aware"
        # effective capacity: crashed nodes serve nothing, so the latch
        # prices pressure against the surviving fleet (identical values —
        # and floats — to the static bars while no node is down)
        slots = self.max_slots - len(self.down_nodes) * self.spec.base_map_slots
        machines = self.spec.num_machines - self._machines_down
        if self.overload_mode:
            # the plain latch stays until the cluster fully drains; select
            # never runs while idle, so the actual release happens when the
            # next job finds an empty cluster (see on_job_added).  The
            # reduce-aware latch releases on map-backlog drain.
            if not self.active or (reduce_aware and self.map_open_jobs == 0):
                self.overload_mode = False
                if self.trace is not None and self.trace.overload:
                    self.trace.emit(now, "latch_release", {
                        "cause": ("cluster_drained" if not self.active
                                  else "maps_drained"),
                        "pending_maps": pending,
                        "active_jobs": len(self.active)})
            elif (self.spec.faults.enabled and self.spec.faults.crash_mtbf > 0
                    and pending == 0 and self.ready_pending_reduces == 0):
                # under churn the "next job finds an empty cluster" release
                # may never fire (crashes keep re-pending work, stretching
                # the drain past the arrival horizon) — an empty backlog is
                # the epoch's true end, so the latch must not wedge there.
                # Gated on the crash process, not just `enabled`: a config
                # with no crash source cannot wedge, and stays bit-exact
                # with the faults-off latch semantics
                self.overload_mode = False
                if self.trace is not None and self.trace.overload:
                    self.trace.emit(now, "latch_release", {
                        "cause": "churn_drain",
                        "active_jobs": len(self.active)})
            elif self._churn_relief(now):
                # see _churn_relief: mid-churn the latch stands down
                self.overload_mode = False
                if self.trace is not None and self.trace.overload:
                    self.trace.emit(now, "latch_release", {
                        "cause": "churn_relief",
                        "machines_down": self._machines_down,
                        "repend_debt": len(self._repend_debt),
                        "pending_maps": pending,
                        "active_jobs": len(self.active)})
            elif (self._wide_batch(pending)
                    and self.reconfig.park_outcome_ewma >= a.park_win_floor):
                # win-aware release: the backlog evolved into a wide batch
                # (churn re-pending lost work is the canonical path) —
                # exact-Fair surrenders the parking win there, so the
                # latch opens back into EDF + parking.  Vetoed while the
                # park win-rate EWMA sits under the suspension floor:
                # releasing into parking that demonstrably loses would
                # just thrash (the width signal also gates the trip, so a
                # release cannot immediately re-trip).
                self.overload_mode = False
                if self.trace is not None and self.trace.overload:
                    self.trace.emit(now, "latch_release", {
                        "cause": "win_release",
                        "pending_maps": pending,
                        "map_open_jobs": self.map_open_jobs,
                        "surge_width": a.surge_width,
                        "ewma": self.reconfig.park_outcome_ewma})
        elif self.active:
            # both conditions strictly: a backlogged cluster with few wide
            # jobs (the paper's closed mix) is EDF's home regime — only the
            # many-small-jobs crowd flips the economics
            crowd = self.map_open_jobs if reduce_aware else len(self.active)
            if (pending >= a.overload_pending_factor * slots
                    and crowd >= a.overload_active_factor * machines
                    and not self._wide_batch(pending)
                    and not self._churn_relief(now)):
                self.overload_mode = True
                if self.trace is not None and self.trace.overload:
                    self.trace.emit(now, "latch_trip", {
                        "pending_maps": pending, "crowd": crowd,
                        "pending_bar": a.overload_pending_factor * slots,
                        "crowd_bar": a.overload_active_factor * machines,
                        "slots": slots, "machines": machines,
                        "active_jobs": len(self.active),
                        "map_open_jobs": self.map_open_jobs,
                        "surge_width": a.surge_width,
                        "repend_debt": len(self._repend_debt),
                        "overdue": len(self.overdue)})
        return self.overload_mode

    def on_task_finished(self, job: JobRuntime, task: TaskId, now: float) -> None:
        self._recompute_demand(job, now)

    def on_task_lost(self, job: JobRuntime, task: TaskId, now: float) -> None:
        # remaining work grew: the Eq.-10 demand must see it immediately
        self._recompute_demand(job, now)
        if (task.kind == TaskKind.MAP and self.adaptive.enabled
                and self.adaptive.crash_discount):
            self._repend_debt.add(task)

    def _drop_pending_map(self, job: JobRuntime, idx: int) -> bool:
        # a debted map leaving the pending set (rescheduled, or its
        # speculative twin finished first) settles its re-pend debt
        if self._repend_debt:
            self._repend_debt.discard(
                TaskId(job.spec.job_id, TaskKind.MAP, idx))
        return super()._drop_pending_map(job, idx)

    def parked_task_crashed(self, task: TaskId, now: float) -> None:
        self._unpark(task)

    def on_nodes_down(self, nodes: List[int], now: float) -> None:
        self._machines_down = len(
            {self.spec.machine_of(v) for v in self.down_nodes})

    def on_nodes_up(self, nodes: List[int], now: float) -> None:
        self._machines_down = len(
            {self.spec.machine_of(v) for v in self.down_nodes})

    def _recompute_demand(self, job: JobRuntime, now: float) -> None:
        job.demand = self.estimator.demand(
            job, now, max_map_slots=self.max_slots,
            max_reduce_slots=self.max_slots)

    # -- scheduled counts include parked tasks ------------------------------
    def _scheduled_maps(self, job: JobRuntime) -> int:
        return (len(job.running_map)
                + self._parked_maps_per_job.get(job.spec.job_id, 0))

    # -- Algorithm 2 main loop ----------------------------------------------
    def select(self, node: int, free_map: int, free_reduce: int,
               now: float) -> List[Launch]:
        # Nothing this node could possibly run or park -> O(1) heartbeat.
        # The parked check keeps the remote_fill donation pass reachable: a
        # parked task that also launched through the local path leaves an AQ
        # entry behind with no pending work, and the seed still donates idle
        # cores toward it.
        if ((free_map <= 0 or (self.total_pending_maps == 0
                               and not self.parked))
                and (free_reduce <= 0 or self.ready_pending_reduces == 0)):
            return []
        if (self.adaptive.enabled and self.overload_policy != "none"
                and self._overload_check(now)):
            # pressured epoch: EDF-ordered allocation starves late-deadline
            # jobs and serializes the drain — degenerate to the exact Fair
            # assignment (parking suspended) until the cluster fully drains
            return self._select_overloaded(node, free_map, free_reduce, now)
        out: List[Launch] = []
        # bootstrap jobs first (no completed or running tasks), oldest first;
        # then EDF ascending absolute deadline — both maintained
        # incrementally, and iterated lazily so an early slot exhaustion
        # stops the scan
        edf_jobs = self._edf_jobs
        for phase in ("demand", "backfill", "remote_fill"):
            if free_map <= 0 and free_reduce <= 0:
                break       # later phases cannot launch or donate anything
            # Pass 1 "demand": Eq.-10 minimum demands, bootstrap jobs first
            #   (probe tasks), then EDF (Algorithm 2).  Non-local map
            #   candidates are parked for reconfiguration (Algorithm 1).
            # Pass 2 "backfill": work-conserving — the abstract's "maximize
            #   the use of resources among the active jobs": leftover slots
            #   go to jobs beyond their minimum in EDF order, still parking
            #   non-local candidates.
            # Pass 3 "remote_fill": any core still idle takes a remote task
            #   (last resort — patient parking must never idle the cluster).
            if phase == "demand" and self.bootstrap:
                # snapshot: a bootstrap job that launches its probe task
                # mid-phase must not be revisited in EDF position
                ordered = (list(self.bootstrap.values())
                           + [j for j in edf_jobs if j.has_progress])
            else:
                # no bootstrap jobs -> every active job has progress, and
                # the EDF list is exactly the seed's stable-sorted order
                ordered = edf_jobs
            if phase == "remote_fill":
                # Before burning idle cores on *remote* tasks, donate them to
                # parked *local* tasks waiting on this machine's AQ — a local
                # task on the sibling VM is strictly faster than a remote one
                # here (this is what makes Algorithm 1 pay off: the donor
                # core must not be re-occupied by remote work).
                free_map = self._donate_idle_cores(node, free_map, now)
            for job in ordered:
                if free_map <= 0 and free_reduce <= 0:
                    break
                demand = job.demand
                n_m = demand.n_m if demand else 1   # bootstrap: one probe task
                n_r = demand.n_r if demand else 1
                if phase != "demand":
                    n_m, n_r = job.spec.u_m, job.spec.v_r
                if not job.map_done:
                    parked_count = self._parked_maps_per_job
                    while free_map > 0 and (
                            len(job.running_map)
                            + parked_count.get(job.spec.job_id, 0)) < n_m:
                        launch = self._assign_map(
                            job, node, now, allow_park=(phase != "remote_fill"))
                        if launch is None:
                            break
                        if launch.via_reconfig:
                            # task parked on AQ; node's core is only *offered*
                            # (RQ) — it keeps serving until the match actually
                            # unplugs it, so the slot stays schedulable now
                            pass
                        else:
                            self._launch_map(job, launch, out, now)
                            free_map -= 1
                elif not job.all_done:
                    while (free_reduce > 0 and job.pending_reduce
                           and len(job.running_reduce) < n_r):
                        idx = job.first_pending_reduce()
                        t = TaskId(job.spec.job_id, TaskKind.REDUCE, idx)
                        out.append(Launch(t, node, local=True))
                        self._start_reduce(job, idx, node)
                        free_reduce -= 1
        return out

    def _launch_map(self, job: JobRuntime, launch: Launch,
                    out: List[Launch], now: float) -> None:
        """Commit a (non-parked) map launch + adaptive outcome feedback: a
        task that parked earlier (still-queued reservation or expired) just
        resolved — data-locally (the park paid) or remotely (it didn't)."""
        out.append(launch)
        self._start_map(job, launch.task.index, launch.node)
        if launch.local:
            job.local_map_launches += 1
        else:
            job.remote_map_launches += 1
        if self.adaptive.enabled:
            task = launch.task
            if task in self.parked or task in self.no_park:
                if (not launch.local and self.adaptive.crash_discount
                        and self.down_nodes
                        and all(v in self.down_nodes
                                for v in job.spec.block_placement[
                                    task.index])):
                    # the park lost to the crash, not to core starvation:
                    # every live replica of its data is down, so the
                    # remote launch was forced — resolve the park without
                    # charging the fail-streak / win-rate gates
                    self.reconfig.discard_park_outcome(task, now)
                else:
                    self.reconfig.note_park_outcome(task, now,
                                                    won=launch.local)

    # -- adaptive overload mode (AdaptiveConfig, off by default) --------------

    def _select_overloaded(self, node: int, free_map: int, free_reduce: int,
                           now: float) -> List[Launch]:
        """Latched-overload variant of ``select``: pure deficit round-robin
        (the Fair regime).  Many small jobs squeezed through shares far
        below their width is exactly where EDF-ordered allocation only
        picks arbitrary winners, starves late-deadline jobs and serializes
        the drain; new jobs have zero deficit, so the bootstrap-probe
        precedence emerges on its own.  Parking is suspended here
        (``_assign_map`` checks ``overload_mode``) — measured, even
        live-offer parks queue behind stale offers under saturation."""
        out: List[Launch] = []
        free_map, free_reduce = self._fair_backfill(node, free_map,
                                                    free_reduce, now, out)
        # donate still-idle cores to parked tasks waiting on this machine
        # (same donation rule as the legacy remote_fill pass)
        self._donate_idle_cores(node, free_map, now)
        return out

    def _donate_idle_cores(self, node: int, free_map: int,
                           now: float) -> int:
        """Offer idle cores on ``node`` toward parked tasks waiting on its
        machine's AQ (one offer per sibling-targeted entry, never below the
        vCPU minimum); returns the remaining free slots."""
        m = self.spec.machine_of(node)
        pending = sum(1 for p in self.reconfig.aq[m] if p.target_vm != node)
        while (free_map > 0 and pending > 0
               and self.reconfig.vcpus[node] > self.spec.min_vcpus_per_vm):
            self.reconfig.release_core(node, now)
            free_map -= 1
            pending -= 1
        return free_map

    def _fair_backfill(self, node: int, free_map: int, free_reduce: int,
                       now: float, out: List[Launch]) -> Tuple[int, int]:
        """Deficit round-robin over active jobs (the Fair baseline's loop),
        with map candidates resolved through ``_assign_map`` — under the
        overload latch (the only current caller) that means local-first
        then immediate remote, parking bypassed.  The ``via_reconfig``
        rotation below is defensive: if a future caller runs this loop
        with parking admitted, a job that just parked rotates to the back
        (commitment counts include parked maps) instead of re-parking."""
        jobs = list(self.active.values())
        if not jobs:
            return free_map, free_reduce
        by_seq = {j.seq: j for j in jobs}
        parked_count = self._parked_maps_per_job

        def commit(job: JobRuntime) -> int:
            return (len(job.running_map) + len(job.running_reduce)
                    + parked_count.get(job.spec.job_id, 0))

        entries = sorted((commit(j), j.spec.submit_time, j.seq) for j in jobs)
        while free_map > 0 or free_reduce > 0:
            served: Optional[int] = None
            for pos, (_, _, seq) in enumerate(entries):
                job = by_seq[seq]
                if free_map > 0 and not job.map_done:
                    launch = self._assign_map(job, node, now)
                    if launch is None:
                        continue        # nothing launchable for this job now
                    if launch.via_reconfig:
                        served = pos    # parked: slot stays offered, rotate
                        break
                    self._launch_map(job, launch, out, now)
                    free_map -= 1
                    served = pos
                    break
                if (free_reduce > 0 and job.map_done and not job.all_done
                        and job.pending_reduce):
                    idx = job.first_pending_reduce()
                    t = TaskId(job.spec.job_id, TaskKind.REDUCE, idx)
                    out.append(Launch(t, node, local=True))
                    self._start_reduce(job, idx, node)
                    free_reduce -= 1
                    served = pos
                    break
            if served is None:
                break
            _, _, seq = entries.pop(served)
            job = by_seq[seq]
            bisect.insort(entries, (commit(job), job.spec.submit_time, seq))
        return free_map, free_reduce

    # -- Algorithm 1 -----------------------------------------------------------
    def _first_pending_not_parked(self, job: JobRuntime) -> Optional[int]:
        """Smallest pending map index whose TaskId is not parked.  Parked
        tasks stay pending (they may expire back), so they cannot be lazily
        evicted from the heap — pop them aside and push back."""
        jid = job.spec.job_id
        if not self._parked_maps_per_job.get(jid):
            return job.first_pending_map()   # nothing parked: plain peek
        heap, pend = job._pending_map_heap, job.pending_map
        skipped: List[int] = []
        idx: Optional[int] = None
        while heap:
            top = heap[0]
            if top not in pend:
                heapq.heappop(heap)
                continue
            if TaskId(jid, TaskKind.MAP, top) in self.parked:
                skipped.append(heapq.heappop(heap))
                continue
            idx = top
            break
        for s in skipped:
            heapq.heappush(heap, s)
        return idx

    def _assign_map(self, job: JobRuntime, node: int, now: float,
                    allow_park: bool = True) -> Optional[Launch]:
        local_idx = job.first_local_pending_map(node)
        if local_idx is not None:
            return Launch(TaskId(job.spec.job_id, TaskKind.MAP, local_idx),
                          node, local=True)
        idx = self._first_pending_not_parked(job)
        if idx is None:
            return None
        task = TaskId(job.spec.job_id, TaskKind.MAP, idx)
        placement = job.spec.block_placement[idx]
        slack = job.absolute_deadline - now
        # Deadline-critical or once-expired tasks run remotely right away;
        # everything else prefers parking (Algorithm 1), falling through to
        # the remote-fill pass only when the AQ is saturated.
        deadline_critical = slack <= 3.0 * self.reconfig.max_wait
        if (not self.parking or task in self.no_park or deadline_critical
                or not allow_park):
            if self.trace is not None and self.trace.parks:
                self._trace_deny(now, task, node,
                                 "parking_off" if not self.parking
                                 else "no_park" if task in self.no_park
                                 else "deadline_critical" if deadline_critical
                                 else "remote_fill",
                                 slack=slack)
            return Launch(task, node, local=False)
        adaptive = self.reconfig.adaptive
        # the crowd bar: under the reduce-aware overload policy only
        # map-open jobs count — jobs riding out long reduce tails do not
        # compete for map slots, so they must not suppress parking
        # (measured on shuffle_heavy/20x2: the all-active crowd bar kept
        # parking shut for the whole run, locality 50% -> 17%; letting the
        # park-outcome EWMA override the crowd instead was measured worse —
        # reservation-effect "wins" still cost throughput under saturation)
        crowd = (self.map_open_jobs if self.overload_policy == "reduce_aware"
                 else len(self.active))
        if adaptive.enabled and (
                self.overload_mode
                or (crowd >= adaptive.park_active_factor
                    * (self.spec.num_machines - self._machines_down)
                    and not self._wide_batch(self.total_pending_maps)
                    and not self._churn_relief(now))):
            # Overload latch or a crowd of active jobs: per-job shares sit
            # far below job widths, every parked map lands on its job's
            # phase-critical path, and even live-offer parks queue behind
            # stale offers under pressure (measured) — no park beats
            # starting remotely right now, so both parking paths (S_rq and
            # S_aq) are bypassed.  Two crowds are exempt: a crowd of *wide*
            # jobs (the saturated closed mix: _wide_batch), where every job
            # has plenty of sibling maps to absorb a park's wait, and a
            # churning fleet (_churn_relief), where re-replication is
            # starving locality and parking is how the fixed policy wins —
            # both are exactly where parking pays; the latch
            # (overload_mode) still suspends parking unconditionally.
            if self.trace is not None and self.trace.parks:
                self._trace_deny(
                    now, task, node,
                    "overload_latch" if self.overload_mode else "crowd_bar",
                    overload=self.overload_mode, crowd=crowd,
                    bar=adaptive.park_active_factor
                    * (self.spec.num_machines - self._machines_down))
            return Launch(task, node, local=False)
        if self.down_nodes:
            # crashed nodes cannot host a parked task; with every replica
            # down the task runs remotely (re-read from the durable store)
            # until re-replication restores a live replica
            placement = tuple(v for v in placement
                              if v not in self.down_nodes)
            if not placement:
                if self.trace is not None and self.trace.parks:
                    self._trace_deny(now, task, node, "replicas_down")
                return Launch(task, node, local=False)
        # S_rq: data nodes by RQ entries desc (a pre-offered donor core means
        # wait ≈ hot-plug latency); else S_aq: data nodes by AQ entries asc.
        s_rq = sorted(placement, key=lambda v: -self.reconfig.rq_len(v))
        wait_bound = None
        if self.reconfig.rq_len(s_rq[0]) > 0:
            p = s_rq[0]
            if (adaptive.enabled and not self._churn_relief(now)
                    and not self._wide_batch(self.total_pending_maps)):
                # a live donor offer: the match is imminent, so the park
                # only needs the shortest patience in case it goes stale.
                # Mid-churn (_churn_relief) the full patience applies
                # instead: offers go stale because the *donor* crashed,
                # and a 4-second fuse would expire the park into the
                # no_park blacklist, disqualifying the task from every
                # later park for no fault of the machine's.  Wide batches
                # (_wide_batch) also keep full patience: a parked map has
                # siblings to keep its phase busy, so the stale-offer
                # downside the fuse hedges against is not on the critical
                # path there
                wait_bound = adaptive.max_wait_floor
        else:
            p = min(placement, key=lambda v: self.reconfig.aq_len(v))
            if len(self.reconfig.aq[self.spec.machine_of(p)]) >= self.park_depth:
                if self.trace is not None and self.trace.parks:
                    self._trace_deny(now, task, node, "aq_saturated",
                                     machine=self.spec.machine_of(p),
                                     depth=self.park_depth)
                return None      # AQ saturated: leave for remote-fill / later
            if adaptive.enabled and not self._churn_relief(now):
                # width gate — stands down under churn relief
                # (_churn_relief): on a churning fleet narrow backlogs
                # still park profitably, because re-replication keeps
                # locality scarce fleet-wide.  Otherwise: a narrow
                # backlog (few pending maps per map-open job) puts every
                # parked map on its job's phase-critical path — launch
                # remotely instead.  Wide jobs (the paper's closed mix)
                # park for free: a parked map has plenty of siblings to
                # keep its phase busy.
                if (self.total_pending_maps
                        < adaptive.park_min_width * self.map_open_jobs):
                    self.reconfig.stats["park_declined"] += 1
                    if self.trace is not None and self.trace.parks:
                        self._trace_deny(
                            now, task, node, "width_gate",
                            pending_maps=self.total_pending_maps,
                            map_open_jobs=self.map_open_jobs,
                            min_width=adaptive.park_min_width)
                    return Launch(task, node, local=False)
            if (adaptive.enabled and not self._churn_relief(now)
                    and not self._wide_batch(self.total_pending_maps)):
                # pressure gate: park only when a donor core is predicted
                # within the task's remote-launch break-even (the extra
                # time a remote read would cost on this fabric).  Like the
                # width gate it stands down under churn relief *and* on
                # wide batches: both are regimes where parking wins by
                # default (measured: its win-floor pruning alone cost the
                # saturated closed mix ~2/3 of the fixed policy's paired
                # win), so admission reverts to the fixed policy's and the
                # EWMAs idle as observers
                prof = job.spec.profile
                breakeven = (prof.map_time * prof.remote_penalty
                             * self.spec.remote_penalty_scale)
                if (self.spec.faults.enabled
                        and self.spec.faults.machine_classes):
                    # heterogeneous fleet: the bar is per-class — a slow
                    # machine's map takes longer and its fabric makes the
                    # remote read costlier, both scale the break-even
                    mc = self.spec.machine_class(self.spec.machine_of(p))
                    breakeven *= mc.speed * mc.fabric
                ok, wait_bound = self.reconfig.park_decision(
                    self.spec.machine_of(p), now, breakeven)
                if not ok:
                    if self.trace is not None and self.trace.parks:
                        # the reconfigurator stashed which of its three
                        # gates declined (fail_streak / predicted_wait /
                        # win_floor) plus the signal values it saw
                        gate, signals = (self.reconfig.last_decline
                                         or ("park_decision", {}))
                        self._trace_deny(now, task, node, gate,
                                         machine=self.spec.machine_of(p),
                                         **signals)
                    return Launch(task, node, local=False)
        self.reconfig.park_task(task, p, now, wait_bound=wait_bound)
        self.reconfig.release_core(node, now)   # RQ of machine(node)
        self.parked.add(task)
        self._parked_maps_per_job[job.spec.job_id] = (
            self._parked_maps_per_job.get(job.spec.job_id, 0) + 1)
        if self.trace is not None and self.trace.parks:
            self.trace.emit(now, "park_admit", {
                "task": task, "job": job.spec.job_id,
                "target_vm": p, "machine": self.spec.machine_of(p),
                "offering_node": node, "wait_bound": wait_bound})
        return Launch(task, p, local=True, via_reconfig=True)

    def _trace_deny(self, now: float, task: TaskId, node: int,
                    gate: str, **signals: object) -> None:
        """Emit a park_deny record naming the Algorithm-1 gate that turned
        this map's park into a remote launch (see tracing.PARK_GATES)."""
        data: Dict[str, object] = {"task": task, "job": task.job_id,
                                   "node": node, "gate": gate}
        data.update(signals)
        self.trace.emit(now, "park_deny", data)

    def _unpark(self, task: TaskId) -> None:
        if task in self.parked:
            self.parked.discard(task)
            self._parked_maps_per_job[task.job_id] -= 1

    # -- callbacks from the simulator for reconfig lifecycle -------------------
    def parked_task_launched(self, task: TaskId, node: int, now: float) -> None:
        self._unpark(task)
        job = self.jobs[task.job_id]
        self._start_map(job, task.index, node)
        job.local_map_launches += 1
        job.reconfig_map_launches += 1
        if self.trace is not None and self.trace.parks:
            self.trace.emit(now, "unpark", {
                "task": task, "job": task.job_id, "node": node,
                "machine": self.spec.machine_of(node)})

    def parked_task_expired(self, task: TaskId, now: float) -> None:
        self._unpark(task)
        self.no_park.add(task)
