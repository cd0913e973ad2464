"""Resource Reconfigurator — paper §4.1, Algorithm 1.

This is the port's own copy of the JAX package's ``core/reconfigurator.py``
(pure Python; the event engine's parity tests hold every decision to the
original's).

Per-physical-machine **Assign Queues (AQ)** and **Release Queues (RQ)**:

* a VM with a surplus free core registers it in its machine's RQ;
* a map task that *should* run data-locally on VM ``p`` (but ``p`` has no free
  slot) is parked in machine(p)'s AQ;
* whenever both queues of one machine are non-empty, a vCPU is hot-unplugged
  from the releasing VM and hot-plugged into the target VM (latency
  ``ClusterSpec.hotplug_latency``), and the parked task launches data-locally.

The queues are decoupled exactly as in the paper: releases are lazy,
assignment waits until the machine actually has a donor core.  CPU never
crosses a physical machine boundary (paper: "CPU resource cannot be
transferred beyond the physical system boundary").

A parked task that waits longer than ``max_wait`` is handed back to the
scheduler for a remote launch — the paper observes this wait is negligible
("tasks ... finish in less than a minute"), but an implementation must bound
it to protect deadlines.

**Pressure-adaptive mode** (``ClusterSpec.adaptive``, off by default): the
fixed ``max_wait`` bet fails under sustained saturation — no VM ever offers
a core, so every parked task burns its full patience before the remote
fallback.  With ``AdaptiveConfig.enabled`` the reconfigurator additionally
tracks, per machine and incrementally,

* ``rq_depth`` — queued donor offers (mirror of ``len(rq[m])``, audited by
  the invariant suite),
* ``offer_ewma`` / ``last_offer`` — an EWMA over the intervals between
  donor-core offers, fed by the simulator's release events,
* ``free_ewma`` / ``last_free`` — the same over raw core-free events
  (``ClusterSim`` notifies via :meth:`observe_core_free`),
* ``fail_streak`` — consecutive park *outcomes* on the machine that ended
  in a remote launch (the scheduler reports outcomes through
  :meth:`note_park_outcome`): a park pays when its task eventually runs
  data-locally — via a donor match **or** via the target node's own freed
  slot (most parks resolve this way: the AQ entry acts as a reservation) —
  and fails when the task burns its full patience and launches remotely
  anyway.  A machine whose streak hits the limit stops admitting parks
  until an offer arrives, a park pays, or ``fail_cooldown`` elapses
  (periodic probing keeps the signal fresh),

and exposes :meth:`predicted_core_wait` + :meth:`park_decision`, which the
scheduler uses to gate park admission against a task's remote-launch
break-even and to bound each park's patience (see ``AdaptiveConfig``).
Disabled, every decision path is bit-exact against the original's frozen
seed engine.

Scaling note: ``match`` visits only machines whose AQ *and* RQ are both
non-empty (tracked incrementally, ascending machine order — identical
matching order to a full 0..M-1 sweep), and ``expire_stale`` keeps a global
min-heap on park time so the common no-expiry heartbeat costs O(1) instead
of scanning every machine's queue.  Both are pure-performance changes; the
JAX package pins the queue semantics against its frozen seed engine, and
the port's tests hold this copy to the JAX package's.
"""
from __future__ import annotations

import heapq
from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, Dict, List, Optional, Set, Tuple

from repro_torch.core.types import ClusterSpec, TaskId


@dataclass(eq=False)
class ParkedTask:
    """One AQ entry.  ``eq=False``: queue/heap bookkeeping is by identity —
    two parks of one task at the same instant must stay distinguishable.

    ``wait_bound`` is the adaptive per-park patience; ``None`` means the
    legacy fixed ``Reconfigurator.max_wait`` applies."""

    task: TaskId
    target_vm: int
    parked_at: float
    wait_bound: Optional[float] = None


@dataclass
class PendingPlug:
    """A matched release->assign pair in flight (hot-plug latency)."""
    machine: int
    from_vm: int
    to_vm: int
    task: TaskId
    ready_at: float


class Reconfigurator:
    """Tracks AQ/RQ per machine and per-VM vCPU counts."""

    # decision-trace bus (repro_torch.core.tracing.TraceBus); attached by the
    # simulator when ClusterSpec.tracing is enabled, None otherwise — every
    # emission site is a single `is None` guard, so tracing-off stays
    # bit-exact against the legacy engine
    trace = None

    def __init__(self, spec: ClusterSpec, max_wait: float = 15.0):
        self.spec = spec
        self.max_wait = max_wait
        self.adaptive = spec.adaptive
        self.vcpus: List[int] = [spec.base_map_slots] * spec.num_nodes
        self.aq: List[Deque[ParkedTask]] = [deque() for _ in range(spec.num_machines)]
        self.rq: List[Deque[int]] = [deque() for _ in range(spec.num_machines)]  # vm ids
        self.in_flight: List[PendingPlug] = []
        # host-integration hook: validates that an offered core is still free
        # (an RQ entry goes stale when the VM re-occupies the core before the
        # match).  Set by the simulator / fleet runtime.
        self.validator: Optional[Callable[[int], bool]] = None
        self.stats = {"reconfigurations": 0, "parked": 0, "expired": 0,
                      "total_wait": 0.0, "park_declined": 0,
                      "park_wins": 0, "park_losses": 0, "park_crashed": 0,
                      "park_crash_discounted": 0,
                      "harvest_borrows": 0, "harvest_returns": 0}
        # machines with a non-empty AQ / RQ, so match() touches only
        # machines that can possibly pair instead of sweeping all of them
        self._aq_nonempty: Set[int] = set()
        self._rq_nonempty: Set[int] = set()
        # (key, seq, machine, entry) min-heap; key is the park time (legacy
        # fixed max_wait) or the absolute expiry time (adaptive per-park
        # bounds).  Entries are lazy — a task already matched/cancelled
        # fails the identity check on pop.
        self._park_heap: List[Tuple[float, int, int, ParkedTask]] = []
        self._park_seq = 0
        # task-id -> (machine, entry): O(1) cancel_parked / membership
        self._parked_entry: Dict[TaskId, Tuple[int, ParkedTask]] = {}
        # -- per-machine pressure signals (see AdaptiveConfig) --------------
        m = spec.num_machines
        # incremental mirror of len(self.rq[machine]) — updated at every
        # offer/consume site, recounted by the invariant suite
        self.rq_depth: List[int] = [0] * m
        self.offer_ewma: List[Optional[float]] = [None] * m
        self.last_offer: List[Optional[float]] = [None] * m
        self.free_ewma: List[Optional[float]] = [None] * m
        self.last_free: List[Optional[float]] = [None] * m
        self.fail_streak: List[int] = [0] * m
        self.last_fail: List[Optional[float]] = [None] * m
        # cluster-level park win-rate EWMA (1 = every park ends local,
        # 0 = every park ends remote); starts optimistic so the paper's
        # closed-mix regime parks from the first heartbeat
        self.park_outcome_ewma: float = 1.0
        self._last_park: Optional[float] = None
        # expired parks whose outcome (local vs remote launch) is still
        # unknown: task -> target machine, resolved by note_park_outcome
        self._expired_machine: Dict[TaskId, int] = {}
        # last park_decision decline: (gate, signals) — written only when
        # the trace bus is attached, read by the scheduler so the park_deny
        # record carries the task context this method never sees
        self.last_decline: Optional[Tuple[str, Dict[str, object]]] = None

    def _valid_donor(self, vm: int) -> bool:
        if self.vcpus[vm] <= self.spec.min_vcpus_per_vm:
            return False
        return self.validator(vm) if self.validator is not None else True

    # -- queue registration (Algorithm 1 lines 4-12) -----------------------
    def aq_len(self, vm: int) -> int:
        return sum(1 for t in self.aq[self.spec.machine_of(vm)]
                   if t.target_vm == vm)

    def rq_len(self, vm: int) -> int:
        """Count of *currently valid* donor offers on vm's machine."""
        return sum(1 for cand in self.rq[self.spec.machine_of(vm)]
                   if cand != vm and self._valid_donor(cand))

    def park_task(self, task: TaskId, target_vm: int, now: float,
                  wait_bound: Optional[float] = None) -> None:
        """AQ entry: task waits for a core on target_vm's machine.

        ``wait_bound`` is the adaptive per-park patience; in adaptive mode a
        missing bound defaults to the clamped ``max_wait`` so direct callers
        (tests, fleet runtime) stay within [floor, ceiling] too."""
        m = self.spec.machine_of(target_vm)
        if self.adaptive.enabled:
            if wait_bound is None:
                wait_bound = min(self.adaptive.max_wait_ceiling,
                                 max(self.adaptive.max_wait_floor,
                                     self.max_wait))
            key = now + wait_bound          # heap orders by expiry time
        else:
            wait_bound = None               # legacy: fixed max_wait applies
            key = now                       # heap orders by park time
        entry = ParkedTask(task, target_vm, now, wait_bound)
        self.aq[m].append(entry)
        self._aq_nonempty.add(m)
        self._park_seq += 1
        heapq.heappush(self._park_heap, (key, self._park_seq, m, entry))
        self._parked_entry[task] = (m, entry)
        self.stats["parked"] += 1

    def release_core(self, vm: int, now: float) -> None:
        """RQ entry: vm offers one core (never below min_vcpus)."""
        if self.vcpus[vm] <= self.spec.min_vcpus_per_vm:
            return
        m = self.spec.machine_of(vm)
        self.rq[m].append(vm)
        self.rq_depth[m] += 1
        self._rq_nonempty.add(m)
        if self.adaptive.enabled:
            # a donor offer is the machine's "core freed for neighbours"
            # event: update the offer-interval EWMA and re-open parking
            last = self.last_offer[m]
            if last is not None:
                self.offer_ewma[m] = self._ewma(self.offer_ewma[m], now - last)
            self.last_offer[m] = now
            self.fail_streak[m] = 0

    def _ewma(self, prev: Optional[float], sample: float) -> float:
        if prev is None:
            return sample
        a = self.adaptive
        if (a.enabled and a.ewma_gap_cap > 0.0 and prev > 0.0
                and sample > a.ewma_gap_cap * prev):
            # an interval spanning a restart gap (or any long disruption)
            # says "nothing happened for a while", not "the machine got
            # this much slower" — clamp it so one outage cannot inflate
            # the predicted core wait for the whole next epoch.  The
            # `prev > 0` guard keeps a zero-interval sample (two offers on
            # one event) from wedging the EWMA at zero forever
            sample = a.ewma_gap_cap * prev
        return a.ewma_alpha * sample + (1.0 - a.ewma_alpha) * prev

    def observe_core_free(self, vm: int, now: float) -> None:
        """Simulator hook: a core on ``vm`` just freed (map finish), whether
        or not it was offered.  Feeds the raw core-free-interval EWMA."""
        m = self.spec.machine_of(vm)
        last = self.last_free[m]
        if last is not None:
            self.free_ewma[m] = self._ewma(self.free_ewma[m], now - last)
        self.last_free[m] = now

    def _aq_sync(self, m: int) -> None:
        if not self.aq[m]:
            self._aq_nonempty.discard(m)

    def _drop_parked_entry(self, task: TaskId, entry: ParkedTask) -> None:
        """Clear the cancel index when ``entry`` leaves its AQ (but never a
        newer park of the same task id)."""
        cur = self._parked_entry.get(task)
        if cur is not None and cur[1] is entry:
            del self._parked_entry[task]

    def cancel_parked(self, task: TaskId) -> bool:
        """Remove ``task``'s AQ entry, O(1) lookup via the park index (the
        deque removal only walks that one machine's queue, bounded by the
        scheduler's park depth — not every AQ in the cluster)."""
        hit = self._parked_entry.pop(task, None)
        if hit is None:
            return False
        m, entry = hit
        self.aq[m].remove(entry)            # identity: ParkedTask has eq=False
        self._aq_sync(m)
        return True

    # -- fault integration (FaultConfig; never reached when faults are off) --
    def machine_down(self, machine: int, now: float) -> List[TaskId]:
        """Machine crashed: drop every AQ entry and RQ offer on it and abort
        its in-flight hot-plugs (plugs never cross a machine boundary, so
        returning each aborted plug's core to its donor VM keeps the
        machine's vCPU sum — and the cluster conservation invariant —
        exact).  Returns the task ids whose park or plug was cancelled so
        the scheduler can make them schedulable again."""
        cancelled: List[TaskId] = []
        for entry in list(self.aq[machine]):
            self._drop_parked_entry(entry.task, entry)
            cancelled.append(entry.task)
        self.aq[machine].clear()
        self._aq_nonempty.discard(machine)
        self.rq[machine].clear()
        self.rq_depth[machine] = 0
        self._rq_nonempty.discard(machine)
        keep: List[PendingPlug] = []
        for plug in self.in_flight:
            if plug.machine == machine:
                self.vcpus[plug.from_vm] += 1
                cancelled.append(plug.task)
            else:
                keep.append(plug)
        self.in_flight = keep
        # unresolved expired-park outcomes on this machine die with it: a
        # post-crash remote launch must not charge the machine's (reset)
        # fail streak for a pre-crash park
        for task in [t for t, m in self._expired_machine.items()
                     if m == machine]:
            del self._expired_machine[task]
        self.stats["park_crashed"] += len(cancelled)
        if self.trace is not None and self.trace.parks:
            for task in cancelled:
                self.trace.emit(now, "park_crashed", {
                    "task": task, "job": task.job_id,
                    "machine": machine})
        return cancelled

    def machine_restarted(self, machine: int, now: float) -> None:
        """Machine back up: its VMs boot with the base slot shape (the
        pre-crash vCPU distribution redistributes within the machine, so
        the sum is unchanged) and every pressure signal resets — EWMAs and
        fail streaks from the pre-crash epoch would otherwise poison park
        admission on the fresh machine."""
        vpm = self.spec.vms_per_machine
        for vm in range(machine * vpm, (machine + 1) * vpm):
            self.vcpus[vm] = self.spec.base_map_slots
        self.offer_ewma[machine] = None
        self.last_offer[machine] = None
        self.free_ewma[machine] = None
        self.last_free[machine] = None
        self.fail_streak[machine] = 0
        self.last_fail[machine] = None

    # -- Borg-style harvesting (ServeConfig; policy axis `harvest`) ----------
    # The serving layer owns the borrow/return *decisions* (utilization
    # EWMA vs the headroom bar, preemptive return on load spikes or churn
    # relief); the reconfigurator owns the *accounting* — the counters the
    # trace-bus harvest events reconcile against in the invariant audit.
    # Borrowed cores never move through vcpus/in_flight: a loan shrinks
    # the service's pinned reservation on its own VM (raising that VM's
    # map capacity in the engine), so total_vcpus conservation is exact.

    def harvest_borrow(self, now: float, *, machine: int, node: int,
                       service: str, replica: int, signal: str,
                       util: float, cores_left: int) -> None:
        """One service core lent to the batch side (``signal`` names the
        trigger: parked_demand / map_backlog)."""
        self.stats["harvest_borrows"] += 1
        if self.trace is not None and self.trace.serve:
            self.trace.emit(now, "harvest_borrow", {
                "machine": machine, "node": node, "service": service,
                "replica": replica, "signal": signal, "util": util,
                "cores_left": cores_left})

    def harvest_return(self, now: float, *, machine: int, node: int,
                       service: str, replica: int, signal: str,
                       util: float, cores_left: int) -> None:
        """A borrowed core returned to its service (``signal`` names the
        trigger: util_spike / p99_pressure / churn_relief / machine_down)."""
        self.stats["harvest_returns"] += 1
        if self.trace is not None and self.trace.serve:
            self.trace.emit(now, "harvest_return", {
                "machine": machine, "node": node, "service": service,
                "replica": replica, "signal": signal, "util": util,
                "cores_left": cores_left})

    # -- matching ------------------------------------------------------------
    def match(self, now: float, donor_ok=None) -> List[PendingPlug]:
        """Pair AQ/RQ entries per machine; returns newly started hot-plugs.

        ``donor_ok(vm)`` lets the caller veto donors whose offered core got
        re-occupied between the offer and the match."""
        started = []
        for m in sorted(self._aq_nonempty & self._rq_nonempty):
            while self.aq[m] and self.rq[m]:
                parked = self.aq[m].popleft()
                donor = None
                while self.rq[m]:
                    cand = self.rq[m].popleft()
                    self.rq_depth[m] -= 1
                    if (cand != parked.target_vm and self._valid_donor(cand)
                            and (donor_ok is None or donor_ok(cand))):
                        donor = cand
                        break
                    # stale / self-targeted offer: drop it
                if donor is None:
                    self.aq[m].appendleft(parked)
                    break
                if self.vcpus[parked.target_vm] >= self.spec.max_vcpus_per_vm:
                    # target saturated: requeue task, put donor back
                    self.rq[m].append(donor)
                    self.rq_depth[m] += 1
                    self.aq[m].append(parked)
                    break
                self.vcpus[donor] -= 1
                plug = PendingPlug(m, donor, parked.target_vm, parked.task,
                                   now + self.spec.hotplug_latency)
                self.in_flight.append(plug)
                started.append(plug)
                cur = self._parked_entry.get(parked.task)
                live = cur is not None and cur[1] is parked
                self._drop_parked_entry(parked.task, parked)
                if self.adaptive.enabled and live:
                    # a donor match of a *live* park is a win — record it
                    # here: the matched task launches through the plug path,
                    # which never reaches the scheduler's _launch_map
                    # feedback.  A stale entry (its task already resolved
                    # and reported) still gets the donated core, but must
                    # not count a second win for the same park.
                    self.fail_streak[m] = 0
                    self.last_fail[m] = None
                    a = self.adaptive
                    self.park_outcome_ewma = (
                        a.outcome_alpha
                        + (1.0 - a.outcome_alpha) * self.park_outcome_ewma)
                    self.stats["park_wins"] += 1
                    if self.trace is not None and self.trace.parks:
                        self.trace.emit(now, "park_outcome", {
                            "task": parked.task, "job": parked.task.job_id,
                            "machine": m, "won": True, "cause": "donor_match",
                            "ewma": self.park_outcome_ewma})
                self.stats["reconfigurations"] += 1
                self.stats["total_wait"] += now - parked.parked_at
                if self.trace is not None and self.trace.parks:
                    self.trace.emit(now, "reconfig_match", {
                        "task": parked.task, "job": parked.task.job_id,
                        "machine": m, "from_vm": donor,
                        "to_vm": parked.target_vm,
                        "wait": now - parked.parked_at})
            self._aq_sync(m)
            if not self.rq[m]:
                self._rq_nonempty.discard(m)
        return started

    def complete_plugs(self, now: float) -> List[PendingPlug]:
        """Hot-plugs whose latency elapsed; caller launches the task."""
        done = [p for p in self.in_flight if p.ready_at <= now]
        self.in_flight = [p for p in self.in_flight if p.ready_at > now]
        for p in done:
            self.vcpus[p.to_vm] += 1
        return done

    def expire_stale(self, now: float) -> List[ParkedTask]:
        """Parked tasks past their wait bound -> hand back for remote launch.

        The park heap makes the common "nothing expired" case O(1); popped
        entries whose task already left its AQ (matched / cancelled) are
        discarded.  Legacy mode keys the heap by park time against the fixed
        ``max_wait``; adaptive mode keys it by each entry's absolute expiry
        time (per-park bounds vary, so park order is not expiry order)."""
        out = []
        heap = self._park_heap
        adaptive = self.adaptive.enabled
        # NB: `now - parked_at > max_wait` is the seed's exact expression;
        # rewriting it (as `parked_at < now - max_wait`, or against the
        # precomputed `parked_at + wait_bound` heap key) is NOT
        # float-identical at the boundary — and the boundary is the common
        # case, because parks and expiry checks share the heartbeat grid.
        # Adaptive mode therefore only *orders* by the expiry key and pops
        # with the seed's expression against each entry's own bound.
        while heap and (now - heap[0][3].parked_at > heap[0][3].wait_bound
                        if adaptive else now - heap[0][0] > self.max_wait):
            _, _, m, item = heapq.heappop(heap)
            q = self.aq[m]
            if not any(it is item for it in q):
                continue            # already matched or cancelled
            q.remove(item)
            self._aq_sync(m)
            cur = self._parked_entry.get(item.task)
            live = cur is not None and cur[1] is item
            self._drop_parked_entry(item.task, item)
            if adaptive and live:
                # outcome unknown yet: the task may still launch locally on
                # its data node (the reservation paid) or remotely (it
                # didn't) — the scheduler reports which via
                # note_park_outcome.  A stale entry's task already resolved
                # and reported, so recording it here would leak the dict
                # entry forever (the task never launches again).
                self._expired_machine[item.task] = m
            out.append(item)
            self.stats["expired"] += 1
            if self.trace is not None and self.trace.parks:
                self.trace.emit(now, "park_expired", {
                    "task": item.task, "job": item.task.job_id,
                    "machine": m, "parked_at": item.parked_at,
                    "waited": now - item.parked_at,
                    "wait_bound": item.wait_bound})
        return out

    def note_park_outcome(self, task: TaskId, now: float, won: bool) -> None:
        """Scheduler feedback closing the park-admission loop: ``task`` —
        parked (possibly expired) earlier — just launched.  ``won`` means it
        ran data-locally (reservation or match paid); a remote launch after
        a full-patience wait is the genuine starvation signal that feeds the
        machine's fail streak.

        The park index entry is dropped here: the park is *resolved*, and a
        leftover AQ entry is from now on pure-stale — a later donor match
        of it must not count a second win for the same park."""
        hit = self._parked_entry.get(task)
        if hit is not None:
            self._drop_parked_entry(task, hit[1])
            m = hit[0]
        else:
            m = self._expired_machine.pop(task, None)
        if m is None:
            return
        a = self.adaptive
        self.park_outcome_ewma = (a.outcome_alpha * (1.0 if won else 0.0)
                                  + (1.0 - a.outcome_alpha)
                                  * self.park_outcome_ewma)
        if won:
            self.fail_streak[m] = 0
            self.last_fail[m] = None    # full park patience restored
            self.stats["park_wins"] += 1
        else:
            self.fail_streak[m] += 1
            self.last_fail[m] = now
            self.stats["park_losses"] += 1
        if self.trace is not None and self.trace.parks:
            self.trace.emit(now, "park_outcome", {
                "task": task, "job": task.job_id, "machine": m,
                "won": won, "cause": "reservation" if won else "remote",
                "fail_streak": self.fail_streak[m],
                "ewma": self.park_outcome_ewma})

    def discard_park_outcome(self, task: TaskId, now: float) -> None:
        """Crash-discounted resolution of a pending park outcome: ``task``
        just launched remotely because every live replica of its data is
        down — the park lost to the crash, not to core starvation, so the
        fail-streak and win-rate gates must not be charged
        (``AdaptiveConfig.crash_discount``).  The park index entry is
        dropped exactly as in :meth:`note_park_outcome` so the resolution
        stays one-shot."""
        hit = self._parked_entry.get(task)
        if hit is not None:
            self._drop_parked_entry(task, hit[1])
            m = hit[0]
        else:
            m = self._expired_machine.pop(task, None)
        if m is None:
            return
        self.stats["park_crash_discounted"] += 1
        if self.trace is not None and self.trace.parks:
            self.trace.emit(now, "park_outcome", {
                "task": task, "job": task.job_id, "machine": m,
                "won": False, "cause": "crash_discount",
                "fail_streak": self.fail_streak[m],
                "ewma": self.park_outcome_ewma})

    # -- adaptive pressure queries (see AdaptiveConfig) ---------------------
    def predicted_core_wait(self, machine: int, now: float) -> Optional[float]:
        """Best-effort seconds until ``machine`` can serve a parked task a
        core (donor match or its own freed slot), from the incremental
        pressure signals.  ``None`` = no signal yet (optimistic: the caller
        parks as a probe)."""
        if self.rq_depth[machine] > 0 and any(
                self._valid_donor(c) for c in self.rq[machine]):
            return self.spec.hotplug_latency    # a live offer is queued
        free = self.free_ewma[machine]
        if free is None:
            return None
        # cores recycle every ~free seconds; each AQ entry ahead plus the
        # machine's own local backlog stretches the wait, so the queue depth
        # scales the estimate (the "AQ wait distribution" signal)
        return free * (1 + len(self.aq[machine]))

    def _effective_streak(self, machine: int, now: float) -> int:
        """Fail streak with cool-down: after ``fail_cooldown`` quiet seconds
        the machine earns a fresh probe (otherwise a suspended machine could
        never re-qualify — no parks, no outcomes, no signal).  ``last_fail``
        is kept, so post-cooldown probes still run at floor patience until
        one actually pays off."""
        streak = self.fail_streak[machine]
        if streak and self.last_fail[machine] is not None \
                and now - self.last_fail[machine] > self.adaptive.fail_cooldown:
            streak = self.fail_streak[machine] = 0
        return streak

    def park_decision(self, machine: int, now: float,
                      breakeven: float) -> Tuple[bool, float]:
        """Adaptive park admission for a task whose remote launch would cost
        ``breakeven`` extra seconds: returns ``(should_park, wait_bound)``.

        Declines when the machine's recent parks keep ending in remote
        launches (fail streak at the limit) or the predicted core wait
        exceeds the (margin-scaled) break-even — the caller then launches
        remotely immediately.  A machine that has lost a park since its last
        win only earns short floor-patience probes; full patience returns
        once a probe pays off."""
        a = self.adaptive
        streak = self._effective_streak(machine, now)
        if streak >= a.fail_streak_limit:
            self.stats["park_declined"] += 1
            if self.trace is not None:
                self.last_decline = ("fail_streak", {
                    "streak": streak, "limit": a.fail_streak_limit})
            return False, 0.0
        allowance = a.breakeven_margin * breakeven
        pred = self.predicted_core_wait(machine, now)
        if pred is not None and pred + self.spec.hotplug_latency > allowance:
            self.stats["park_declined"] += 1
            if self.trace is not None:
                self.last_decline = ("predicted_wait", {
                    "predicted": pred, "allowance": allowance,
                    "breakeven": breakeven})
            return False, 0.0
        probing = False
        if self.park_outcome_ewma < a.park_win_floor:
            # cluster-wide, parks have been ending remote: suspend parking,
            # letting one cheap probe through per cooldown so recovery
            # (wins push the EWMA back up) is still detectable
            if self._last_park is not None \
                    and now - self._last_park < a.fail_cooldown:
                self.stats["park_declined"] += 1
                if self.trace is not None:
                    self.last_decline = ("win_floor", {
                        "ewma": self.park_outcome_ewma,
                        "floor": a.park_win_floor})
                return False, 0.0
            probing = True
        base = (a.max_wait_floor
                if probing or self.last_fail[machine] is not None
                else self.max_wait)
        bound = min(a.max_wait_ceiling, max(a.max_wait_floor, base))
        self._last_park = now
        return True, bound

    def next_event_time(self) -> Optional[float]:
        if not self.in_flight:
            return None
        return min(p.ready_at for p in self.in_flight)

    @property
    def total_vcpus(self) -> int:
        return sum(self.vcpus) + len(self.in_flight)
