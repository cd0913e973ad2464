"""Multi-tenant serving layer: latency-SLO request streams co-located
with the batch MapReduce workload on one reconfigurable fleet.

This is the port's own copy of the JAX package's ``simcluster/serving.py``
(pure Python; a test holds serving runs byte-equal to the original's).

The ``ServeConfig`` on ``ClusterSpec`` declares long-lived services; each
replica pins vCPUs on one VM (round-robin over machines, then VMs) and
receives an open-arrival request stream — a non-homogeneous Poisson
process with the same diurnal/flash-crowd shape as
``repro_torch.simcluster.traces.ArrivalConfig``, thinned incrementally from a
dedicated ``random.Random(f"{seed}:serve:{service}:{replica}")`` stream.
Zero draws come from the decision RNG, and the arrival/service-time
schedule is a pure function of (config, seed) — byte-reproducible per
(config, seed, workload, policy), independent of scheduler decisions.

Per-request queueing is folded incrementally on the sim's serve tick
(one global chain at the heartbeat interval): each replica is an FCFS
G/G/c queue over its effective cores, arrivals since the last tick are
drained through per-core free-at heaps, and the sojourn times feed p50/
p99 latency and SLO-violation counters per tick plus exact whole-run
percentiles at the end.

The Borg-style **harvest** component (``PolicySpec`` axis ``harvest``,
accounted by ``core.reconfigurator``) runs on the same tick: a replica
whose utilization EWMA sits below ``ServeConfig.harvest_headroom`` lends
one pinned core per tick to the batch side — preferring machines whose
reconfigurator AQ holds parked maps, which the freed capacity plugs on
the next heartbeat — and takes cores back preemptively when the EWMA
crosses ``harvest_return_util`` or the tick's p99 reaches the SLO,
before the whole-run SLO is breached.  Harvesting stands down entirely
under the scheduler's churn-relief signal (read-only probe; a churning
fleet returns every borrowed core with the ``churn_relief`` signal), and
a crashed machine drops its service replicas, returning their borrowed
cores with the ``machine_down`` signal.
"""
from __future__ import annotations

import math
import random
from heapq import heappop, heappush
from typing import Dict, List, Optional, Tuple

from repro_torch.core.types import ClusterSpec, ServiceSpec

TWO_PI = 2.0 * math.pi

#: harvest trigger signals, by direction (documented vocabulary for the
#: ``harvest_borrow``/``harvest_return`` trace events)
BORROW_SIGNALS: Tuple[str, ...] = ("parked_demand", "map_backlog")
RETURN_SIGNALS: Tuple[str, ...] = ("churn_relief", "util_spike",
                                   "p99_pressure", "machine_down")


class ServiceReplica:
    """One service instance: pinned cores on one VM plus its private
    request stream and FCFS multi-server queue state."""

    __slots__ = ("svc", "index", "machine", "node", "rng",
                 "next_base", "buf", "free", "borrowed", "down", "up_since",
                 "requests", "shed", "violations", "latencies",
                 "util_ewma", "borrows", "returns")

    def __init__(self, svc: ServiceSpec, index: int, machine: int,
                 node: int, seed: int) -> None:
        self.svc = svc
        self.index = index
        self.machine = machine
        self.node = node
        # dedicated stream: zero draws from the decision RNG, so the
        # request schedule is a pure function of (config, seed)
        self.rng = random.Random(f"{seed}:serve:{svc.name}:{index}")
        self.next_base = 0.0            # thinning process position
        self.buf: List[Tuple[float, float]] = []   # (arrival, service_time)
        self.free: List[float] = [0.0] * svc.vcpus  # per-core free-at heap
        self.borrowed = 0               # cores currently lent to batch
        self.down = False
        self.up_since = 0.0
        self.requests = 0
        self.shed = 0                   # arrivals hitting a down replica
        self.violations = 0             # sojourn > slo_p99_ms
        self.latencies: List[float] = []    # sojourn seconds, whole run
        self.util_ewma: Optional[float] = None
        self.borrows = 0
        self.returns = 0

    # -- arrival stream ------------------------------------------------------
    def rate_at(self, t: float) -> float:
        s = self.svc
        if s.diurnal_amplitude <= 0.0:
            return s.base_rps
        return s.base_rps * (1.0 + s.diurnal_amplitude * math.sin(
            TWO_PI * (t + s.diurnal_phase) / s.diurnal_period))

    def gen_until(self, until: float) -> None:
        """Advance the thinned Poisson base process (plus flash-crowd
        riders) through ``until``, buffering (arrival, service_time)."""
        s = self.svc
        rng = self.rng
        lam_max = s.base_rps * (1.0 + s.diurnal_amplitude)
        while self.next_base <= until:
            self.next_base += rng.expovariate(lam_max)
            t = self.next_base
            if rng.random() * lam_max > self.rate_at(t):
                continue
            self.buf.append((t, rng.expovariate(1.0 / s.service_time)))
            if s.burst_prob > 0.0 and rng.random() < s.burst_prob:
                extra = 1 + int(rng.expovariate(1.0 / s.burst_size_mean))
                tb = t
                for _ in range(extra):
                    tb += rng.expovariate(1.0 / s.burst_stagger)
                    self.buf.append((tb, rng.expovariate(1.0 / s.service_time)))

    # -- queue ---------------------------------------------------------------
    @property
    def cores(self) -> int:
        """Effective serving cores (pinned minus borrowed)."""
        return self.svc.vcpus - self.borrowed

    def drain(self, now: float) -> Tuple[int, int, List[float], float]:
        """Process buffered arrivals <= ``now`` through the FCFS c-server
        queue; returns (served, shed, interval sojourns, busy seconds)."""
        self.buf.sort()
        cut = 0
        for cut, (t, _) in enumerate(self.buf + [(math.inf, 0.0)]):
            if t > now:
                break
        batch, self.buf = self.buf[:cut], self.buf[cut:]
        served = shed = 0
        samples: List[float] = []
        busy = 0.0
        slo_s = self.svc.slo_p99_ms / 1000.0
        free = self.free
        for t, svc_t in batch:
            if self.down or t < self.up_since:
                shed += 1
                continue
            start = heappop(free)
            if start < t:
                start = t
            fin = start + svc_t
            heappush(free, fin)
            lat = fin - t
            samples.append(lat)
            busy += svc_t
            served += 1
            if lat > slo_s:
                self.violations += 1
        self.requests += served
        self.shed += shed
        self.latencies.extend(samples)
        return served, shed, samples, busy


class ServingLayer:
    """All service replicas plus the per-node pinned-core accounting the
    engine's ``map_capacity`` subtracts, the per-tick latency/SLO fold,
    and the harvest decision loop."""

    def __init__(self, spec: ClusterSpec, seed: int, *,
                 sched=None, reconfig=None, trace=None) -> None:
        self.spec = spec
        self.serve = spec.serve
        self.sched = sched
        self.reconfig = reconfig
        self.trace = trace
        # harvest runs only when the policy declares the component *and*
        # the reconfigurator (which accounts it) is attached
        self.harvest_on = bool(getattr(sched, "harvest", False)
                               and reconfig is not None)
        self.replicas: List[ServiceReplica] = []
        self.reserved: List[int] = [0] * spec.num_nodes
        self.by_machine: Dict[int, List[ServiceReplica]] = {}
        self.last_tick = 0.0
        self.log: List[list] = []        # per-tick per-replica entries
        g = 0
        for svc in self.serve.services:
            for r in range(svc.replicas):
                machine = g % spec.num_machines
                node = (machine * spec.vms_per_machine
                        + (g // spec.num_machines) % spec.vms_per_machine)
                rep = ServiceReplica(svc, r, machine, node, seed)
                if self.reserved[node] + svc.vcpus > spec.base_map_slots:
                    raise ValueError(
                        f"service {svc.name!r} replica {r} oversubscribes "
                        f"VM {node}: {self.reserved[node]} + {svc.vcpus} "
                        f"pinned cores > base_map_slots="
                        f"{spec.base_map_slots}")
                self.reserved[node] += svc.vcpus
                self.replicas.append(rep)
                self.by_machine.setdefault(machine, []).append(rep)
                g += 1

    # -- churn-relief stand-down (read-only probe of the PR 8 signal) -------
    def _churn_relief(self) -> bool:
        s = self.sched
        adaptive = getattr(s, "adaptive", None)
        if adaptive is None or not adaptive.crash_discount:
            return False
        return bool(getattr(s, "_relief_sticky", False)
                    or getattr(s, "_machines_down", 0) > 0
                    or getattr(s, "_repend_debt", ()))

    # -- the serve tick ------------------------------------------------------
    def tick(self, now: float) -> None:
        interval = now - self.last_tick
        if interval <= 0.0:
            return
        relief = self.harvest_on and self._churn_relief()
        alpha = self.serve.harvest_util_alpha
        for rep in self.replicas:
            rep.gen_until(now)
            served, shed, samples, busy = rep.drain(now)
            cores = rep.cores
            util = busy / (cores * interval) if cores > 0 else 0.0
            if not rep.down:
                rep.util_ewma = (util if rep.util_ewma is None else
                                 alpha * util + (1.0 - alpha) * rep.util_ewma)
            if samples:
                from repro_torch.experiments.stats import percentile
                p50_ms = percentile(samples, 50.0) * 1000.0
                p99_ms = percentile(samples, 99.0) * 1000.0
            else:
                p50_ms = p99_ms = 0.0
            if self.harvest_on and not rep.down:
                self._harvest(rep, now, p99_ms, relief)
            self.log.append([now, rep.svc.name, rep.index, served, shed,
                             p50_ms, p99_ms,
                             rep.util_ewma if rep.util_ewma is not None
                             else 0.0, rep.cores])
            if self.trace is not None and self.trace.serve:
                self.trace.emit(now, "serve_tick", {
                    "service": rep.svc.name, "replica": rep.index,
                    "machine": rep.machine, "node": rep.node,
                    "served": served, "shed": shed,
                    "p50_ms": p50_ms, "p99_ms": p99_ms,
                    "slo_p99_ms": rep.svc.slo_p99_ms,
                    "util": util, "cores": rep.cores, "down": rep.down})
        self.last_tick = now

    # -- harvest (Borg-style core borrowing) ---------------------------------
    def _harvest(self, rep: ServiceReplica, now: float, p99_ms: float,
                 relief: bool) -> None:
        cfg = self.serve
        if relief:
            # churn relief: stand down — no borrowing, and give back one
            # borrowed core per tick until the service is whole again
            if rep.borrowed > 0:
                self._return_core(rep, now, "churn_relief")
            return
        if rep.borrowed > 0 and (
                (rep.util_ewma or 0.0) > cfg.harvest_return_util
                or p99_ms >= rep.svc.slo_p99_ms):
            # preemptive return on a load spike, before the whole-run p99
            # SLO is breached
            signal = ("util_spike"
                      if (rep.util_ewma or 0.0) > cfg.harvest_return_util
                      else "p99_pressure")
            self._return_core(rep, now, signal)
            return
        if (rep.cores > 1 and rep.free and rep.free[0] <= now
                and (rep.util_ewma or 0.0) < cfg.harvest_headroom):
            # an idle core under the headroom bar: lend it where the batch
            # side has demand — parked maps on this machine first
            if self.reconfig.aq[rep.machine]:
                signal = "parked_demand"
            elif getattr(self.sched, "total_pending_maps", 0) > 0:
                signal = "map_backlog"
            else:
                return
            self._borrow_core(rep, now, signal)

    def _borrow_core(self, rep: ServiceReplica, now: float,
                     signal: str) -> None:
        heappop(rep.free)                # the idle core leaves the queue
        rep.borrowed += 1
        rep.borrows += 1
        self.reserved[rep.node] -= 1
        self.reconfig.harvest_borrow(
            now, machine=rep.machine, node=rep.node, service=rep.svc.name,
            replica=rep.index, signal=signal,
            util=rep.util_ewma if rep.util_ewma is not None else 0.0,
            cores_left=rep.cores)

    def _return_core(self, rep: ServiceReplica, now: float,
                     signal: str) -> None:
        # the core rejoins the queue after the hot-plug latency; the batch
        # side stops launching on it immediately (map capacity drops now —
        # a map already running simply drains without replacement)
        heappush(rep.free, now + self.spec.hotplug_latency)
        rep.borrowed -= 1
        rep.returns += 1
        self.reserved[rep.node] += 1
        self.reconfig.harvest_return(
            now, machine=rep.machine, node=rep.node, service=rep.svc.name,
            replica=rep.index, signal=signal,
            util=rep.util_ewma if rep.util_ewma is not None else 0.0,
            cores_left=rep.cores)

    # -- chaos interaction ---------------------------------------------------
    def machine_down(self, machine: int, now: float) -> None:
        """A crashed machine drops its service replicas: queued and
        in-window arrivals shed, borrowed cores return immediately."""
        for rep in self.by_machine.get(machine, ()):
            while rep.borrowed > 0:
                self._return_core(rep, now, "machine_down")
            rep.down = True

    def machine_restarted(self, machine: int, now: float) -> None:
        for rep in self.by_machine.get(machine, ()):
            rep.down = False
            rep.up_since = now
            rep.free = [now] * rep.svc.vcpus
            rep.util_ewma = None

    # -- result fold ---------------------------------------------------------
    def outstanding_borrows(self) -> int:
        return sum(rep.borrowed for rep in self.replicas)

    def stats(self) -> Dict[str, object]:
        """Whole-run serving metrics: exact per-service p50/p99 over every
        request sample, SLO-violation counts, and harvest totals."""
        from repro_torch.experiments.stats import latency_summary
        services: Dict[str, Dict[str, object]] = {}
        all_lat: List[float] = []
        tot_req = tot_shed = tot_viol = tot_bor = tot_ret = 0
        for svc in self.serve.services:
            reps = [r for r in self.replicas if r.svc is svc]
            lat: List[float] = []
            for r in reps:
                lat.extend(r.latencies)
            summary = latency_summary(lat)
            util = [r.util_ewma for r in reps if r.util_ewma is not None]
            requests = sum(r.requests for r in reps)
            services[svc.name] = {
                "replicas": len(reps),
                "vcpus": svc.vcpus,
                "requests": requests,
                "shed": sum(r.shed for r in reps),
                "violations": sum(r.violations for r in reps),
                "violation_rate": (sum(r.violations for r in reps) / requests
                                   if requests else 0.0),
                "slo_p99_ms": svc.slo_p99_ms,
                "p50_ms": summary["p50"] * 1000.0,
                "p99_ms": summary["p99"] * 1000.0,
                "mean_ms": summary["mean"] * 1000.0,
                "util_ewma": sum(util) / len(util) if util else 0.0,
                "borrows": sum(r.borrows for r in reps),
                "returns": sum(r.returns for r in reps),
            }
            all_lat.extend(lat)
            tot_req += requests
            tot_shed += sum(r.shed for r in reps)
            tot_viol += sum(r.violations for r in reps)
            tot_bor += sum(r.borrows for r in reps)
            tot_ret += sum(r.returns for r in reps)
        summary = latency_summary(all_lat)
        return {
            "services": services,
            "requests": tot_req,
            "shed": tot_shed,
            "violations": tot_viol,
            "violation_rate": tot_viol / tot_req if tot_req else 0.0,
            "p50_ms": summary["p50"] * 1000.0,
            "p99_ms": summary["p99"] * 1000.0,
            "harvest_borrows": tot_bor,
            "harvest_returns": tot_ret,
            "outstanding_borrows": self.outstanding_borrows(),
        }
