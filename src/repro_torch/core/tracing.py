"""Decision-trace bus: attributed scheduler telemetry.

This is the port's own copy of the JAX package's ``core/tracing.py`` (pure
Python; a test holds a traced run's canonical stream byte-equal to the
original's).

The simulator's only introspection used to be a bare ``fault_log`` list of
``(time, kind, machine)`` tuples.  This module adds a structured,
default-off event bus that the sim, the scheduler and the reconfigurator
all share, so a single run can answer *why* questions: why was this map
launched remote, which Algorithm-1 gate denied this park, what tripped
the overload latch and what (if anything) released it.

Design contracts (enforced by tests/test_tracing.py and the parity fuzz):

* **Observer only.**  A ``TraceBus`` draws from no RNG and mutates no
  simulation state; every emission site is guarded by a single
  ``trace is not None`` check, so tracing-off is bit-exact against the
  untraced engine and tracing-on changes nothing but the bus.
* **Bounded.**  ``TraceConfig.max_events`` caps retained records; the
  per-kind counters keep counting past the cap and the overflow is
  visible in :attr:`TraceBus.dropped`.
* **One schema for faults and decisions.**  ``fault_log`` entries are
  :class:`FaultEvent` named tuples now — they serialize (via
  ``json.dumps``) byte-identically to the old bare tuples, compare equal
  to them, and unpack the same way, so the byte-reproducibility pins in
  tests/test_faults.py (and the port's copies of them) hold while the same events also appear on the bus
  with full context.
"""

from __future__ import annotations

import json
from typing import Dict, Iterator, List, NamedTuple, Tuple

from repro_torch.core.types import TaskId, TraceConfig


class FaultEvent(NamedTuple):
    """A ``fault_log`` entry: the typed twin of the legacy tuple.

    NamedTuple keeps byte-compatibility: ``json.dumps`` renders it as the
    same ``[time, "kind", machine]`` array, ``==`` against old tuples
    holds, and ``for t, kind, m in sim.fault_log`` still unpacks.
    """

    time: float
    kind: str      # "crash" | "restart" | "burst" | "rereplicate"
    machine: int


# Algorithm-1 park gates, in the order the scheduler evaluates them.
# ``park_deny`` records carry exactly one of these in their ``gate`` field.
PARK_GATES: Tuple[str, ...] = (
    "parking_off",        # scheduler built with parking disabled
    "no_park",            # task already expired out of a queue once
    "deadline_critical",  # slack under 3x the parking wait bound
    "remote_fill",        # phase-3 backfill: parking not offered at all
    "overload_latch",     # latched overload mode: parking suspended
    "crowd_bar",          # adaptive crowd bar (unlatched; wide batches exempt)
    "replicas_down",      # every replica holder is crashed
    "aq_saturated",       # anticipation queue at park_depth on the target
    "width_gate",         # pending maps too narrow vs open map jobs
    "fail_streak",        # reconfigurator: consecutive-loss circuit breaker
    "predicted_wait",     # reconfigurator: EWMA wait forecast > breakeven
    "win_floor",          # reconfigurator: park win-rate EWMA under floor
)

# Causes a latch_release record can carry: the adaptive overload latch's
# exit vocabulary (see CompletionTimeScheduler._overload_check).
LATCH_RELEASE_CAUSES: Tuple[str, ...] = (
    "empty_cluster",      # a new job found a fully-drained cluster
    "cluster_drained",    # no active job left
    "maps_drained",       # reduce_aware: map backlog fully drained
    "churn_drain",        # faults: empty backlog mid-churn ends the epoch
    "churn_relief",       # faults: fleet degraded / crash-lost maps still
                          # re-pending — churn, not overload; park
                          # admission reverts to the fixed policy's gates
    "win_release",        # win-aware: backlog became a wide batch — parking
                          # wins there, exact-Fair would surrender them
)

# Causes a park_outcome record can carry (reconfigurator feedback loop).
PARK_OUTCOME_CAUSES: Tuple[str, ...] = (
    "reservation",        # won: launched data-locally via its AQ reservation
    "donor_match",        # won: launched through a donor-core hot-plug
    "remote",             # lost: burned its patience, launched remotely
    "crash_discount",     # discounted: remote launch forced by a crash
                          # (every live replica down) — gates not charged
)

# Signals a harvest_borrow / harvest_return record can carry (serving
# layer decision loop; see repro_torch.simcluster.serving).
HARVEST_SIGNALS: Tuple[str, ...] = (
    "parked_demand",      # borrow: parked maps wait on this machine's AQ
    "map_backlog",        # borrow: cluster-wide pending maps, util is low
    "util_spike",         # return: utilization EWMA over the return bar
    "p99_pressure",       # return: tick p99 reached the SLO — preempt
    "churn_relief",       # return: harvesting stands down under churn
    "machine_down",       # return: the host machine crashed
)

# Every record kind the bus can carry, grouped by TraceConfig switch.
EVENT_KINDS: Dict[str, Tuple[str, ...]] = {
    "launches": ("job_submit", "job_finish", "launch", "finish", "kill"),
    "parks": ("park_admit", "park_deny", "park_outcome", "reconfig_match",
              "unpark", "park_expired", "park_crashed"),
    "overload": ("latch_trip", "latch_release"),
    "faults": ("crash", "restart", "burst", "rereplicate"),
    "serve": ("serve_tick", "harvest_borrow", "harvest_return"),
    "pressure": ("pressure",),
}


def dumps_canonical(obj: object) -> str:
    """Canonical JSON: sorted keys, no whitespace — byte-stable across
    runs so traces can be diffed and hashed."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


class TraceBus:
    """Append-only event sink shared by sim, scheduler and reconfigurator.

    ``emit`` is deliberately tiny (a dict increment plus a bounded list
    append of a plain tuple) because it sits on the task launch/finish
    hot path when tracing is enabled; the ≤10% events/sec overhead gate
    in scripts/check.sh holds it to that.
    """

    __slots__ = ("config", "launches", "parks", "overload", "faults",
                 "serve", "pressure_every", "max_events", "events", "counts",
                 "dropped")

    def __init__(self, config: TraceConfig) -> None:
        self.config = config
        # per-category booleans are precomputed so emission sites test a
        # plain attribute, not a dataclass field chain
        self.launches = config.launches
        self.parks = config.parks
        self.overload = config.overload
        self.faults = config.faults
        self.serve = config.serve
        self.pressure_every = config.pressure_every
        self.max_events = config.max_events
        self.events: List[Tuple[float, str, Dict[str, object]]] = []
        self.counts: Dict[str, int] = {}
        self.dropped = 0

    def emit(self, t: float, kind: str, data: Dict[str, object]) -> None:
        counts = self.counts
        counts[kind] = counts.get(kind, 0) + 1
        if len(self.events) < self.max_events:
            self.events.append((t, kind, data))
        else:
            self.dropped += 1

    def count(self, kind: str) -> int:
        return self.counts.get(kind, 0)

    @property
    def total(self) -> int:
        return sum(self.counts.values())

    def records(self) -> Iterator[Dict[str, object]]:
        """Flattened dict view of every retained event, in emission
        order.  ``t`` and ``kind`` are reserved keys; payload fields must
        not collide with them (enforced here, not trusted).  Emission
        sites store raw ``TaskId`` objects (stringifying ~10^4 ids would
        sit on the launch hot path); they render canonically here."""
        for t, kind, data in self.events:
            rec: Dict[str, object] = {"t": t, "kind": kind}
            for k, v in data.items():
                if k not in ("t", "kind"):
                    rec[k] = str(v) if isinstance(v, TaskId) else v
            yield rec

    def to_jsonl(self) -> str:
        """Canonical JSONL: one sorted-key record per line."""
        return "".join(dumps_canonical(r) + "\n" for r in self.records())
