"""Core datatypes of the paper's world, as the port's own copy of the JAX
package's ``core/types.py``: the workload profiles and job specs the traces
replay, the cluster shape with its adaptive, fault, serving and tracing
layers (``ClusterSpec``, whose ``to_dict`` is the cache identity of a sweep
cell and must stay byte-equal to the original's), and the event engine's
runtime types (``TaskKind``, ``TaskState``, ``TaskId``, ``JobRuntime``).
Pure Python; a test holds it to the original.  ``SlotDemand`` and
``ceil_at_least_one`` live in ``repro_torch.core.estimator``, which the
training launcher imports alone.
"""
from __future__ import annotations

import dataclasses
import enum
import functools
import heapq
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.core.estimator import SlotDemand


class TaskKind(enum.Enum):
    MAP = "map"
    REDUCE = "reduce"


class TaskState(enum.Enum):
    UNSTARTED = "unstarted"   # U^j in the paper
    RUNNING = "running"       # R^j
    COMPLETED = "completed"   # C^j


@dataclass(frozen=True)
class TaskId:
    job_id: str
    kind: TaskKind
    index: int

    def __str__(self) -> str:  # pragma: no cover - debug aid
        return f"{self.job_id}/{self.kind.value}{self.index}"


@dataclass
class WorkloadProfile:
    """Nominal execution characteristics of one MapReduce workload.

    The scheduler never reads these directly -- it estimates durations online
    from completed tasks (paper Eq. 1).  The *simulator* uses them as ground
    truth, optionally perturbed per-task.

    Attributes:
      name: workload name (wordcount, sort, grep, permutation, inverted_index).
      map_time: nominal seconds for one map task on a *data-local* node.
      reduce_time: nominal seconds for one reduce task (compute portion).
      shuffle_time_per_pair: ``t_s`` -- seconds for one mapper->reducer copy.
      remote_penalty: fractional slowdown of a map task reading its input
        block from a remote node (e.g. 0.45 => 45% slower).
      intermediate_ratio: bytes(intermediate)/bytes(input); drives the
        "reduce-input heavy" behaviour of Permutation Generator.
      time_cv: coefficient of variation for per-task duration jitter.
    """

    name: str
    map_time: float
    reduce_time: float
    shuffle_time_per_pair: float
    remote_penalty: float = 0.45
    intermediate_ratio: float = 1.0
    time_cv: float = 0.08

    def to_dict(self) -> Dict[str, object]:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "WorkloadProfile":
        return cls(**d)


@dataclass
class JobSpec:
    """A MapReduce job with a completion-time goal.

    ``u_m`` / ``v_r`` follow the paper's symbols (number of map / reduce
    tasks).  ``block_placement[i]`` lists the node ids that hold a replica of
    map task *i*'s input block.
    """

    job_id: str
    profile: WorkloadProfile
    u_m: int
    v_r: int
    deadline: float                      # D, seconds from submission
    submit_time: float = 0.0
    input_size_gb: float = 0.0
    block_placement: List[Tuple[int, ...]] = field(default_factory=list)

    def __post_init__(self) -> None:
        if self.u_m <= 0 or self.v_r <= 0:
            raise ValueError("jobs need at least one map and one reduce task")
        if self.deadline <= 0:
            raise ValueError("deadline must be positive")

    def to_dict(self) -> Dict[str, object]:
        # asdict introspects fields, so a future field cannot silently be
        # left out of the serialized form
        d = asdict(self)
        d["block_placement"] = [list(p) for p in d["block_placement"]]
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "JobSpec":
        d = dict(d)
        d["profile"] = WorkloadProfile.from_dict(d["profile"])
        d["block_placement"] = [tuple(p) for p in d["block_placement"]]
        return cls(**d)


@dataclass
class JobRuntime:
    """Mutable execution state of a job as seen by a scheduler.

    Tracks the paper's sets C^j (completed), R^j (running), U^j (unstarted)
    per phase, plus the observed durations that feed Eq. (1).

    The U^j sets are materialized incrementally: ``pending_map`` /
    ``pending_reduce`` hold the not-yet-started indices, and lazy min-heaps
    plus a per-node inverted index (``node -> pending local map ids``) answer
    "first unstarted task" and "first data-local task on this node" in
    amortized O(1) instead of rescanning ``range(u_m)``.  An index leaves the
    pending sets exactly once (task start); heap entries are discarded lazily
    on peek, so every index is popped from every heap at most once over the
    job's lifetime.
    """

    spec: JobSpec
    seq: int = 0                       # admission order, set by the scheduler
    completed_map: Set[int] = field(default_factory=set)
    running_map: Dict[int, int] = field(default_factory=dict)      # task -> node
    completed_reduce: Set[int] = field(default_factory=set)
    running_reduce: Dict[int, int] = field(default_factory=dict)
    map_durations: List[float] = field(default_factory=list)
    reduce_durations: List[float] = field(default_factory=list)
    map_duration_sum: float = 0.0
    reduce_duration_sum: float = 0.0
    demand: Optional[SlotDemand] = None
    finish_time: Optional[float] = None
    local_map_launches: int = 0
    remote_map_launches: int = 0
    reconfig_map_launches: int = 0     # launched data-local via Algorithm 1
    # flag mirrors of the map_finished / finished / started properties,
    # maintained by SchedulerBase at state transitions so scheduler hot
    # loops read a plain attribute instead of recomputing set sizes
    map_done: bool = field(default=False, repr=False)
    all_done: bool = field(default=False, repr=False)
    has_progress: bool = field(default=False, repr=False)
    pending_map: Set[int] = field(default_factory=set, repr=False)
    pending_reduce: Set[int] = field(default_factory=set, repr=False)
    _pending_map_heap: List[int] = field(default_factory=list, repr=False)
    _pending_reduce_heap: List[int] = field(default_factory=list, repr=False)
    _local_heaps: Dict[int, List[int]] = field(default_factory=dict, repr=False)

    def __post_init__(self) -> None:
        u, v = self.spec.u_m, self.spec.v_r
        self.pending_map = set(range(u))
        self.pending_reduce = set(range(v))
        # ascending ranges are already valid heaps
        self._pending_map_heap = list(range(u))
        self._pending_reduce_heap = list(range(v))
        self._local_heaps = {}
        for i, placement in enumerate(self.spec.block_placement[:u]):
            for node in set(placement):
                self._local_heaps.setdefault(node, []).append(i)

    # -- incremental-index queries (amortized O(1)) ----------------------
    def first_pending_map(self) -> Optional[int]:
        heap, pend = self._pending_map_heap, self.pending_map
        while heap:
            if heap[0] in pend:
                return heap[0]
            heapq.heappop(heap)
        return None

    def first_local_pending_map(self, node: int) -> Optional[int]:
        heap = self._local_heaps.get(node)
        if not heap:
            return None
        pend = self.pending_map
        while heap:
            if heap[0] in pend:
                return heap[0]
            heapq.heappop(heap)
        return None

    def first_pending_reduce(self) -> Optional[int]:
        heap, pend = self._pending_reduce_heap, self.pending_reduce
        while heap:
            if heap[0] in pend:
                return heap[0]
            heapq.heappop(heap)
        return None

    def mean_map_duration(self) -> Optional[float]:
        if not self.map_durations:
            return None
        return self.map_duration_sum / len(self.map_durations)

    # -- paper-set views -------------------------------------------------
    @property
    def unstarted_map(self) -> int:
        return self.spec.u_m - len(self.completed_map) - len(self.running_map)

    @property
    def unstarted_reduce(self) -> int:
        return self.spec.v_r - len(self.completed_reduce) - len(self.running_reduce)

    @property
    def map_finished(self) -> bool:
        return len(self.completed_map) == self.spec.u_m

    @property
    def finished(self) -> bool:
        return self.map_finished and len(self.completed_reduce) == self.spec.v_r

    @property
    def started(self) -> bool:
        """Paper Algorithm 2: jobs with no completed or running tasks get
        precedence so the estimator can bootstrap."""
        return bool(
            self.completed_map
            or self.running_map
            or self.completed_reduce
            or self.running_reduce
        )

    @property
    def absolute_deadline(self) -> float:
        return self.spec.submit_time + self.spec.deadline

    def locality_rate(self) -> float:
        launches = self.local_map_launches + self.remote_map_launches
        return self.local_map_launches / launches if launches else 0.0


@dataclass(frozen=True)
class AdaptiveConfig:
    """Pressure-adaptive reconfiguration policy (paper §4.1 extension).

    The paper's Algorithm 1 parks a non-local map task on the data node's
    machine with a *fixed* patience (``Reconfigurator.max_wait``) — a bet
    that "the target system will soon have a free core".  Under sustained
    saturation every VM keeps its freed cores for its own local work, the
    bet loses, and parked tasks starve (the regime atlas' diurnal/20x2
    loss cell).  When ``enabled``, the reconfigurator tracks per-machine
    core-pressure signals — queued donor-offer depth (valid RQ entries),
    the oldest AQ wait, and an EWMA of donor-offer intervals fed by the
    simulator's release events — and uses them to

    * **gate park admission**: when the predicted core wait exceeds the
      task's remote-launch break-even (``map_time x remote_penalty``,
      fabric-scaled), or the machine's recent parks keep ending in remote
      launches (fail streak), the task launches remotely immediately
      instead of parking;
    * **scale each park's patience**: a machine with no recent failure
      parks at the fixed ``max_wait``; one that lost a park since its last
      win (or a probe under the suspended win-rate floor) only earns
      ``max_wait_floor`` — every bound clamped to
      ``[max_wait_floor, max_wait_ceiling]``;
    * **suspend parking on starved machines**: ``fail_streak_limit``
      remote-ending park outcomes in a row suspend parking there until an
      offer arrives, a park pays off, or ``fail_cooldown`` quiet seconds
      earn a fresh probe;
    * **spread capacity under sustained overload**: when the queued map
      backlog exceeds ``overload_pending_factor x`` cluster map slots and
      active jobs outnumber ``overload_active_factor x`` machines (EDF
      priority then only serializes the drain tail), scheduling
      degenerates to the exact Fair assignment (deficit round-robin at
      task granularity, parking suspended), latched until the cluster
      fully drains.  The scheduler also tracks the set of active jobs
      already past their deadline (``overdue``) as an observable pressure
      signal.

    Defaults to **off** — with ``enabled=False`` the engine is bit-exact
    against the frozen legacy engine (pinned by the parity fuzz suite).
    """

    enabled: bool = False
    max_wait_floor: float = 4.0       # seconds; shortest per-park patience
    max_wait_ceiling: float = 45.0    # seconds; longest per-park patience
    ewma_alpha: float = 0.25          # weight of the newest observed interval
    breakeven_margin: float = 1.0     # park only if predicted <= margin x remote cost
    fail_streak_limit: int = 2        # remote-ending parks that suspend a machine
    fail_cooldown: float = 30.0       # quiet seconds before a suspended machine re-probes
    outcome_alpha: float = 0.12       # weight of the newest park outcome (cluster-wide)
    park_win_floor: float = 0.35      # suspend all parking when win-rate EWMA dips below
    # parking is only admitted while active jobs stay under
    # park_active_factor x machines AND the queued backlog averages at
    # least park_min_width pending maps per active job: narrow jobs (or a
    # crowd) put every parked map on its job's phase-critical path, while
    # wide jobs (the paper's closed mix) park for free — a parked map has
    # plenty of siblings to keep its job's map phase busy
    park_active_factor: float = 0.3
    park_min_width: float = 12.0
    # overload (fair-spread) mode enters when the map backlog reaches
    # pending_factor x cluster map slots AND active jobs reach
    # active_factor x machines, then latches until the cluster fully
    # drains (idle epoch reset)
    overload_pending_factor: float = 0.25
    overload_active_factor: float = 0.5
    # win-aware latch + churn-proof gates.  A backlog averaging at least
    # surge_width pending maps per map-open job is a *healthy wide batch*
    # (the paper's closed-mix regime, or churn re-pending lost work), not
    # the many-small-jobs surge the latch exists for: the latch neither
    # trips on one nor holds through one (release cause "win_release",
    # vetoed while the park win-rate EWMA sits under park_win_floor), and
    # the crowd bar stops suppressing park admission.  0 disables (the
    # pre-PR-8 latch/crowd behavior).
    surge_width: float = 16.0
    # park losses whose remote launch was forced by a crash (every live
    # replica of the task down) are discounted from the fail-streak and
    # win-rate gates — churn must not read as park starvation
    crash_discount: bool = True
    # offer/core-free EWMA samples are clamped to gap_cap x the running
    # mean: an interval spanning a restart gap (or any long disruption)
    # must not inflate the predicted core wait for the whole next epoch.
    # 0 disables the cap.
    ewma_gap_cap: float = 4.0

    def __post_init__(self) -> None:
        if self.max_wait_floor < 0:
            raise ValueError("max_wait_floor must be non-negative")
        if self.max_wait_ceiling < self.max_wait_floor:
            raise ValueError("max_wait_ceiling must be >= max_wait_floor")
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError("ewma_alpha must be in (0, 1]")
        if self.breakeven_margin <= 0:
            raise ValueError("breakeven_margin must be positive")
        if self.fail_streak_limit < 1:
            raise ValueError("fail_streak_limit must be >= 1")
        if self.fail_cooldown < 0:
            raise ValueError("fail_cooldown must be non-negative")
        if not 0.0 < self.outcome_alpha <= 1.0:
            raise ValueError("outcome_alpha must be in (0, 1]")
        if not 0.0 <= self.park_win_floor <= 1.0:
            raise ValueError("park_win_floor must be in [0, 1]")
        if self.park_active_factor <= 0:
            raise ValueError("park_active_factor must be positive")
        if self.park_min_width < 0:
            raise ValueError("park_min_width must be non-negative")
        if self.overload_pending_factor <= 0 or self.overload_active_factor <= 0:
            raise ValueError("overload entry factors must be positive")
        if self.surge_width < 0:
            raise ValueError("surge_width must be non-negative")
        if self.ewma_gap_cap < 0:
            raise ValueError("ewma_gap_cap must be non-negative")

    def to_dict(self) -> Dict[str, object]:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "AdaptiveConfig":
        return cls(**d)


#: field defaults looked up by ClusterSpec.to_dict when deciding which
#: adaptive knobs to omit for cache compatibility (kept next to the class
#: so a default change cannot silently diverge from the omission rule)
_ADAPTIVE_FIELD_DEFAULTS: Dict[str, object] = {
    f.name: f.default for f in dataclasses.fields(AdaptiveConfig)}


@dataclass(frozen=True)
class MachineClass:
    """One hardware generation in a heterogeneous fleet.

    Machines are assigned to classes round-robin over the weight-expanded
    pattern (weights 3,1 -> m % 4 in {0,1,2} is class 0), so any fleet size
    gets the requested mix deterministically.

    Attributes:
      name: label for logs/atlas columns.
      weight: relative share of machines in this class (>= 1).
      speed: task-duration multiplier on this class (> 1 = slower
        hardware generation; scales map *and* reduce compute).
      fabric: remote-read-penalty multiplier for map tasks running on this
        class (NIC/uplink generation; composes with
        ``ClusterSpec.remote_penalty_scale``).
      mtbf_scale: crash-rate multiplier — this class's mean time between
        failures is ``FaultConfig.crash_mtbf * mtbf_scale`` (older
        generations fail more often: ``mtbf_scale < 1``).
    """

    name: str = "base"
    weight: int = 1
    speed: float = 1.0
    fabric: float = 1.0
    mtbf_scale: float = 1.0

    def __post_init__(self) -> None:
        if self.weight < 1:
            raise ValueError("machine-class weight must be >= 1")
        if self.speed <= 0:
            raise ValueError("machine-class speed must be positive")
        if self.fabric < 0:
            raise ValueError("machine-class fabric must be non-negative")
        if self.mtbf_scale <= 0:
            raise ValueError("machine-class mtbf_scale must be positive")

    def to_dict(self) -> Dict[str, object]:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "MachineClass":
        return cls(**d)


_BASE_CLASS = MachineClass()


@dataclass(frozen=True)
class FaultConfig:
    """Fault-injection + heterogeneity layer for the simulated fleet.

    Default **off** — with ``enabled=False`` every knob is inert: the
    engine is bit-exact against the frozen legacy engine (pinned by the
    parity fuzz suite, which fuzzes *disabled* configs), and the config is
    omitted from ``ClusterSpec.to_dict`` so every pre-fault sweep-cache
    hash and pair key is untouched.

    When enabled, ``ClusterSim`` drives deterministic fault processes from
    per-machine RNG streams seeded by (sim seed, machine) only — the
    crash/restart schedule is a pure function of (config, seed),
    independent of scheduler decisions (pinned by the determinism test):

    * **node churn** — each machine crashes after Exp(mtbf) up-time
      (class-scaled) and restarts after Exp(mttr) down-time; running tasks
      on its VMs are lost and re-enqueued against surviving replicas;
    * **re-replication** — a machine down longer than the grace window
      gets its pending blocks re-replicated (from the durable store) onto
      a surviving node, restoring locality after the window;
    * **straggler bursts** — correlated slowdown episodes per machine
      (every task launched on a bursting machine is slowed), instead of
      the i.i.d. per-task ``straggler_prob``;
    * **heterogeneous machine classes** — per-class duration/fabric
      multipliers threaded through ``task_duration`` and the
      reconfigurator's park break-even bar.
    """

    enabled: bool = False
    # -- node churn (0 = no crashes even when enabled) -------------------
    crash_mtbf: float = 0.0       # mean seconds of up-time per machine
    crash_mttr: float = 90.0      # mean seconds of down-time per crash
    crash_warmup: float = 0.0     # no crashes before this sim time
    # -- re-replication ---------------------------------------------------
    rereplicate_after: float = 60.0   # grace window before blocks re-home
    # -- correlated straggler bursts (0 = off) ----------------------------
    burst_rate: float = 0.0       # mean seconds between episodes per machine
    burst_duration: float = 30.0  # seconds one episode lasts
    burst_slowdown: float = 2.5   # duration multiplier while bursting
    # -- heterogeneity (() = homogeneous fleet) ---------------------------
    machine_classes: Tuple[MachineClass, ...] = ()

    def __post_init__(self) -> None:
        if self.crash_mtbf < 0:
            raise ValueError("crash_mtbf must be non-negative")
        if self.crash_mttr <= 0:
            raise ValueError("crash_mttr must be positive")
        if self.crash_warmup < 0:
            raise ValueError("crash_warmup must be non-negative")
        if self.rereplicate_after < 0:
            raise ValueError("rereplicate_after must be non-negative")
        if self.burst_rate < 0:
            raise ValueError("burst_rate must be non-negative")
        if self.burst_duration <= 0:
            raise ValueError("burst_duration must be positive")
        if self.burst_slowdown < 1.0:
            raise ValueError("burst_slowdown must be >= 1")
        if not isinstance(self.machine_classes, tuple):
            object.__setattr__(self, "machine_classes",
                               tuple(self.machine_classes))

    @property
    def active(self) -> bool:
        """Any fault process actually running (vs. enabled-but-all-off)."""
        return self.enabled and (self.crash_mtbf > 0 or self.burst_rate > 0
                                 or bool(self.machine_classes))

    def machine_class(self, machine: int) -> MachineClass:
        """Class of physical machine ``machine`` (round-robin over the
        weight-expanded class pattern); the base class when disabled or
        homogeneous."""
        if not (self.enabled and self.machine_classes):
            return _BASE_CLASS
        pattern = _class_pattern(self.machine_classes)
        return pattern[machine % len(pattern)]

    def to_dict(self) -> Dict[str, object]:
        d = asdict(self)
        d["machine_classes"] = [asdict(c) for c in self.machine_classes]
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "FaultConfig":
        d = dict(d)
        d["machine_classes"] = tuple(
            MachineClass.from_dict(c) if isinstance(c, dict) else c
            for c in d.get("machine_classes", ()))
        return cls(**d)


@functools.lru_cache(maxsize=None)
def _class_pattern(classes: Tuple[MachineClass, ...]
                   ) -> Tuple[MachineClass, ...]:
    pattern: List[MachineClass] = []
    for c in classes:
        pattern.extend([c] * c.weight)
    return tuple(pattern)


@dataclass(frozen=True)
class ServiceSpec:
    """One long-lived latency-sensitive service co-located with the batch
    workload.

    Each replica pins ``vcpus`` cores on one VM (replicas are spread over
    the fleet round-robin) and receives an open-arrival request stream —
    a non-homogeneous Poisson process with the same diurnal/flash-crowd
    shape as ``repro_torch.simcluster.traces.ArrivalConfig``, drawn from a
    dedicated per-replica RNG stream (zero draws from the decision RNG).

    Attributes:
      name: service label (also part of the RNG stream key).
      replicas: service instances; each lives on one VM.
      vcpus: cores pinned per replica (the batch side loses this much map
        capacity on the host VM; harvesting may borrow all but one back).
      base_rps: mean request arrival rate per replica (requests/second).
      diurnal_amplitude/diurnal_period/diurnal_phase: sinusoidal load
        modulation, ``rate(t) = base_rps * (1 + A sin(2 pi (t+phase)/T))``.
      burst_prob: per base arrival, chance of a flash crowd riding on it.
      burst_size_mean: mean extra requests per flash crowd (geometric).
      burst_stagger: mean spacing (s) of flash-crowd arrivals.
      service_time: mean seconds one request occupies one core (exponential).
      slo_p99_ms: per-request latency SLO; a request whose sojourn exceeds
        this counts as an SLO violation.
    """

    name: str = "svc"
    replicas: int = 2
    vcpus: int = 1
    base_rps: float = 10.0
    diurnal_amplitude: float = 0.0
    diurnal_period: float = 3600.0
    diurnal_phase: float = 0.0
    burst_prob: float = 0.0
    burst_size_mean: float = 8.0
    burst_stagger: float = 0.05
    service_time: float = 0.02
    slo_p99_ms: float = 250.0

    def __post_init__(self) -> None:
        if not self.name:
            raise ValueError("service name must be non-empty")
        if self.replicas < 1:
            raise ValueError("service replicas must be >= 1")
        if self.vcpus < 1:
            raise ValueError("service vcpus must be >= 1")
        if self.base_rps <= 0:
            raise ValueError("base_rps must be positive")
        if not 0.0 <= self.diurnal_amplitude < 1.0:
            raise ValueError("diurnal_amplitude must be in [0, 1)")
        if self.diurnal_period <= 0:
            raise ValueError("diurnal_period must be positive")
        if not 0.0 <= self.burst_prob < 1.0:
            raise ValueError("burst_prob must be in [0, 1)")
        if self.burst_size_mean < 1.0:
            raise ValueError("burst_size_mean must be >= 1")
        if self.burst_stagger <= 0:
            raise ValueError("burst_stagger must be positive")
        if self.service_time <= 0:
            raise ValueError("service_time must be positive")
        if self.slo_p99_ms <= 0:
            raise ValueError("slo_p99_ms must be positive")

    def to_dict(self) -> Dict[str, object]:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "ServiceSpec":
        return cls(**d)


@dataclass(frozen=True)
class ServeConfig:
    """Multi-tenant serving layer: latency-SLO services co-located with
    the batch MapReduce workload on one reconfigurable fleet.

    Default **off** — with ``enabled=False`` (or no services) the layer is
    never constructed, zero RNG draws happen, the engine stays bit-exact
    against the frozen legacy engine (the parity fuzz suite carries
    disabled-but-wild serving knobs through the sweep), and the config is
    omitted from ``ClusterSpec.to_dict`` so every sweep-cache hash and
    pair key is untouched — exactly like ``FaultConfig``/``TraceConfig``.

    When active, ``ClusterSim`` pins each replica's vcpus on its host VM
    (reducing batch map capacity there), drives per-replica request
    streams from dedicated ``f"{seed}:serve:{service}:{replica}"`` RNG
    streams, and folds per-request queueing into p50/p99 latency and
    SLO-violation counters each serve tick.  The harvest knobs govern the
    Borg-style core-harvesting component (``PolicySpec`` axis
    ``harvest``): a replica whose utilization EWMA sits below
    ``harvest_headroom`` may lend all but one pinned core to the batch
    side; cores are returned preemptively when the EWMA crosses
    ``harvest_return_util`` or the tick's p99 reaches the SLO.
    """

    enabled: bool = False
    services: Tuple[ServiceSpec, ...] = ()
    # -- harvest component knobs (inert unless the policy enables it) -----
    harvest_headroom: float = 0.55     # borrow only below this util EWMA
    harvest_return_util: float = 0.85  # return preemptively above this
    harvest_util_alpha: float = 0.3    # utilization EWMA weight
    # atlas guard: max tolerated fraction of requests over their p99 SLO
    slo_violation_bound: float = 0.02

    def __post_init__(self) -> None:
        if not 0.0 < self.harvest_headroom < 1.0:
            raise ValueError("harvest_headroom must be in (0, 1)")
        if self.harvest_return_util <= self.harvest_headroom:
            raise ValueError("harvest_return_util must be > harvest_headroom")
        if not 0.0 < self.harvest_util_alpha <= 1.0:
            raise ValueError("harvest_util_alpha must be in (0, 1]")
        if not 0.0 <= self.slo_violation_bound <= 1.0:
            raise ValueError("slo_violation_bound must be in [0, 1]")
        if not isinstance(self.services, tuple):
            object.__setattr__(self, "services", tuple(self.services))
        names = [s.name for s in self.services]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate service names: {names}")

    @property
    def active(self) -> bool:
        """Any service actually running (vs. enabled-but-empty)."""
        return self.enabled and bool(self.services)

    def to_dict(self) -> Dict[str, object]:
        d = asdict(self)
        d["services"] = [asdict(s) for s in self.services]
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "ServeConfig":
        d = dict(d)
        d["services"] = tuple(
            ServiceSpec.from_dict(s) if isinstance(s, dict) else s
            for s in d.get("services", ()))
        return cls(**d)


@dataclass(frozen=True)
class TraceConfig:
    """Decision-trace bus configuration (``repro_torch.core.tracing``).

    Default **off** — with ``enabled=False`` no bus is created, every
    emission site is a single ``is None`` guard, zero RNG draws happen,
    and the config is omitted from ``ClusterSpec.to_dict`` so every
    sweep-cache hash and pair key is untouched (the fuzz suite carries
    disabled-but-wild trace knobs through the parity sweep, exactly like
    ``AdaptiveConfig``/``FaultConfig`` before it).

    When enabled, ``ClusterSim`` wires one ``TraceBus`` through itself,
    the scheduler and the reconfigurator; the category switches select
    which record families are emitted:

    * ``launches`` — task ``launch``/``finish`` records (local/remote,
      speculative, via-reconfig) plus ``job_submit``/``job_finish`` and
      crash ``kill`` records;
    * ``parks`` — the Algorithm-1 decision trail: ``park_admit``,
      ``park_deny`` (with the failing gate named), ``park_outcome``,
      ``reconfig_match``, ``unpark``, ``park_expired``, ``park_crashed``;
    * ``overload`` — ``latch_trip``/``latch_release`` with the triggering
      counters;
    * ``faults`` — full-context twins of the ``fault_log`` entries
      (crash/restart/burst/re-replication);
    * ``pressure_every`` — seconds between cluster ``pressure`` snapshots
      (EWMAs, fail streaks, rq depth, map_open_jobs); 0 disables them.

    ``max_events`` bounds retained records (the per-kind counters keep
    counting past it; overflow is reported in ``TraceBus.dropped``).
    """

    enabled: bool = False
    launches: bool = True
    parks: bool = True
    overload: bool = True
    faults: bool = True
    # serving/harvest records: ``harvest_borrow``/``harvest_return`` (with
    # the triggering signal named) plus per-tick ``serve_tick`` snapshots
    serve: bool = True
    pressure_every: float = 0.0
    max_events: int = 1_000_000

    def __post_init__(self) -> None:
        if self.pressure_every < 0:
            raise ValueError("pressure_every must be non-negative")
        if self.max_events < 0:
            raise ValueError("max_events must be non-negative")

    def to_dict(self) -> Dict[str, object]:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "TraceConfig":
        return cls(**d)


@dataclass(frozen=True)
class ClusterSpec:
    """Static shape of the virtualized cluster (paper §5: 20 machines,
    2 map + 2 reduce slots per node)."""

    num_machines: int = 20
    vms_per_machine: int = 2
    base_map_slots: int = 2        # per VM
    base_reduce_slots: int = 2     # per VM
    max_vcpus_per_vm: int = 6      # hot-plug ceiling
    min_vcpus_per_vm: int = 1      # never unplug below this
    replication: int = 3           # HDFS default
    heartbeat_interval: float = 3.0   # paper: "Usually the heartbeat interval is 3s"
    hotplug_latency: float = 0.5      # seconds for a vCPU assign/release
    # network-fabric calibration: scales every profile's remote-read penalty
    # (1.0 = the paper's 2012 shared 1GbE; ~0.25 = 10GbE; ~0.0625 = 40GbE)
    remote_penalty_scale: float = 1.0
    adaptive: AdaptiveConfig = AdaptiveConfig()
    faults: FaultConfig = FaultConfig()
    serve: ServeConfig = ServeConfig()
    tracing: TraceConfig = TraceConfig()

    @property
    def num_nodes(self) -> int:
        return self.num_machines * self.vms_per_machine

    def machine_of(self, node: int) -> int:
        return node // self.vms_per_machine

    def machine_class(self, machine: int) -> MachineClass:
        """Hardware class of physical machine ``machine`` (heterogeneous
        fleets live on ``FaultConfig``; the base class otherwise)."""
        return self.faults.machine_class(machine)

    def to_dict(self) -> Dict[str, object]:
        # asdict introspects fields: the experiment cache hashes this dict,
        # so a hand-maintained list that went stale would alias genuinely
        # different clusters onto one cache cell
        d = asdict(self)
        if self.faults == FaultConfig():
            # cache compatibility: a default (disabled) fault layer is
            # omitted so pre-fault sweep caches, pair keys and the pinned
            # cell hashes in tests/test_policies.py are byte-identical
            del d["faults"]
        else:
            d["faults"] = self.faults.to_dict()
        if self.serve == ServeConfig():
            # same contract for the serving layer: serving-off is invisible
            del d["serve"]
        else:
            d["serve"] = self.serve.to_dict()
        # tracing is a pure observer: results are bit-identical with it
        # on or off, so it is *always* omitted — a traced replay of a
        # cached cell must hash onto the same cache entry
        del d["tracing"]
        # cache compatibility for the PR-8 bugfix knobs: at their default
        # values they are omitted, so the pinned adaptive cell hashes in
        # tests/test_policies.py (and pre-existing sweep caches) keep
        # their keys — the fixed behavior is the bugfix semantics of
        # those cells, not a new cell identity.  Non-default values (e.g.
        # the surge_width=0 ablation) still hash distinctly.
        for knob in ("surge_width", "crash_discount", "ewma_gap_cap"):
            if getattr(self.adaptive, knob) == _ADAPTIVE_FIELD_DEFAULTS[knob]:
                del d["adaptive"][knob]
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "ClusterSpec":
        d = dict(d)
        if isinstance(d.get("adaptive"), dict):
            d["adaptive"] = AdaptiveConfig.from_dict(d["adaptive"])
        if isinstance(d.get("faults"), dict):
            d["faults"] = FaultConfig.from_dict(d["faults"])
        if isinstance(d.get("serve"), dict):
            d["serve"] = ServeConfig.from_dict(d["serve"])
        if isinstance(d.get("tracing"), dict):
            d["tracing"] = TraceConfig.from_dict(d["tracing"])
        return cls(**d)
