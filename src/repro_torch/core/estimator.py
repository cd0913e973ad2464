"""Resource estimation model — paper §2.2, Eqs. (1)–(10): the Resource
Predictor, as the port's own copy of the JAX package's ``core/estimator.py``,
with ``SlotDemand`` and ``ceil_at_least_one`` from its ``core/types.py``
(the training launcher imports ``min_slots`` from here without the event
engine's types).  Pure Python; a test holds it to the original.

Given a job with ``u_m`` map tasks of mean duration ``t_m``, ``v_r`` reduce
tasks of duration ``t_r``, per mapper→reducer copy time ``t_s`` and deadline
``D``, the completion-time model (Eq. 7) is

    u_m·t_m / n_m  +  v_r·t_r / n_r  +  u_m·v_r·t_s  <=  D

and the *minimum total* slot allocation meeting it is the Lagrange-multiplier
solution (Eq. 10) of  min (n_m + n_r)  s.t.  A/n_m + B/n_r = C:

    A = u_m·t_m ;  B = v_r·t_r ;  C = D − u_m·v_r·t_s
    n_m = √A(√A+√B)/C ;  n_r = √B(√A+√B)/C

Task durations are estimated online from the completed-task sample mean
(Eq. 1) and re-estimated on every task completion (Algorithm 2 lines 17–20).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import TYPE_CHECKING, Optional, Sequence

if TYPE_CHECKING:
    from repro_torch.core.types import JobRuntime


@dataclass
class SlotDemand:
    """Output of the resource estimator: Eq. (10) of the paper."""

    n_m: int      # minimum map slots
    n_r: int      # minimum reduce slots
    feasible: bool
    # Raw (continuous) Lagrange solution, for analysis / tests.
    n_m_cont: float = float("nan")
    n_r_cont: float = float("nan")


def ceil_at_least_one(x: float) -> int:
    """Ceil to int, but always demand at least one slot."""
    if not math.isfinite(x) or x <= 0:
        return 1
    return max(1, int(math.ceil(x - 1e-9)))


def mean_task_length(durations: Sequence[float]) -> Optional[float]:
    """Eq. (1): mean completed task length; None when no sample exists."""
    if not durations:
        return None
    return sum(durations) / len(durations)


def min_slots(
    u_m: int,
    v_r: int,
    t_m: float,
    t_r: float,
    t_s: float,
    deadline: float,
    *,
    max_map_slots: Optional[int] = None,
    max_reduce_slots: Optional[int] = None,
) -> SlotDemand:
    """Closed-form Eq. (10).

    When the shuffle term alone exceeds the deadline (C <= 0) the job is
    infeasible under the model: no finite slot count meets D.  It then
    demands the cluster caps (or a large sentinel) and flags
    ``feasible=False`` — the scheduler treats such jobs as "give it
    everything EDF allows"."""
    if u_m <= 0 or v_r <= 0:
        raise ValueError("u_m and v_r must be positive")
    if t_m < 0 or t_r < 0 or t_s < 0:
        raise ValueError("task durations must be non-negative")

    a = u_m * t_m
    b = v_r * t_r
    c = deadline - (u_m * v_r) * t_s

    if c <= 0 or (a == 0 and b == 0):
        n_m = max_map_slots if max_map_slots is not None else u_m
        n_r = max_reduce_slots if max_reduce_slots is not None else v_r
        feasible = a == 0 and b == 0 and c >= 0
        return SlotDemand(
            n_m=max(1, n_m),
            n_r=max(1, n_r),
            feasible=feasible,
            n_m_cont=float("inf") if not feasible else 0.0,
            n_r_cont=float("inf") if not feasible else 0.0,
        )

    sa, sb = math.sqrt(a), math.sqrt(b)
    n_m_cont = sa * (sa + sb) / c
    n_r_cont = sb * (sa + sb) / c

    n_m = ceil_at_least_one(n_m_cont)
    n_r = ceil_at_least_one(n_r_cont)

    # A job never benefits from more slots than it has tasks.
    n_m = min(n_m, u_m)
    n_r = min(n_r, v_r)

    feasible = True
    if max_map_slots is not None and n_m > max_map_slots:
        n_m, feasible = max_map_slots, False
    if max_reduce_slots is not None and n_r > max_reduce_slots:
        n_r, feasible = max_reduce_slots, False
    return SlotDemand(
        n_m=n_m, n_r=n_r, feasible=feasible, n_m_cont=n_m_cont, n_r_cont=n_r_cont
    )


def completion_time(
    u_m: int, v_r: int, t_m: float, t_r: float, t_s: float, n_m: int, n_r: int
) -> float:
    """Eq. (7) left-hand side: modeled completion time for an allocation."""
    return (u_m * t_m) / n_m + (v_r * t_r) / n_r + (u_m * v_r) * t_s


@dataclass
class EstimatorConfig:
    """Knobs for the online estimator.

    ``assume_tr_equals_tm`` is paper Eq. (3) (homogeneous cluster).  When
    False we refine t_r with the reduce-task sample mean once one exists —
    the paper notes the scheduler "cannot make assumptions about the Reduce
    phase before seeing some Reduce tasks completing", so the bootstrap is
    always Eq. (3).
    """

    assume_tr_equals_tm: bool = True
    default_shuffle_time: float = 0.01   # t_s prior before any shuffle sample


class OnlineEstimator:
    """Per-job online resource estimator (Algorithm 2 lines 17–20).

    Re-computes Eq. (10) with the *remaining* work and *remaining* time:
    as the deadline gets nearer the demanded slot counts rise — this is the
    paper's "as time progresses and the job deadline gets nearer, the
    introduced mechanism re-computes the number of resources required".
    """

    def __init__(self, config: EstimatorConfig | None = None):
        self.config = config or EstimatorConfig()

    # -- duration estimates ------------------------------------------------
    def t_m(self, job: JobRuntime) -> Optional[float]:
        return mean_task_length(job.map_durations)

    def t_r(self, job: JobRuntime) -> Optional[float]:
        if not self.config.assume_tr_equals_tm and job.reduce_durations:
            return mean_task_length(job.reduce_durations)
        return self.t_m(job)   # Eq. (3)

    def t_s(self, job: JobRuntime) -> float:
        return job.spec.profile.shuffle_time_per_pair if job.spec.profile else (
            self.config.default_shuffle_time
        )

    # -- demand -------------------------------------------------------------
    def demand(
        self,
        job: JobRuntime,
        now: float,
        *,
        max_map_slots: Optional[int] = None,
        max_reduce_slots: Optional[int] = None,
        remaining_work: bool = True,
    ) -> Optional[SlotDemand]:
        """Eq. (10) demand; None while no map sample exists (bootstrap phase).

        With ``remaining_work`` (the scheduler's mode) the counts are the
        not-yet-completed tasks and the deadline is the time left; with
        ``remaining_work=False`` it is the submission-time estimate used for
        Table 2.
        """
        t_m = self.t_m(job)
        if t_m is None:
            return None
        t_r = self.t_r(job)
        assert t_r is not None
        t_s = self.t_s(job)
        spec = job.spec

        if remaining_work:
            u_m = spec.u_m - len(job.completed_map)
            v_r = spec.v_r - len(job.completed_reduce)
            # Shuffle copies still owed: completed maps have already pushed
            # their v_r copies.
            pairs_left = u_m * spec.v_r
            time_left = job.absolute_deadline - now
            if u_m == 0 and v_r == 0:
                return SlotDemand(n_m=0, n_r=0, feasible=True)
            u_m = max(u_m, 1)
            v_r = max(v_r, 1)
            if time_left <= 0:
                return SlotDemand(
                    n_m=min(u_m, max_map_slots or u_m),
                    n_r=min(v_r, max_reduce_slots or v_r),
                    feasible=False,
                    n_m_cont=float("inf"),
                    n_r_cont=float("inf"),
                )
            deadline = time_left + (u_m * v_r) * t_s - pairs_left * t_s
            # (equivalently: C = time_left − pairs_left·t_s)
        else:
            u_m, v_r, deadline = spec.u_m, spec.v_r, spec.deadline

        return min_slots(
            u_m, v_r, t_m, t_r, t_s, deadline,
            max_map_slots=max_map_slots, max_reduce_slots=max_reduce_slots,
        )
