"""Resource estimation model, paper §2.2, Eq. (10): the part the training
launcher needs, as the port's own copy of the JAX package's
``core/estimator.py`` (``min_slots``) and ``core/types.py`` (``SlotDemand``,
``ceil_at_least_one``).  Pure Python; a test holds it to the original.

Given a job with ``u_m`` map tasks of mean duration ``t_m``, ``v_r`` reduce
tasks of duration ``t_r``, per mapper→reducer copy time ``t_s`` and deadline
``D``, the completion-time model (Eq. 7) is

    u_m·t_m / n_m  +  v_r·t_r / n_r  +  u_m·v_r·t_s  <=  D

and the *minimum total* slot allocation meeting it is the Lagrange-multiplier
solution (Eq. 10) of  min (n_m + n_r)  s.t.  A/n_m + B/n_r = C:

    A = u_m·t_m ;  B = v_r·t_r ;  C = D − u_m·v_r·t_s
    n_m = √A(√A+√B)/C ;  n_r = √B(√A+√B)/C
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional


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
    ``feasible=False``."""
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
