"""The part of the JAX package's ``elastic/fleet.py`` that the training
launcher needs: the bridge from a training job's progress to the paper's
Eq.-10 estimator.  The fleet scheduler itself comes with ROADMAP M13."""
from __future__ import annotations

from repro_torch.core.estimator import min_slots


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
