"""Plain PyTorch version of the fluid surrogate's scan (K3's plain version).

One integration step is the JAX package's ``_make_kernel`` step
(``simcluster/surrogate.py``), written over a leading cell axis instead of
``vmap``: job state is ``[C, Jp]``, the four in-flight rings (map and reduce
service, successful and expired parks) are ``[C, Jp, RING]``, and a Python
loop runs over the steps.  Without ``diag`` the steps run in chunks of 256,
and a chunk runs only while some cell still has an unfinished real job; a
cell whose jobs have all finished keeps its state, as ``lax.while_loop``
under ``vmap`` keeps it.  ``diag=True`` runs the whole horizon and returns
the 11 per-step aggregates.

This is what the CPU runs and what the CUDA kernel (``csrc/fluid_scan.cu``)
is held against on the card.  The kernel and this version take every sum in
one fixed order, so a cell's result depends on nothing but the cell (the
batch it rides in, its place there and the device aside):

* a sum over jobs (``_tree_sum``) splits the jobs into rows of 32, halves
  each row (element i + element i + 16, then + 8, ..., the kernel's warp
  butterfly) and then halves the row sums; a ring's sum over its 64 columns
  is the same tree;
* the inclusive prefix sum of the priority allocator (``_cumsum``) is the
  Hillis-Steele scan (x[i] += x[i - s] for s = 1, 2, 4, ...), not
  ``torch.cumsum``, which sums in float64 on the CPU;
* the transcendental terms (``log1p`` of the miss odds, ``exp`` of the
  locality draws) are constants of a cell: they are taken once, one cell at
  a time, since a vectorised loop's scalar tail can round them otherwise.

The JAX original takes its sums in XLA's order, so the two agree to
rounding, not bit for bit; the tests hold every finish time equal.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

#: ring depth, steps: the CUDA kernel is built for this depth
RING = 64
#: steps between the early-exit tests
CHUNK = 256
#: the per-job rows of a packed cell, in order
JOB_FIELDS = ("submit", "dl_abs", "map_mass0", "red_mass0", "lag_ml",
              "lag_mr", "lag_rr", "c_over_n", "prio_key", "pad_mask")
#: the per-cell scalars of a packed cell, in order
SCALAR_FIELDS = ("map_slots", "red_slots", "machines", "remote_mult",
                 "ordering", "park", "overload", "locality_delay",
                 "max_wait", "pending_bar", "active_bar")
#: the per-step aggregates of ``diag``, in order
DIAG_FIELDS = ("active", "pending", "free_m", "free_r", "waiting", "blocked",
               "launched_m", "launched_r", "lf", "chi", "latch")


class FluidPhysics(NamedTuple):
    """The fluid model's constants (``simcluster.surrogate`` defines them);
    every float is used in float32, as JAX uses a Python scalar beside a
    float32 array."""

    dt: float
    park_success: float
    park_wait: float
    park_crowd_penalty: float
    park_wait_crowd: float
    repark_crowd: float
    sat_lo: float
    sat_width: float
    locality_draws: float
    delay_boost: float
    delay_remote_wait: float
    net_contention: float
    eps: float
    inf: float
    fair_iters: int


def _halving(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim (a power of two) by halving: x[:h] + x[h:]."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim (a power of two) in the kernel's order: rows of
    32 halved, then the row sums halved."""
    n = x.shape[-1]
    if n > 32:
        x = _halving(x.reshape(*x.shape[:-1], n // 32, 32))
    return _halving(x)


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over the last dim, Hillis-Steele: for s = 1, 2,
    4, ..., x[i] += x[i - s] where i >= s."""
    s = 1
    while s < x.shape[-1]:
        x = torch.cat([x[..., :s], x[..., s:] + x[..., :-s]], dim=-1)
        s *= 2
    return x


def _fair_waterfill(demand, capacity, eps: float, iters: int):
    """Equal-share progressive filling of ``capacity`` [C] over ``demand``
    [C, J]: each round splits the leftover equally among unsatisfied jobs.
    A round in which no job is unsatisfied adds 0 to every allocation, and so
    does every round after it: the loop stops there."""
    alloc = torch.zeros_like(demand)
    for _ in range(iters):
        need = demand - alloc
        unsat = (need > eps).to(demand.dtype)
        if not bool(unsat.any()):
            break
        n_unsat = torch.clamp_min(_tree_sum(unsat), 1.0)
        leftover = torch.clamp_min(capacity - _tree_sum(alloc), 0.0)
        share = leftover / n_unsat
        alloc = alloc + torch.minimum(need, share[:, None]) * unsat
    return alloc


def _priority_alloc(demand, capacity, order, inv_order):
    """Strict-priority waterfilling: jobs take their full demand in
    ``order`` until ``capacity`` runs out.  As the original, ``before`` is the
    inclusive prefix sum less the job's own demand, and the clip is
    min(max(x, 0), d)."""
    d_sorted = torch.gather(demand, 1, order)
    before = _cumsum(d_sorted) - d_sorted
    a_sorted = torch.minimum(torch.clamp_min(capacity[:, None] - before, 0.0),
                             d_sorted)
    return torch.gather(a_sorted, 1, inv_order)


def _allocate(use_fair, demand, capacity, order, inv_order, phys: FluidPhysics):
    """Each cell's allocator, by its ``use_fair``: only the allocators some
    cell uses are computed."""
    if bool(use_fair.all()):
        return _fair_waterfill(demand, capacity, phys.eps, phys.fair_iters)
    if not bool(use_fair.any()):
        return _priority_alloc(demand, capacity, order, inv_order)
    return torch.where(use_fair[:, None],
                       _fair_waterfill(demand, capacity, phys.eps, phys.fair_iters),
                       _priority_alloc(demand, capacity, order, inv_order))


def fluid_scan_ref(
    jobs: torch.Tensor,        # [C, len(JOB_FIELDS), Jp] float32
    order: torch.Tensor,       # [C, Jp] int: each cell's static priority order
    scalars: torch.Tensor,     # [C, len(SCALAR_FIELDS)] float32
    phys: FluidPhysics,
    *,
    n_steps: int,
    diag: bool = False,
) -> Dict[str, torch.Tensor]:
    """Integrate C cells of one (jobs, steps) bucket.  Returns ``finish``,
    ``local``, ``remote``, ``map_rem`` and ``red_rem`` [C, Jp] float32,
    ``latched_steps`` [C] float32, ``steps`` [C] int32 (the steps each cell
    integrated) and, with ``diag``, ``diag`` [C, n_steps, len(DIAG_FIELDS)]
    float32."""
    C, _, Jp = jobs.shape
    dev = jobs.device
    f32 = torch.float32
    L = RING
    dt, eps, inf = np.float32(phys.dt), phys.eps, phys.inf
    job = {k: jobs[:, i] for i, k in enumerate(JOB_FIELDS)}
    sc = {k: scalars[:, i] for i, k in enumerate(SCALAR_FIELDS)}
    order = order.long()
    inv_order = torch.argsort(order, dim=1)
    submit, pad_mask, dl_abs = job["submit"], job["pad_mask"], job["dl_abs"]
    lag_ml, lag_mr, lag_rr = (job[k].long() for k in ("lag_ml", "lag_mr", "lag_rr"))
    lag_mr_f = job["lag_mr"]
    use_fair_ordering = sc["ordering"] >= 1.5
    ell_exponent = 1.0 + phys.delay_boost * sc["locality_delay"]
    # constants of the cell, one cell at a time (see the module's note)
    lf_base = torch.stack([
        1.0 - torch.exp(ell_exponent[c] * phys.locality_draws
                        * torch.log1p(-job["c_over_n"][c]))
        for c in range(C)])
    delay_lag = torch.round(phys.delay_remote_wait * sc["locality_delay"] / float(dt)).long()
    crit_bar = 3.0 * sc["max_wait"]

    state = {
        "pend_m": job["map_mass0"].clone(), "pend_r": job["red_mass0"].clone(),
        "ring_m": torch.zeros((C, Jp, L), dtype=f32, device=dev),
        "ring_r": torch.zeros((C, Jp, L), dtype=f32, device=dev),
        "park_s": torch.zeros((C, Jp, L), dtype=f32, device=dev),
        "park_x": torch.zeros((C, Jp, L), dtype=f32, device=dev),
        "finish": torch.full((C, Jp), inf, dtype=f32, device=dev),
        "loc_acc": torch.zeros((C, Jp), dtype=f32, device=dev),
        "rem_acc": torch.zeros((C, Jp), dtype=f32, device=dev),
        "latch": torch.zeros(C, dtype=torch.bool, device=dev),
        "lsteps": torch.zeros(C, dtype=f32, device=dev),
    }

    def step(s, it: int):
        t = float(np.float32(it) * dt)        # as the original: float32(it) * dt
        submitted = (submit <= t).to(f32) * pad_mask
        idx = it % L
        ring_m, ring_r, park_s, park_x = s["ring_m"], s["ring_r"], s["park_s"], s["park_x"]
        ring_m[..., idx] = 0.0
        ring_r[..., idx] = 0.0
        mat_s = park_s[..., idx].clone()
        mat_x = park_x[..., idx].clone()
        park_s[..., idx] = 0.0
        park_x[..., idx] = 0.0
        inflight_m = _tree_sum(ring_m)
        inflight_r = _tree_sum(ring_r)
        waiting = _tree_sum(park_s) + _tree_sum(park_x)
        pend_m, pend_r = s["pend_m"], s["pend_r"]
        map_left = pend_m + inflight_m + waiting + mat_s + mat_x
        red_left = pend_r + inflight_r
        map_open = submitted * (map_left > eps).to(f32)
        red_open = submitted * (map_left <= eps).to(f32) * (red_left > eps).to(f32)
        pending = _tree_sum(pend_m * submitted)
        active = _tree_sum(submitted * ((map_left > eps) | (red_left > eps)).to(f32))
        trip = (pending >= sc["pending_bar"]) & (active >= sc["active_bar"])
        latch = (sc["overload"] > 0.5) & ((s["latch"] | trip) & (active > 0.5))
        use_fair = use_fair_ordering | latch
        park_on = (sc["park"] > 0.5) & ~latch
        chi_raw = active / sc["machines"]
        chi = torch.clamp(chi_raw, 0.0, 1.0)
        # -- map demand: two allocation rounds
        sum_waiting = _tree_sum(waiting)
        free_m = torch.clamp_min(sc["map_slots"] - _tree_sum(inflight_m) - sum_waiting, 0.0)
        n_open = torch.clamp_min(_tree_sum(map_open), 1.0)
        share = sc["map_slots"] / n_open
        cap = torch.clamp_min(share[:, None] - waiting, 0.0)
        offered = torch.minimum(pend_m, cap) * map_open
        launch1 = _allocate(use_fair, offered, free_m, order, inv_order, phys)
        spare = torch.clamp_min(free_m - _tree_sum(launch1), 0.0)
        off2 = torch.clamp_min(pend_m - launch1, 0.0) * map_open
        launch2 = _allocate(use_fair, off2, spare, order, inv_order, phys)
        launch = launch1 + launch2
        launch_loc = launch * lf_base
        rest = launch - launch_loc
        # -- park outcome odds and waits
        wait_eff = torch.minimum(
            phys.park_wait * (1.0 + phys.park_wait_crowd * chi), sc["max_wait"])
        p_succ = phys.park_success * torch.clamp_min(
            1.0 - phys.park_crowd_penalty * chi, 0.0)
        ws = torch.round(wait_eff / float(dt)).long()
        saturate = torch.clamp((chi_raw - phys.sat_lo) / phys.sat_width, 0.0, 1.0)
        wx = torch.clamp_max(torch.round(
            sc["max_wait"] * (1.0 + phys.repark_crowd * saturate) / float(dt)).long(), L - 1)
        crit = (dl_abs - t) <= crit_bar[:, None]
        park_f = park_on.to(f32)[:, None] * (1.0 - crit.to(f32))
        f_psucc = rest * park_f * p_succ[:, None]
        f_pexp = rest * park_f * (1.0 - p_succ)[:, None]
        f_rem = rest * (1.0 - park_f)
        rem_load = _tree_sum(f_rem + mat_x) / sc["map_slots"]
        lag_mr_eff = torch.clamp_max(
            lag_mr + delay_lag[:, None]
            + torch.round(lag_mr_f * phys.net_contention * rem_load[:, None]).long(),
            L - 1)
        ring_m.scatter_add_(2, ((it + lag_ml) % L)[..., None], (launch_loc + mat_s)[..., None])
        ring_m.scatter_add_(2, ((it + lag_mr_eff) % L)[..., None], (f_rem + mat_x)[..., None])
        park_s.scatter_add_(2, ((it + ws) % L)[:, None, None].expand(C, Jp, 1), f_psucc[..., None])
        park_x.scatter_add_(2, ((it + wx) % L)[:, None, None].expand(C, Jp, 1), f_pexp[..., None])
        pend_m = torch.clamp_min(pend_m - launch, 0.0)
        pend_m = torch.where(pend_m <= 0.01, 0.0, pend_m)
        loc_acc = s["loc_acc"] + launch_loc + f_psucc
        rem_acc = s["rem_acc"] + f_rem + f_pexp
        # -- reduce
        off_r = pend_r * red_open
        free_r = torch.clamp_min(sc["red_slots"] - _tree_sum(inflight_r), 0.0)
        launch_r = _allocate(use_fair, off_r, free_r, order, inv_order, phys)
        ring_r.scatter_add_(2, ((it + lag_rr) % L)[..., None], launch_r[..., None])
        pend_r = torch.clamp_min(pend_r - launch_r, 0.0)
        pend_r = torch.where(pend_r <= 0.01, 0.0, pend_r)
        # -- completions
        map_left = (pend_m + inflight_m + launch_loc + mat_s + f_rem + mat_x
                    + waiting + f_psucc + f_pexp)
        red_left = pend_r + inflight_r + launch_r
        done = (submitted > 0.5) & (map_left <= eps) & (red_left <= eps)
        finish = s["finish"]
        finish = torch.where(done & (finish >= inf), float(np.float32(t) + dt), finish)
        ys = None
        if diag:
            launched_m = _tree_sum(launch)
            lsum = torch.clamp_min(launched_m, eps)
            lf = (launch_loc + f_psucc) / torch.clamp_min(launch, eps)
            ys = torch.stack([active, pending, free_m, free_r, sum_waiting,
                              sum_waiting, launched_m, _tree_sum(launch_r),
                              _tree_sum(lf * launch) / lsum, chi, latch.to(f32)], dim=1)
        new = {"pend_m": pend_m, "pend_r": pend_r, "ring_m": ring_m,
               "ring_r": ring_r, "park_s": park_s, "park_x": park_x,
               "finish": finish, "loc_acc": loc_acc, "rem_acc": rem_acc,
               "latch": latch, "lsteps": s["lsteps"] + latch.to(f32)}
        return new, ys

    steps = torch.zeros(C, dtype=torch.int32, device=dev)
    trajectory = []
    if diag:
        for it in range(n_steps):
            state, ys = step(state, it)
            trajectory.append(ys)
        steps += n_steps
    else:
        for c in range(max(n_steps // CHUNK, 1)):
            running = ((state["finish"] >= inf) & (pad_mask > 0.5)).any(dim=1)
            if not bool(running.any()):
                break
            all_running = bool(running.all())
            before = None if all_running else {k: v.clone() for k, v in state.items()}
            for it in range(c * CHUNK, (c + 1) * CHUNK):
                state, _ = step(state, it)
            if not all_running:
                # a cell that had finished keeps its state, as under vmap
                for k, v in state.items():
                    keep = running.view(C, *([1] * (v.dim() - 1)))
                    state[k] = torch.where(keep, v, before[k])
            steps += running.to(torch.int32) * CHUNK
    out = {"finish": state["finish"], "local": state["loc_acc"],
           "remote": state["rem_acc"], "map_rem": state["pend_m"],
           "red_rem": state["pend_r"], "latched_steps": state["lsteps"],
           "steps": steps}
    if diag:
        out["diag"] = torch.stack(trajectory, dim=1)
    return out
