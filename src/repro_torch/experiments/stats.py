"""Paired-bootstrap statistics for scheduler-vs-scheduler comparison.

Every comparison pairs runs on the *same* (trace, trace seed, cluster, sim
seed) cell — the two schedulers saw identical arrivals, placements and
jitter draws, so the per-pair gain isolates the policy.  Confidence
intervals are percentile bootstrap over the pairs (resampling seeds, the
replication unit), which makes no normality assumption — gains here are
ratios of makespan-derived throughputs and visibly skewed.

This is the port's own copy of the JAX package's ``experiments/stats.py``:
the bootstrap, the paired comparisons the surrogate's calibration and the
``compare`` verb read, and the serving fold's latency summary.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

from repro_torch.experiments.metrics import RunRecord

DEFAULT_N_BOOT = 2000


def percentile(values: Sequence[float], q: float) -> float:
    """Exact nearest-rank percentile of ``values`` (q in [0, 100]).

    The nearest-rank method (``sorted[ceil(q/100 * n) - 1]``) returns an
    actual sample — no interpolation — so p50/p99 over request-latency
    samples are exact order statistics and byte-stable across runs.
    Raises on an empty sample."""
    if not values:
        raise ValueError("percentile over empty sample")
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q must be in [0, 100], got {q}")
    ordered = sorted(values)
    if q == 0.0:
        return ordered[0]
    rank = math.ceil(q / 100.0 * len(ordered))
    return ordered[rank - 1]


def latency_summary(samples: Sequence[float]) -> Dict[str, float]:
    """Exact p50/p99/mean over request sojourn samples (the serving
    fold's summary unit).  An empty sample folds to zeros — a service
    that received no requests has no latency, not an error."""
    if not samples:
        return {"n": 0, "mean": 0.0, "p50": 0.0, "p99": 0.0}
    return {
        "n": len(samples),
        "mean": sum(samples) / len(samples),
        "p50": percentile(samples, 50.0),
        "p99": percentile(samples, 99.0),
    }


def bootstrap_mean_ci(values: Sequence[float], *, n_boot: int = DEFAULT_N_BOOT,
                      alpha: float = 0.05, seed: int = 0
                      ) -> Tuple[float, float, float]:
    """(mean, ci_lo, ci_hi) — percentile bootstrap over ``values``."""
    vals = list(values)
    if not vals:
        raise ValueError("bootstrap over empty sample")
    mean = sum(vals) / len(vals)
    if len(vals) == 1:
        return mean, mean, mean
    rng = random.Random(seed)
    n = len(vals)
    means = sorted(
        sum(vals[rng.randrange(n)] for _ in range(n)) / n
        for _ in range(n_boot))
    lo = means[int(math.floor((alpha / 2) * (n_boot - 1)))]
    hi = means[int(math.ceil((1 - alpha / 2) * (n_boot - 1)))]
    return mean, lo, hi


@dataclass
class PairedComparison:
    """B-vs-A paired comparison of one metric ("gain" = how much B beats A)."""

    metric: str
    n_pairs: int
    mean_a: float
    mean_b: float
    mean_gain_pct: float
    ci_lo_pct: float
    ci_hi_pct: float
    win_rate: float                     # fraction of pairs where B beats A

    def to_dict(self) -> Dict[str, object]:
        return dict(self.__dict__)

    def format(self, label_a: str = "A", label_b: str = "B") -> str:
        return (f"{self.metric}: {label_a} {self.mean_a:.1f} vs {label_b} "
                f"{self.mean_b:.1f}  gain {self.mean_gain_pct:+.1f}% "
                f"[{self.ci_lo_pct:+.1f}%, {self.ci_hi_pct:+.1f}%] "
                f"(95% CI, n={self.n_pairs}, win rate {self.win_rate:.0%})")


def paired_bootstrap(a: Sequence[float], b: Sequence[float], *,
                     metric: str = "metric", higher_is_better: bool = True,
                     n_boot: int = DEFAULT_N_BOOT, alpha: float = 0.05,
                     seed: int = 0) -> PairedComparison:
    """Paired gain of B over A with a percentile-bootstrap CI.

    Per-pair gain: ``b/a - 1`` when higher is better (throughput), ``1 -
    b/a`` when lower is better (completion time) — positive always means
    "B wins"."""
    if len(a) != len(b):
        raise ValueError(f"paired samples differ in length: {len(a)} vs {len(b)}")
    if not a:
        raise ValueError("paired bootstrap over empty sample")
    gains = []
    wins = 0
    for x, y in zip(a, b):
        ok_x = math.isfinite(x) and x > 0
        ok_y = math.isfinite(y) and y > 0
        if ok_x and ok_y:
            g = (y / x - 1.0) if higher_is_better else (1.0 - y / x)
        elif ok_x == ok_y:
            g = 0.0       # both degenerate (e.g. neither run finished): a tie
        else:
            # exactly one side degenerate (zero throughput / unfinished run =
            # inf completion): a capped win or loss for B, whichever side
            # still produced a valid measurement
            g = 1.0 if ok_y else -1.0
        gains.append(g)
        if g > 0:
            wins += 1
    mean, lo, hi = bootstrap_mean_ci(gains, n_boot=n_boot, alpha=alpha,
                                     seed=seed)
    return PairedComparison(
        metric=metric,
        n_pairs=len(gains),
        mean_a=sum(a) / len(a),
        mean_b=sum(b) / len(b),
        mean_gain_pct=mean * 100.0,
        ci_lo_pct=lo * 100.0,
        ci_hi_pct=hi * 100.0,
        win_rate=wins / len(gains),
    )


def _pair_records(records_a: Sequence[RunRecord],
                  records_b: Sequence[RunRecord]
                  ) -> List[Tuple[RunRecord, RunRecord]]:
    by_key_a = {r.pair_key(): r for r in records_a}
    by_key_b = {r.pair_key(): r for r in records_b}
    common = sorted(set(by_key_a) & set(by_key_b))
    if not common:
        raise ValueError("no common (trace, cluster, seed) cells to pair on")
    return [(by_key_a[k], by_key_b[k]) for k in common]


def compare_throughput(records_a: Sequence[RunRecord],
                       records_b: Sequence[RunRecord], *,
                       n_boot: int = DEFAULT_N_BOOT,
                       seed: int = 0) -> PairedComparison:
    """Job-throughput gain of B over A, paired per (trace, cluster, seed)."""
    pairs = _pair_records(records_a, records_b)
    return paired_bootstrap(
        [pa.throughput_jph for pa, _ in pairs],
        [pb.throughput_jph for _, pb in pairs],
        metric="throughput_jobs_per_hour", higher_is_better=True,
        n_boot=n_boot, seed=seed)


def compare_completion_by_workload(records_a: Sequence[RunRecord],
                                   records_b: Sequence[RunRecord], *,
                                   n_boot: int = DEFAULT_N_BOOT,
                                   seed: int = 0
                                   ) -> Dict[str, PairedComparison]:
    """Per-workload completion-time gain (B faster than A) — the Fig.-3 view."""
    pairs = _pair_records(records_a, records_b)
    per_a: Dict[str, List[float]] = {}
    per_b: Dict[str, List[float]] = {}
    for pa, pb in pairs:
        ca, cb = (pa.mean_completion_by_workload(),
                  pb.mean_completion_by_workload())
        for w in set(ca) & set(cb):
            per_a.setdefault(w, []).append(ca[w])
            per_b.setdefault(w, []).append(cb[w])
    return {w: paired_bootstrap(per_a[w], per_b[w],
                                metric=f"completion_time[{w}]",
                                higher_is_better=False, n_boot=n_boot,
                                seed=seed)
            for w in sorted(per_a)}


def compare_deadlines(records_a: Sequence[RunRecord],
                      records_b: Sequence[RunRecord]) -> Dict[str, float]:
    """Mean deadlines-met per run for each side (no CI — small integers)."""
    pairs = _pair_records(records_a, records_b)
    return {
        "mean_a": sum(pa.deadlines_met for pa, _ in pairs) / len(pairs),
        "mean_b": sum(pb.deadlines_met for _, pb in pairs) / len(pairs),
        "n_pairs": len(pairs),
    }


def compare_serve_p99(records_a: Sequence[RunRecord],
                      records_b: Sequence[RunRecord], *,
                      n_boot: int = DEFAULT_N_BOOT,
                      seed: int = 0) -> PairedComparison:
    """Whole-run serving p99-latency delta of B vs A (lower is better),
    paired per (trace, cluster, seed).  Both sides must carry serving
    metrics (``RunRecord.serve``) — e.g. a harvest policy vs its
    no-harvest baseline on an identical service fleet."""
    pairs = _pair_records(records_a, records_b)
    missing = [r.scheduler for r, _ in pairs if not r.serve] + \
              [r.scheduler for _, r in pairs if not r.serve]
    if missing:
        raise ValueError(
            f"runs without serving metrics cannot compare p99: {missing}")
    return paired_bootstrap(
        [pa.serve["p99_ms"] for pa, _ in pairs],
        [pb.serve["p99_ms"] for _, pb in pairs],
        metric="serve_p99_ms", higher_is_better=False,
        n_boot=n_boot, seed=seed)
