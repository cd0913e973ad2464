"""Statistical reproduction of the paper's evaluation (§5, Fig. 3).

The preset runs the Table-2 five-workload mix on the calibrated paper
cluster (20 machines x 2 VMs, per-VM virtual disks => replication 1,
VM-level placement skew) under the proposed completion-time scheduler and
the Fair baseline, paired per seed (each seed re-rolls placement + jitter
for *both* schedulers), and checks the paper's two claims:

1. positive job-throughput gain of proposed over Fair (paper: ~12%);
2. the Fig.-3 per-workload ordering — shuffle-heavy Permutation Generator
   is the weakest-gain workload (the paper measures ~no gain for it).

This is the port's own copy of the JAX package's ``experiments/paperfig.py``
(pure Python on the host): at the same seeds its report is the original's,
byte for byte (a test holds it so).
"""
from __future__ import annotations

import tempfile
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.experiments.runner import (ExperimentSpec, TraceRef,
                                            run_experiment)
from repro_torch.experiments.stats import (PairedComparison,
                                           compare_completion_by_workload,
                                           compare_deadlines,
                                           compare_throughput)
from repro_torch.simcluster.workloads import paper_cluster

PAPER_CLAIM_GAIN_PCT = 12.0
FULL_SEEDS: Tuple[int, ...] = tuple(range(1, 13))
QUICK_SEEDS: Tuple[int, ...] = (1, 2, 3)


@dataclass
class PaperReport:
    seeds: Tuple[int, ...]
    throughput: PairedComparison          # fair -> proposed
    per_workload: Dict[str, PairedComparison]
    deadlines: Dict[str, float]
    simulated: int
    cached: int

    def weakest_workload(self) -> str:
        return min(self.per_workload, key=lambda w: self.per_workload[w].mean_gain_pct)

    def failures(self) -> List[str]:
        """Empty list = the paper's claims reproduce."""
        out = []
        if self.throughput.mean_gain_pct <= 0:
            out.append(
                f"throughput gain not positive: {self.throughput.mean_gain_pct:+.1f}%")
        if self.throughput.ci_lo_pct <= 0:
            out.append(
                "throughput-gain 95% CI includes zero: "
                f"[{self.throughput.ci_lo_pct:+.1f}%, {self.throughput.ci_hi_pct:+.1f}%]")
        weakest = self.weakest_workload()
        if weakest != "permutation":
            out.append(
                f"Fig.3 ordering: weakest-gain workload is {weakest!r}, "
                "expected 'permutation'")
        return out

    def format(self) -> str:
        lines = [
            f"== paper reproduction (proposed vs fair, {len(self.seeds)} paired "
            f"seeds; {self.simulated} simulated, {self.cached} cached) ==",
            "  " + self.throughput.format("fair", "proposed")
            + f"   (paper claims ~{PAPER_CLAIM_GAIN_PCT:.0f}%)",
            f"  deadlines met/run: fair {self.deadlines['mean_a']:.1f} -> "
            f"proposed {self.deadlines['mean_b']:.1f}",
            "  Fig.3 per-workload completion-time gain:",
        ]
        for w, cmp in sorted(self.per_workload.items(),
                             key=lambda kv: -kv[1].mean_gain_pct):
            lines.append(f"    {w:16s} {cmp.mean_gain_pct:+6.1f}% "
                         f"[{cmp.ci_lo_pct:+6.1f}%, {cmp.ci_hi_pct:+6.1f}%]")
        lines.append(f"  weakest-gain workload: {self.weakest_workload()} "
                     "(paper: permutation)")
        fails = self.failures()
        lines.append("  claims: " + ("REPRODUCED" if not fails
                                     else "; ".join(fails)))
        return "\n".join(lines)


def paper_spec(seeds: Sequence[int] = FULL_SEEDS) -> ExperimentSpec:
    """The paper evaluation as a sweep spec: paper trace (placement re-rolled
    per seed, because ``TraceRef.seed=None`` couples it to the sim seed) x
    paper cluster x {proposed, fair}."""
    return ExperimentSpec(
        name="paper",
        traces=(TraceRef(preset="paper"),),
        clusters=(paper_cluster(),),
        schedulers=("proposed", "fair"),
        seeds=tuple(seeds),
    )


def run_paper(seeds: Sequence[int] = FULL_SEEDS,
              cache_dir: Optional[Union[str, Path]] = None,
              *, workers: int = 0, n_boot: int = 2000,
              progress=None) -> PaperReport:
    tmp = None
    if cache_dir is None:
        tmp = tempfile.TemporaryDirectory(prefix="repro-paper-")
        cache_dir = tmp.name
    try:
        report = run_experiment(paper_spec(seeds), cache_dir,
                                workers=workers, progress=progress)
        by_sched = report.by_scheduler()
        fair, proposed = by_sched["fair"], by_sched["proposed"]
        return PaperReport(
            seeds=tuple(seeds),
            throughput=compare_throughput(fair, proposed, n_boot=n_boot),
            per_workload=compare_completion_by_workload(fair, proposed,
                                                        n_boot=n_boot),
            deadlines=compare_deadlines(fair, proposed),
            simulated=report.simulated,
            cached=report.cached,
        )
    finally:
        if tmp is not None:
            tmp.cleanup()
