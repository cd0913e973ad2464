"""Metrics warehouse: per-job and per-run records, so sweep results can be
cached, merged and compared offline.

A ``RunRecord`` is the unit the cache stores and the stats layer consumes.
It is deliberately plain JSON (no pickles): records written by one engine
version remain readable by the next, and records either package wrote read
in the other.  This is the port's own copy of the JAX package's
``experiments/metrics.py``; ``run_record_from_result``, which reads the
event engine's ``SimResult``, waits for the port's event engine.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.simcluster.traces import _dumps

RECORD_VERSION = 1


@dataclass
class JobRecord:
    job_id: str
    workload: str
    input_gb: float
    submit_time: float
    deadline: float                      # relative, seconds from submit
    finish_time: Optional[float]         # absolute sim time; None = unfinished
    completion_time: Optional[float]     # finish - submit
    deadline_met: bool
    local_map_launches: int
    remote_map_launches: int
    reconfig_map_launches: int

    def to_dict(self) -> Dict[str, object]:
        return dict(self.__dict__)

    @classmethod
    def from_dict(cls, d) -> "JobRecord":
        return cls(**d)


@dataclass
class RunRecord:
    """One simulated cell of a sweep: (trace, cluster, scheduler, seed)."""

    trace_name: str
    trace_seed: int
    cluster: Dict[str, object]           # ClusterSpec.to_dict()
    scheduler: str                       # PolicySpec.label (bare preset name
                                         # when the spec has no overrides)
    seed: int
    makespan: float
    throughput_jph: float
    jobs_total: int
    jobs_finished: int
    deadlines_met: int
    locality_rate: float
    speculative_launches: int
    events_processed: int
    wall_time_s: float
    reconfig_stats: Dict[str, float] = field(default_factory=dict)
    jobs: List[JobRecord] = field(default_factory=list)
    # canonical PolicySpec.to_dict() of the policy that produced the run;
    # None on records written before the policy API existed (their
    # ``scheduler`` string is the preset name, which parses to the spec)
    policy: Optional[Dict[str, object]] = None
    # SimResult.serve_stats (latency/SLO/harvest fold); empty when the
    # run had no serving layer, so pre-serving records load unchanged
    serve: Dict[str, object] = field(default_factory=dict)
    version: int = RECORD_VERSION

    # -- identity -----------------------------------------------------------
    def pair_key(self):
        """Records with equal pair keys differ only in policy — the unit
        paired statistics match on.  The cluster dict is canonical-JSON
        encoded (the cache's ``_dumps``): it can hold nested config dicts
        (``adaptive``), which a tuple-of-items would leave unhashable.
        The policy stays *out* of the key on purpose: ``scheduler`` (the
        spec's label) is the column axis the pairing compares across."""
        return (self.trace_name, self.trace_seed, _dumps(self.cluster),
                self.seed)

    def policy_spec(self):
        """The ``PolicySpec`` this record was produced under (parsed from
        the stored canonical dict, falling back to the label string for
        pre-policy records)."""
        from repro_torch.core.policies import PolicySpec
        return PolicySpec.parse(self.policy if self.policy is not None
                                else self.scheduler)

    # -- aggregation --------------------------------------------------------
    def mean_completion_by_workload(self) -> Dict[str, float]:
        """Mean completion time per workload over finished jobs; an
        unfinished job contributes ``inf`` so it cannot silently improve
        the average."""
        sums: Dict[str, float] = {}
        counts: Dict[str, int] = {}
        for j in self.jobs:
            ct = j.completion_time if j.completion_time is not None else math.inf
            sums[j.workload] = sums.get(j.workload, 0.0) + ct
            counts[j.workload] = counts.get(j.workload, 0) + 1
        return {w: sums[w] / counts[w] for w in sums}

    def mean_completion_time(self) -> float:
        if not self.jobs:
            return 0.0
        return sum(j.completion_time if j.completion_time is not None
                   else math.inf for j in self.jobs) / len(self.jobs)

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> Dict[str, object]:
        d = dict(self.__dict__)
        d["jobs"] = [j.to_dict() for j in self.jobs]
        return d

    @classmethod
    def from_dict(cls, d) -> "RunRecord":
        d = dict(d)
        d["jobs"] = [JobRecord.from_dict(j) for j in d.get("jobs", [])]
        return cls(**d)
