"""Metrics warehouse: per-job and per-run records serialized from
``SimResult`` so sweep results can be cached, merged and compared offline.

A ``RunRecord`` is the unit the cache stores and the stats layer consumes.
It is deliberately plain JSON (no pickles): records written by one engine
version remain readable by the next, and records either package wrote read
in the other.  This is the port's own copy of the JAX package's
``experiments/metrics.py`` (pure Python; a test holds the event engine's
records byte-equal to the original's).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.simcluster.sim import SimResult
from repro_torch.simcluster.traces import Trace, _dumps

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


def run_record_from_result(result: SimResult, *, trace: Trace,
                           cluster_dict: Dict[str, object], scheduler: str,
                           seed: int, wall_time_s: float,
                           policy: Optional[Dict[str, object]] = None
                           ) -> RunRecord:
    """Flatten a ``SimResult`` into the warehouse record."""
    by_id = {tj.job_id: tj for tj in trace.jobs}
    jobs: List[JobRecord] = []
    for jid, rt in result.jobs.items():
        tj = by_id.get(jid)
        finish = rt.finish_time
        ct = None if finish is None else finish - rt.spec.submit_time
        jobs.append(JobRecord(
            job_id=jid,
            workload=tj.workload if tj else rt.spec.profile.name,
            input_gb=rt.spec.input_size_gb,
            submit_time=rt.spec.submit_time,
            deadline=rt.spec.deadline,
            finish_time=finish,
            completion_time=ct,
            deadline_met=(finish is not None
                          and finish <= rt.absolute_deadline + 1e-9),
            local_map_launches=rt.local_map_launches,
            remote_map_launches=rt.remote_map_launches,
            reconfig_map_launches=rt.reconfig_map_launches,
        ))
    return RunRecord(
        trace_name=trace.name,
        trace_seed=trace.seed,
        cluster=cluster_dict,
        scheduler=scheduler,
        seed=seed,
        makespan=result.makespan,
        throughput_jph=result.throughput_jobs_per_hour(),
        jobs_total=len(result.jobs),
        jobs_finished=sum(1 for j in jobs if j.finish_time is not None),
        deadlines_met=result.deadlines_met(),
        locality_rate=result.locality_rate(),
        speculative_launches=result.speculative_launches,
        events_processed=result.events_processed,
        wall_time_s=wall_time_s,
        reconfig_stats=dict(result.reconfig_stats),
        jobs=jobs,
        policy=policy,
        serve=dict(result.serve_stats),
    )
