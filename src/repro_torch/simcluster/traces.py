"""SWIM-style synthetic workload traces + a versioned JSONL trace format.

A *trace* is a cluster-shape-independent list of job arrivals: for each job
its workload, input size, submit time, deadline and a ``placement_seed``.
Replaying a trace against a concrete ``ClusterSpec`` regenerates the HDFS
block placement deterministically from the stored seed, so the same trace
file drives any cluster shape while two replays against the same shape are
identical.

The generator follows the facebook/SWIM recipe adapted to the paper's five
workloads (arXiv:1808.08040 and the survey arXiv:1704.02632 both evaluate
virtual-cluster schedulers on exactly this kind of synthetic trace):

* **job sizes** are heavy-tailed — lognormal (median/sigma) or Pareto
  (alpha over a minimum size), clamped to a [min, max] GB window;
* **arrivals** are a non-homogeneous Poisson process: a base rate with an
  optional diurnal sinusoid, sampled by thinning, plus Poisson-seeded
  *bursts* (a geometric number of extra jobs at a short stagger) for the
  flash-crowd patterns the ROADMAP scenarios model;
* **workload mix** is a weighted draw over the five paper workloads.

File format (``repro-trace/v1``): line 1 is a JSON header
``{"format": "repro-trace/v1", "name": ..., "seed": ..., "num_jobs": ...,
"config": {...}|null}``; each subsequent line is one job object.  All JSON
is dumped with sorted keys and no whitespace, so generation is byte-stable
per seed and ``save -> load -> save`` round-trips bit-exactly (floats
survive JSON via ``repr`` round-tripping).

This is the port's own copy of the JAX package's ``simcluster/traces.py``
(pure Python; a test holds every preset's trace byte-equal to the
original's).  The SWIM importer is not copied yet.
"""
from __future__ import annotations

import hashlib
import json
import math
import random
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.core.types import ClusterSpec, JobSpec
from repro_torch.simcluster.workloads import (PAPER_SKEW, PAPER_TABLE2_ROWS,
                                        WORKLOADS, default_deadline,
                                        n_map_tasks, n_reduce_tasks,
                                        place_blocks)

TRACE_FORMAT = "repro-trace/v1"


def _dumps(obj) -> str:
    """Canonical JSON: sorted keys, no whitespace — byte-stable output."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def _stable_seed(*parts) -> int:
    """Process-stable integer seed from arbitrary JSON-able parts."""
    digest = hashlib.sha256(_dumps(list(parts)).encode()).digest()
    return int.from_bytes(digest[:8], "big")


# ---------------------------------------------------------------------------
# generator configuration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ArrivalConfig:
    """Non-homogeneous Poisson arrivals with diurnal modulation + bursts.

    Instantaneous rate: ``rate_per_hour * (1 + diurnal_amplitude *
    sin(2*pi*(t + diurnal_phase_s)/diurnal_period_s))``, sampled by
    thinning.  Each accepted arrival seeds, with probability ``burst_prob``,
    a geometric number of follow-on jobs (mean ``burst_size_mean``) spaced
    ``burst_stagger_s`` apart — a flash crowd."""

    rate_per_hour: float = 240.0
    diurnal_amplitude: float = 0.0      # 0..1
    diurnal_period_s: float = 3600.0
    diurnal_phase_s: float = 0.0
    burst_prob: float = 0.0
    burst_size_mean: float = 4.0
    burst_stagger_s: float = 2.0

    def __post_init__(self) -> None:
        if self.rate_per_hour <= 0:
            raise ValueError("rate_per_hour must be positive")
        if not 0.0 <= self.diurnal_amplitude <= 1.0:
            # the thinning envelope assumes the sinusoid only adds to the
            # base rate; out-of-range amplitudes would silently clip peaks
            raise ValueError("diurnal_amplitude must be in [0, 1]")
        if self.diurnal_period_s <= 0:
            raise ValueError("diurnal_period_s must be positive")
        if not 0.0 <= self.burst_prob <= 1.0:
            raise ValueError("burst_prob must be in [0, 1]")
        if self.burst_stagger_s <= 0:
            raise ValueError("burst_stagger_s must be positive")

    def to_dict(self) -> Dict[str, float]:
        return {
            "rate_per_hour": self.rate_per_hour,
            "diurnal_amplitude": self.diurnal_amplitude,
            "diurnal_period_s": self.diurnal_period_s,
            "diurnal_phase_s": self.diurnal_phase_s,
            "burst_prob": self.burst_prob,
            "burst_size_mean": self.burst_size_mean,
            "burst_stagger_s": self.burst_stagger_s,
        }

    @classmethod
    def from_dict(cls, d) -> "ArrivalConfig":
        return cls(**d)

    def rate_at(self, t: float) -> float:
        base = self.rate_per_hour / 3600.0
        if self.diurnal_amplitude <= 0:
            return base
        return base * (1.0 + self.diurnal_amplitude * math.sin(
            2.0 * math.pi * (t + self.diurnal_phase_s) / self.diurnal_period_s))


@dataclass(frozen=True)
class SizeConfig:
    """Heavy-tailed input-size distribution (GB)."""

    distribution: str = "lognormal"     # "lognormal" | "pareto"
    median_gb: float = 2.0              # lognormal location (exp(mu))
    sigma: float = 1.0                  # lognormal shape
    alpha: float = 1.6                  # pareto tail index
    min_gb: float = 0.25
    max_gb: float = 32.0

    def __post_init__(self) -> None:
        if self.distribution not in ("lognormal", "pareto"):
            raise ValueError(f"unknown size distribution {self.distribution!r}")

    def to_dict(self) -> Dict[str, object]:
        return {
            "distribution": self.distribution,
            "median_gb": self.median_gb,
            "sigma": self.sigma,
            "alpha": self.alpha,
            "min_gb": self.min_gb,
            "max_gb": self.max_gb,
        }

    @classmethod
    def from_dict(cls, d) -> "SizeConfig":
        return cls(**d)

    def draw(self, rng: random.Random) -> float:
        if self.distribution == "lognormal":
            gb = rng.lognormvariate(math.log(self.median_gb), self.sigma)
        else:
            gb = self.min_gb * rng.paretovariate(self.alpha)
        return round(min(self.max_gb, max(self.min_gb, gb)), 3)


@dataclass(frozen=True)
class TraceConfig:
    """Declarative recipe for one synthetic trace."""

    name: str = "mix"
    num_jobs: int = 50
    mix: Tuple[Tuple[str, float], ...] = tuple((w, 1.0) for w in WORKLOADS)
    arrival: ArrivalConfig = ArrivalConfig()
    sizes: SizeConfig = SizeConfig()
    deadline_slack: float = 2.2
    skew: float = PAPER_SKEW

    def __post_init__(self) -> None:
        if self.num_jobs <= 0:
            raise ValueError("num_jobs must be positive")
        for w, weight in self.mix:
            if w not in WORKLOADS:
                raise ValueError(f"unknown workload {w!r} in mix")
            if weight < 0:
                raise ValueError("mix weights must be non-negative")

    def to_dict(self) -> Dict[str, object]:
        return {
            "name": self.name,
            "num_jobs": self.num_jobs,
            "mix": [[w, weight] for w, weight in self.mix],
            "arrival": self.arrival.to_dict(),
            "sizes": self.sizes.to_dict(),
            "deadline_slack": self.deadline_slack,
            "skew": self.skew,
        }

    @classmethod
    def from_dict(cls, d) -> "TraceConfig":
        d = dict(d)
        d["mix"] = tuple((w, float(weight)) for w, weight in d["mix"])
        d["arrival"] = ArrivalConfig.from_dict(d["arrival"])
        d["sizes"] = SizeConfig.from_dict(d["sizes"])
        return cls(**d)


# ---------------------------------------------------------------------------
# the trace itself
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TraceJob:
    """One arrival.  ``placement_seed`` makes block placement reproducible
    at replay time against any cluster shape."""

    job_id: str
    workload: str
    input_gb: float
    submit_time: float
    deadline: float
    placement_seed: int
    skew: float = PAPER_SKEW

    def to_dict(self) -> Dict[str, object]:
        return {
            "job_id": self.job_id,
            "workload": self.workload,
            "input_gb": self.input_gb,
            "submit_time": self.submit_time,
            "deadline": self.deadline,
            "placement_seed": self.placement_seed,
            "skew": self.skew,
        }

    @classmethod
    def from_dict(cls, d) -> "TraceJob":
        return cls(**d)

    def to_job_spec(self, spec: ClusterSpec) -> JobSpec:
        rng = random.Random(self.placement_seed)
        u_m = n_map_tasks(self.input_gb)
        return JobSpec(
            job_id=self.job_id,
            profile=WORKLOADS[self.workload],
            u_m=u_m,
            v_r=n_reduce_tasks(self.workload, self.input_gb),
            deadline=self.deadline,
            submit_time=self.submit_time,
            input_size_gb=self.input_gb,
            block_placement=place_blocks(u_m, spec, rng, skew=self.skew),
        )


@dataclass
class Trace:
    name: str
    seed: int
    jobs: List[TraceJob]
    config: Optional[Dict[str, object]] = None   # generator config, if any

    # -- serialization ------------------------------------------------------
    def header(self) -> Dict[str, object]:
        return {
            "format": TRACE_FORMAT,
            "name": self.name,
            "seed": self.seed,
            "num_jobs": len(self.jobs),
            "config": self.config,
        }

    def to_jsonl(self) -> str:
        lines = [_dumps(self.header())]
        lines.extend(_dumps(j.to_dict()) for j in self.jobs)
        return "\n".join(lines) + "\n"

    @classmethod
    def from_jsonl(cls, text: str) -> "Trace":
        lines = [ln for ln in text.splitlines() if ln.strip()]
        if not lines:
            raise ValueError("empty trace")
        header = json.loads(lines[0])
        fmt = header.get("format")
        if fmt != TRACE_FORMAT:
            raise ValueError(
                f"unsupported trace format {fmt!r} (expected {TRACE_FORMAT})")
        jobs = [TraceJob.from_dict(json.loads(ln)) for ln in lines[1:]]
        if header.get("num_jobs") != len(jobs):
            raise ValueError(
                f"trace truncated: header says {header.get('num_jobs')} jobs, "
                f"found {len(jobs)}")
        return cls(name=header["name"], seed=header["seed"], jobs=jobs,
                   config=header.get("config"))

    def save(self, path: Union[str, Path]) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(self.to_jsonl())
        return path

    @classmethod
    def load(cls, path: Union[str, Path]) -> "Trace":
        return cls.from_jsonl(Path(path).read_text())

    # -- replay / inspection ------------------------------------------------
    def job_specs(self, spec: ClusterSpec) -> List[JobSpec]:
        return [j.to_job_spec(spec) for j in self.jobs]

    def duration(self) -> float:
        # max, not jobs[-1]: hand-built traces need not be time-sorted
        return max(j.submit_time for j in self.jobs) if self.jobs else 0.0

    def workload_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for j in self.jobs:
            out[j.workload] = out.get(j.workload, 0) + 1
        return out

    def total_input_gb(self) -> float:
        return sum(j.input_gb for j in self.jobs)


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------

def _arrival_times(cfg: ArrivalConfig, rng: random.Random, n: int) -> List[float]:
    """First ``n`` arrivals of the thinned non-homogeneous Poisson process,
    with geometric bursts riding on accepted arrivals."""
    lam_max = (cfg.rate_per_hour / 3600.0) * (1.0 + cfg.diurnal_amplitude)
    times: List[float] = []
    t = 0.0
    while len(times) < n:
        t += rng.expovariate(lam_max)
        if rng.random() * lam_max > cfg.rate_at(t):
            continue                      # thinned out
        times.append(t)
        if cfg.burst_prob > 0 and rng.random() < cfg.burst_prob:
            p = 1.0 / max(1.0, cfg.burst_size_mean)
            extra = 0
            while rng.random() > p:       # geometric, mean ~ burst_size_mean-1
                extra += 1
            for k in range(extra):
                if len(times) >= n:
                    break
                times.append(t + (k + 1) * cfg.burst_stagger_s)
    times.sort()                          # bursts can leapfrog base arrivals
    return times[:n]


def generate_trace(config: TraceConfig, seed: int = 0) -> Trace:
    """Deterministic per (config, seed): same inputs => byte-identical trace."""
    rng = random.Random(_stable_seed("repro-trace", config.to_dict(), seed))
    names = [w for w, _ in config.mix]
    weights = [weight for _, weight in config.mix]
    arrivals = _arrival_times(config.arrival, rng, config.num_jobs)
    jobs = []
    for i, t in enumerate(arrivals):
        w = rng.choices(names, weights=weights)[0]
        gb = config.sizes.draw(rng)
        jobs.append(TraceJob(
            job_id=f"{config.name}-{i:04d}-{w}",
            workload=w,
            input_gb=gb,
            submit_time=round(t, 3),
            deadline=round(default_deadline(w, gb, slack=config.deadline_slack), 3),
            placement_seed=rng.randrange(1 << 31),
            skew=config.skew,
        ))
    return Trace(name=config.name, seed=seed, jobs=jobs,
                 config=config.to_dict())


def trace_from_rows(name: str,
                    rows: Sequence[Tuple[str, float, float, float]],
                    seed: int = 0, skew: float = PAPER_SKEW) -> Trace:
    """Hand-built trace from explicit (workload, input_gb, deadline,
    submit_time) rows — for fixed experiment mixes like the paper's Table 2."""
    rng = random.Random(_stable_seed("repro-trace-rows", name, seed))
    jobs = [TraceJob(
        job_id=f"{name}-{i:04d}-{w}",
        workload=w,
        input_gb=float(gb),
        submit_time=float(t),
        deadline=float(dl),
        placement_seed=rng.randrange(1 << 31),
        skew=skew,
    ) for i, (w, gb, dl, t) in enumerate(rows)]
    return Trace(name=name, seed=seed, jobs=jobs, config=None)


def paper_trace(seed: int = 0) -> Trace:
    """The paper's §5 evaluation mix (Table-2 rows, all submitted at t=0)
    as a trace; each seed re-rolls the skewed VM-level block placement."""
    rows = [(w, float(gb), dl, 0.0) for (w, gb, dl) in PAPER_TABLE2_ROWS]
    return trace_from_rows("paper-table2", rows, seed=seed, skew=PAPER_SKEW)


# ---------------------------------------------------------------------------
# named presets
# ---------------------------------------------------------------------------

PRESETS: Dict[str, TraceConfig] = {
    "mix_small": TraceConfig(
        name="mix_small", num_jobs=12,
        arrival=ArrivalConfig(rate_per_hour=360.0),
        sizes=SizeConfig(median_gb=1.0, sigma=0.6, max_gb=4.0)),
    "mix": TraceConfig(
        name="mix", num_jobs=60,
        arrival=ArrivalConfig(rate_per_hour=240.0),
        sizes=SizeConfig(median_gb=2.0, sigma=0.9, max_gb=16.0)),
    "heavy_tail": TraceConfig(
        name="heavy_tail", num_jobs=80,
        arrival=ArrivalConfig(rate_per_hour=300.0),
        sizes=SizeConfig(distribution="pareto", alpha=1.3, min_gb=0.5,
                         max_gb=48.0)),
    "diurnal": TraceConfig(
        name="diurnal", num_jobs=100,
        arrival=ArrivalConfig(rate_per_hour=180.0, diurnal_amplitude=0.9,
                              diurnal_period_s=7200.0),
        sizes=SizeConfig(median_gb=1.5, sigma=0.8, max_gb=12.0)),
    "bursty": TraceConfig(
        name="bursty", num_jobs=90,
        arrival=ArrivalConfig(rate_per_hour=90.0, burst_prob=0.35,
                              burst_size_mean=6.0, burst_stagger_s=2.0),
        sizes=SizeConfig(median_gb=1.5, sigma=0.7, max_gb=8.0)),
    "shuffle_heavy": TraceConfig(
        name="shuffle_heavy", num_jobs=40,
        mix=(("sort", 2.0), ("permutation", 2.0), ("wordcount", 1.0),
             ("inverted_index", 1.0), ("grep", 0.5)),
        arrival=ArrivalConfig(rate_per_hour=200.0),
        sizes=SizeConfig(median_gb=2.0, sigma=0.8, max_gb=10.0)),
    # the closed-mix bridge to the paper's §5 setting: every job submitted
    # within the first fraction of a second (arrival gaps ~5 ms), so the
    # cluster is saturated end-to-end and makespan is policy-dominated —
    # the regime where the paper measures its headline throughput gain
    "saturated": TraceConfig(
        name="saturated", num_jobs=40,
        arrival=ArrivalConfig(rate_per_hour=720_000.0),
        sizes=SizeConfig(median_gb=3.0, sigma=0.6, min_gb=1.0, max_gb=12.0)),
}
