"""The paper's five MapReduce workloads (§5) as simulator profiles + the
experiment job mixes.

Profiles are calibrated to 2012-era Hadoop on commodity nodes (128 MB block,
map task ≈ 20–40 s — the paper notes "tasks ... will be finished in less than
a minute"); the *relative* characteristics follow the paper's description:

* Grep — tiny intermediate data (shuffle-light)
* Word Count — moderate intermediate data
* Sort — identity map/reduce, shuffle ≈ input
* Permutation Generator — reduce-input-heavy (large intermediate data); the
  paper predicts ≈ no gain for it under the proposed scheduler (Fig. 3)
* Inverted Index — moderate-heavy intermediate

u_m = ⌈GB × 8⌉ map tasks (128 MB blocks); v_r per workload below.

This is the port's own copy of the JAX package's ``simcluster/workloads.py``
(pure Python; a test holds it to the original).
"""
from __future__ import annotations

import math
import random
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.types import ClusterSpec, JobSpec, WorkloadProfile

_BASE_COPY = 0.012     # s per mapper->reducer copy per GB-normalized stream
# remote_penalty=1.0: on 2012-era shared 1GbE a non-local map reads its
# 128 MB block over the network while shuffles compete -- ~2x map time
# (paper refs [10][16][17]: locality affects throughput 'considerably').

WORKLOADS: Dict[str, WorkloadProfile] = {
    "grep": WorkloadProfile(
        name="grep", map_time=20.0, reduce_time=8.0,
        shuffle_time_per_pair=_BASE_COPY * 0.2, intermediate_ratio=0.05,
        remote_penalty=1.0),
    "wordcount": WorkloadProfile(
        name="wordcount", map_time=30.0, reduce_time=12.0,
        shuffle_time_per_pair=_BASE_COPY, intermediate_ratio=0.8,
        remote_penalty=1.0),
    "sort": WorkloadProfile(
        name="sort", map_time=22.0, reduce_time=20.0,
        shuffle_time_per_pair=_BASE_COPY * 1.6, intermediate_ratio=1.0,
        remote_penalty=1.0),
    "permutation": WorkloadProfile(
        name="permutation", map_time=25.0, reduce_time=35.0,
        shuffle_time_per_pair=_BASE_COPY * 4.0, intermediate_ratio=4.0,
        remote_penalty=1.0),
    "inverted_index": WorkloadProfile(
        name="inverted_index", map_time=35.0, reduce_time=15.0,
        shuffle_time_per_pair=_BASE_COPY * 1.2, intermediate_ratio=1.2,
        remote_penalty=1.0),
}

_REDUCE_FRACTION = {          # v_r relative to u_m
    "grep": 0.15, "wordcount": 0.25, "sort": 0.5,
    "permutation": 0.6, "inverted_index": 0.3,
}


def n_map_tasks(input_gb: float) -> int:
    return max(1, int(math.ceil(input_gb * 8)))     # 128 MB blocks


def n_reduce_tasks(workload: str, input_gb: float) -> int:
    return max(1, int(round(n_map_tasks(input_gb) * _REDUCE_FRACTION[workload])))


def place_blocks(u_m: int, spec: ClusterSpec, rng: random.Random,
                 replication: Optional[int] = None,
                 skew: float = 0.0) -> List[Tuple[int, ...]]:
    """HDFS-style placement: `replication` distinct VMs per block.

    ``skew`` > 0 draws the primary machine from a power-law (weights
    (i+1)^-skew) — the hot/cold imbalance of real small virtual clusters
    (datanodes filling up, VM images co-placed) that the paper's
    reconfiguration mechanism targets.  0 = uniform."""
    r = replication or spec.replication
    nodes = list(range(spec.num_nodes))
    if skew <= 0:
        return [tuple(rng.sample(nodes, min(r, len(nodes)))) for _ in range(u_m)]
    # VM-level power-law skew with a per-job permutation of VM hotness:
    # VMs sharing a machine end up with *different* local demand, which is
    # exactly the imbalance Algorithm 1's intra-machine core transfer targets
    # (the paper's multi-tenant virtual clusters).
    perm = nodes[:]
    rng.shuffle(perm)
    weights = [(i + 1.0) ** -skew for i in range(len(perm))]
    out = []
    for _ in range(u_m):
        placed: List[int] = []
        while len(placed) < min(r, len(nodes)):
            vm = perm[rng.choices(range(len(perm)), weights=weights)[0]]
            if vm not in placed:
                placed.append(vm)
        out.append(tuple(placed))
    return out


def make_job(job_id: str, workload: str, input_gb: float, deadline: float,
             spec: ClusterSpec, rng: random.Random,
             submit_time: float = 0.0, skew: float = 0.0) -> JobSpec:
    u_m = n_map_tasks(input_gb)
    return JobSpec(
        job_id=job_id,
        profile=WORKLOADS[workload],
        u_m=u_m,
        v_r=n_reduce_tasks(workload, input_gb),
        deadline=deadline,
        submit_time=submit_time,
        input_size_gb=input_gb,
        block_placement=place_blocks(u_m, spec, rng, skew=skew),
    )


def default_deadline(workload: str, input_gb: float,
                     slack: float = 2.2) -> float:
    """A deadline proportional to the single-wave serial estimate / cluster."""
    prof = WORKLOADS[workload]
    u_m = n_map_tasks(input_gb)
    v_r = n_reduce_tasks(workload, input_gb)
    # rough two-wave estimate on ~20 map slots
    est = (u_m * prof.map_time / 20.0
           + v_r * (prof.reduce_time + u_m * prof.shuffle_time_per_pair) / 10.0)
    return slack * est + 120.0


# -- paper-calibrated cluster (§5): 20 machines, 2 VMs each, per-VM virtual
# disks (=> effective replication 1), skewed VM-level block distribution.
PAPER_SKEW = 1.0


def paper_cluster() -> ClusterSpec:
    return ClusterSpec(replication=1)


def paper_job_mix(spec: ClusterSpec, sizes_gb: Sequence[float] = (2, 4, 6, 8, 10),
                  seed: int = 0, stagger: float = 15.0,
                  skew: float = PAPER_SKEW) -> List[JobSpec]:
    """Fig.-2 experiment: all five workloads at each input size."""
    rng = random.Random(seed)
    jobs = []
    t = 0.0
    for size in sizes_gb:
        for w in WORKLOADS:
            jobs.append(make_job(f"{w}-{size}gb", w, size,
                                 default_deadline(w, size), spec, rng,
                                 submit_time=t, skew=skew))
            t += stagger
    return jobs


# the paper's Table-2 (workload, input GB, deadline s) rows — the evaluation
# job mix that Fig. 3 and the throughput-gain claim are measured on
PAPER_TABLE2_ROWS: Tuple[Tuple[str, int, float], ...] = (
    ("grep", 10, 650.0),
    ("wordcount", 5, 520.0),
    ("sort", 10, 500.0),
    ("permutation", 4, 850.0),
    ("inverted_index", 8, 720.0),
)


def paper_table2_jobs(spec: ClusterSpec, seed: int = 0,
                      skew: float = PAPER_SKEW) -> List[JobSpec]:
    """Table-2 experiment: the paper's (job, deadline, size) rows."""
    rng = random.Random(seed)
    return [make_job(f"{w}-t2", w, gb, dl, spec, rng, skew=skew)
            for (w, gb, dl) in PAPER_TABLE2_ROWS]
