"""Baseline schedulers the paper evaluates against.

This is the port's own copy of the JAX package's ``core/baselines.py`` (pure
Python; a test holds it to the original).

* ``FairScheduler`` — Hadoop Fair Scheduler semantics [paper ref 3]: equal
  instantaneous share per active job; on each heartbeat the job furthest
  below its fair share is served first.  Optional *delay scheduling*
  [Zaharia, EuroSys'10 — paper ref 16]: a job skips up to ``locality_delay``
  scheduling opportunities while it has no local task on the offered node.
* ``FIFOScheduler`` — Hadoop default: submission order.

Neither baseline uses deadlines, the resource estimator, or the
reconfigurator — that is the paper's point of comparison.

Both run on the indexed ``SchedulerBase``: candidate lookup is amortized
O(1) via the per-job pending heaps and the per-node local-task index.  The
Fair deficit order is kept as a sorted list keyed by
``(running_slots, submit_time, admission_seq)`` — the seed implementation
re-sorted the submission-ordered active list with a stable sort on
``(running_slots, submit_time)`` after every launch, which is exactly this
total order, so only the launched job needs re-insertion (one bisect)
instead of an O(J log J) sort per launched task.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

from repro_torch.core.scheduler import Launch, SchedulerBase
from repro_torch.core.types import ClusterSpec, JobRuntime, TaskId, TaskKind


class FairScheduler(SchedulerBase):
    name = "fair"

    def __init__(self, spec: ClusterSpec, locality_delay: int = 0):
        super().__init__(spec)
        self.locality_delay = locality_delay
        self._skips: Dict[str, int] = {}

    def _running_slots(self, job: JobRuntime) -> int:
        return len(job.running_map) + len(job.running_reduce)

    def select(self, node: int, free_map: int, free_reduce: int,
               now: float) -> List[Launch]:
        if ((free_map <= 0 or self.total_pending_maps == 0)
                and (free_reduce <= 0 or self.ready_pending_reduces == 0)):
            return []
        jobs = self.active_jobs()
        if not jobs:
            return []
        out: List[Launch] = []
        by_seq = {j.seq: j for j in jobs}
        # deficit order: fewest running tasks relative to fair share
        entries: List[Tuple[int, float, int]] = sorted(
            (self._running_slots(j), j.spec.submit_time, j.seq) for j in jobs)
        while free_map > 0 or free_reduce > 0:
            launched: Optional[int] = None     # position in entries
            for pos, (_, _, seq) in enumerate(entries):
                job = by_seq[seq]
                jid = job.spec.job_id
                if free_map > 0 and not job.map_done:
                    idx = job.first_local_pending_map(node)
                    if idx is not None:
                        self._skips[jid] = 0
                        t = TaskId(jid, TaskKind.MAP, idx)
                        out.append(Launch(t, node, local=True))
                        self._start_map(job, idx, node)
                        job.local_map_launches += 1
                        free_map -= 1
                        launched = pos
                        break
                    if job.pending_map:
                        if self._skips.get(jid, 0) < self.locality_delay:
                            self._skips[jid] = self._skips.get(jid, 0) + 1
                            continue   # delay scheduling: wait for locality
                        self._skips[jid] = 0
                        idx = job.first_pending_map()
                        t = TaskId(jid, TaskKind.MAP, idx)
                        out.append(Launch(t, node, local=False))
                        self._start_map(job, idx, node)
                        job.remote_map_launches += 1
                        free_map -= 1
                        launched = pos
                        break
                if free_reduce > 0 and job.map_done and not job.all_done:
                    if job.pending_reduce:
                        idx = job.first_pending_reduce()
                        t = TaskId(jid, TaskKind.REDUCE, idx)
                        out.append(Launch(t, node, local=True))
                        self._start_reduce(job, idx, node)
                        free_reduce -= 1
                        launched = pos
                        break
            if launched is None:
                break
            _, _, seq = entries.pop(launched)
            job = by_seq[seq]
            bisect.insort(entries, (self._running_slots(job),
                                    job.spec.submit_time, seq))
        return out


class FIFOScheduler(SchedulerBase):
    name = "fifo"

    def select(self, node: int, free_map: int, free_reduce: int,
               now: float) -> List[Launch]:
        if ((free_map <= 0 or self.total_pending_maps == 0)
                and (free_reduce <= 0 or self.ready_pending_reduces == 0)):
            return []
        out: List[Launch] = []
        for job in self.active_jobs():
            jid = job.spec.job_id
            while free_map > 0 and not job.map_done:
                local_idx = job.first_local_pending_map(node)
                idx = (local_idx if local_idx is not None
                       else job.first_pending_map())
                if idx is None:
                    break
                is_local = local_idx is not None
                out.append(Launch(TaskId(jid, TaskKind.MAP, idx), node,
                                  local=is_local))
                self._start_map(job, idx, node)
                if is_local:
                    job.local_map_launches += 1
                else:
                    job.remote_map_launches += 1
                free_map -= 1
            while (free_reduce > 0 and job.map_done and not job.all_done):
                if not job.pending_reduce:
                    break
                idx = job.first_pending_reduce()
                out.append(Launch(TaskId(jid, TaskKind.REDUCE, idx), node,
                                  local=True))
                self._start_reduce(job, idx, node)
                free_reduce -= 1
            if free_map <= 0 and free_reduce <= 0:
                break
        return out
