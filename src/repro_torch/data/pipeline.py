"""Deterministic synthetic token pipeline with host-local shard placement.

The port's own copy of the JAX package's ``data/pipeline.py`` (numpy only;
the port imports nothing of that package; a test holds the two to the same
batches and the same locality).  It yields numpy arrays: the caller moves
each batch to its device.

The framework analogue of HDFS blocks: the corpus is split into numbered
shards; each shard is assigned to specific *hosts*.  A job's data-parallel
workers read the shards local to their host, the way the paper's Algorithm 1
uses HDFS block locations.

Synthetic corpus: deterministic PRNG tokens (zipfian ranks) so any shard is
reproducible from (seed, shard_id) alone: no I/O, but the locality
bookkeeping is real.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    num_shards: int = 256
    seed: int = 0
    zipf_a: float = 1.2          # token-rank distribution


def host_shard_assignment(num_shards: int, num_hosts: int,
                          replication: int = 1,
                          seed: int = 0) -> List[Tuple[int, ...]]:
    """shard -> tuple of hosts holding a replica (round-robin + offset)."""
    rng = np.random.RandomState(seed)
    out = []
    for s in range(num_shards):
        primary = s % num_hosts
        extra = rng.choice([h for h in range(num_hosts) if h != primary],
                           size=min(replication - 1, num_hosts - 1),
                           replace=False).tolist() if replication > 1 else []
        out.append(tuple([primary] + extra))
    return out


class ShardedDataset:
    """Deterministic synthetic shards + locality accounting."""

    def __init__(self, cfg: DataConfig, num_hosts: int, replication: int = 1):
        self.cfg = cfg
        self.num_hosts = num_hosts
        self.placement = host_shard_assignment(
            cfg.num_shards, num_hosts, replication, cfg.seed)
        self.local_reads = 0
        self.remote_reads = 0

    def shard_tokens(self, shard_id: int, n_seqs: int) -> np.ndarray:
        """[n_seqs, seq_len] int32 — reproducible from (seed, shard_id)."""
        rng = np.random.RandomState((self.cfg.seed * 100003 + shard_id) % 2**31)
        # zipf ranks clipped into the vocab
        toks = rng.zipf(self.cfg.zipf_a, size=(n_seqs, self.cfg.seq_len))
        return (toks % (self.cfg.vocab_size - 1) + 1).astype(np.int32)

    def read(self, shard_id: int, n_seqs: int, reader_host: int) -> np.ndarray:
        if reader_host in self.placement[shard_id]:
            self.local_reads += 1
        else:
            self.remote_reads += 1
        return self.shard_tokens(shard_id, n_seqs)

    def locality_rate(self) -> float:
        tot = self.local_reads + self.remote_reads
        return self.local_reads / tot if tot else 1.0


def make_batch_iter(ds: ShardedDataset, *, hosts: Sequence[int],
                    step0: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Round-robin over the job's assigned hosts' local shards.

    Yields {tokens, labels} with labels = tokens shifted left (next-token)."""
    cfg = ds.cfg
    # shards local to this job's hosts, in deterministic order
    local = [s for s in range(cfg.num_shards)
             if any(h in ds.placement[s] for h in hosts)]
    if not local:
        local = list(range(cfg.num_shards))
    step = step0
    while True:
        shard = local[step % len(local)]
        host = next(h for h in hosts if h in ds.placement[shard]) \
            if any(h in ds.placement[shard] for h in hosts) else hosts[0]
        toks = ds.read(shard, cfg.global_batch, host)
        labels = np.concatenate([toks[:, 1:], toks[:, :1]], axis=1)
        yield {"tokens": toks, "labels": labels}
        step += 1
