"""The paper's MapReduce data plane on the card: its five workloads as map,
shuffle and reduce over blocks of tokens, the port of the JAX package's
``mapreduce/engine.py``.  The same job makes the same blocks, and each
workload gives the same ``[n_reducers, payload]`` int32 result, element for
element.

  map:     each block's tokens [T] -> partials [n_reducers, payload]
  shuffle: [blocks, reducers, payload] -> [reducers, blocks, payload]
  reduce:  the sum over blocks -> [reducers, payload]

The map runs over the blocks in chunks, so that its largest intermediate
(permutation's four shifted copies of a block, their keys and histogram
indices) stays within ``budget_bytes``; each chunk is shuffled and reduced,
and the chunks' sums added, which no chunk size changes (integers).  A
histogram is ``index_add_`` of ones at ``block * VOCAB + token``: int32
indices, exact sums.  The reference's ``map_sort`` also builds a
range-partition one-hot that it then deletes unused; that is not ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.models.common import resolve_device

VOCAB = 4096
# bytes of the map's intermediates per input token, at most: permutation's
# four rolled copies and their stack (32), the keys' block offsets (16), the
# tokens times 31 (4), rounded up
MAP_BYTES_PER_TOKEN = 64
MAP_BUDGET_BYTES = 1 << 30


@dataclass(frozen=True)
class MRJob:
    workload: str
    n_blocks: int
    block_tokens: int
    n_reducers: int
    seed: int = 0


def make_blocks(job: MRJob) -> np.ndarray:
    """The job's input, [n_blocks, block_tokens] int32 in [1, VOCAB): the JAX
    package's blocks for the same job."""
    rng = np.random.RandomState(job.seed)
    return rng.randint(1, VOCAB, size=(job.n_blocks, job.block_tokens),
                       dtype=np.int32)


# ---------------------------------------------------------------------------
# map fns: a chunk of blocks' tokens [c, T] -> partials [c, n_red, payload]
# ---------------------------------------------------------------------------


def _histograms(keys: torch.Tensor) -> torch.Tensor:
    """Counts of each value in [0, VOCAB) in each row of ``keys`` [c, K]:
    [c, VOCAB] int32."""
    c = keys.shape[0]
    offsets = torch.arange(c, dtype=torch.int32, device=keys.device)[:, None] * VOCAB
    index = (keys + offsets).view(-1)
    counts = torch.zeros(c * VOCAB, dtype=torch.int32, device=keys.device)
    ones = torch.ones(1, dtype=torch.int32, device=keys.device).expand(index.numel())
    return counts.index_add_(0, index, ones).view(c, VOCAB)


def map_wordcount(tokens: torch.Tensor, n_red: int) -> torch.Tensor:
    """Per-reducer histogram slices: [c, n_red, VOCAB // n_red]."""
    return _histograms(tokens).view(-1, n_red, VOCAB // n_red)


def map_grep(tokens: torch.Tensor, n_red: int, needle: int = 7) -> torch.Tensor:
    """The needle's count, at [needle % n_red, 0]: [c, n_red, 1]."""
    hits = (tokens == needle).sum(dim=1, dtype=torch.int32)
    out = torch.zeros((tokens.shape[0], n_red, 1), dtype=torch.int32,
                      device=tokens.device)
    out[:, needle % n_red, 0] = hits
    return out


def map_sort(tokens: torch.Tensor, n_red: int) -> torch.Tensor:
    """Range-partition counts (a counting sort's histogram): reducer r holds
    the counts of the r-th VOCAB // n_red values."""
    return _histograms(tokens).view(-1, n_red, VOCAB // n_red)


def map_permutation(tokens: torch.Tensor, n_red: int) -> torch.Tensor:
    """The histogram of (t * 31 + roll(t, s)) % VOCAB for s in 0..3, each
    block rolled within itself: a dense expansion four times the input."""
    c, T = tokens.shape
    keys = torch.stack([torch.roll(tokens, s, dims=1) for s in range(4)], dim=1)
    keys += (tokens * 31)[:, None]
    keys.remainder_(VOCAB)
    return _histograms(keys.view(c, 4 * T)).view(c, n_red, VOCAB // n_red)


def map_inverted_index(tokens: torch.Tensor, n_red: int) -> torch.Tensor:
    """Whether each value occurs in the block (a posting): [c, n_red, VOCAB // n_red]."""
    present = (_histograms(tokens) > 0).to(torch.int32)
    return present.view(-1, n_red, VOCAB // n_red)


def reduce_sum(parts: torch.Tensor) -> torch.Tensor:
    """[..., blocks, payload] -> [..., payload], int32."""
    return parts.sum(dim=-2, dtype=torch.int32)


WORKLOAD_FNS: Dict[str, Tuple[Callable, Callable]] = {
    "wordcount": (map_wordcount, reduce_sum),
    "grep": (map_grep, reduce_sum),
    "sort": (map_sort, reduce_sum),             # counting-sort histogram
    "permutation": (map_permutation, reduce_sum),
    "inverted_index": (map_inverted_index, reduce_sum),  # posting counts
}


def chunk_blocks(block_tokens: int, budget_bytes: int = MAP_BUDGET_BYTES) -> int:
    """Blocks a map call takes, so that its intermediates fit ``budget_bytes``
    (one at least)."""
    return max(1, budget_bytes // (MAP_BYTES_PER_TOKEN * block_tokens))


def run_mapreduce(job: MRJob, blocks=None, device="cuda",
                  budget_bytes: int = MAP_BUDGET_BYTES) -> torch.Tensor:
    """``job``'s result, [n_reducers, VOCAB // n_reducers] int32 (grep:
    [n_reducers, 1]) on ``device``: ``cuda`` unless the caller names another.
    ``blocks`` ([n_blocks, block_tokens] int32, numpy or a tensor) defaults
    to ``make_blocks(job)``; a tensor already on ``device`` is not copied."""
    if VOCAB % job.n_reducers:
        raise ValueError(f"n_reducers {job.n_reducers} does not divide VOCAB {VOCAB}")
    map_fn, red_fn = WORKLOAD_FNS[job.workload]
    device = resolve_device(device)
    if blocks is None:
        blocks = make_blocks(job)
    blocks = torch.as_tensor(blocks, device=device)
    step = chunk_blocks(blocks.shape[1], budget_bytes)
    out = None
    for c0 in range(0, blocks.shape[0], step):
        partials = map_fn(blocks[c0:c0 + step], job.n_reducers)   # [c, R, P]
        shuffled = partials.transpose(0, 1)                          # [R, c, P]
        part = red_fn(shuffled)                                      # [R, P]
        out = part if out is None else out.add_(part)
    return out
