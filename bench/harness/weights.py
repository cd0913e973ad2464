"""Weights and inputs of a run, made from ``--seed``.

The weights take the structure, shapes and dtypes of the tree that the
program's ``init`` returns (read on the ``meta`` device, so nothing is
allocated), and their values from the benchmark's own rule below: one
``normal_`` call per dtype over one flat buffer on the device, then each
leaf scaled in place.  The same seed on the same device gives the same bits,
so the reference is handed weights made again from the seed, never the
program's.
"""
from __future__ import annotations

import hashlib
import math
from typing import Callable, Dict, List, Tuple

import torch

# the largest number of elements one normal_ call fills
_CHUNK = 1 << 28
# the last key of leaves filled with ones: norm scales, Mamba-2's skip D
_ONES = ("scale", "D")
# the last key of output projections, scaled down by the depth
_OUT = ("wo", "w_down", "w_out")


def sub_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one stream (weights, tokens, sample) of ``seed``."""
    digest = hashlib.sha256(f"{seed}:{stream}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, stream: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, stream))


def named_leaves(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every leaf of a tree of dicts and lists: dict keys
    sorted, lists in order, paths joined by ``/``."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    items = ([(k, tree[k]) for k in sorted(tree)] if isinstance(tree, dict)
             else list(enumerate(tree)))
    out = []
    for key, sub in items:
        out += named_leaves(sub, f"{prefix}/{key}" if prefix else str(key))
    return out


def map_tree(fn: Callable, tree, prefix: str = ""):
    """A tree of ``tree``'s structure holding ``fn(path, leaf)``."""
    if isinstance(tree, torch.Tensor):
        return fn(prefix, tree)
    if isinstance(tree, dict):
        return {k: map_tree(fn, tree[k], f"{prefix}/{k}" if prefix else str(k))
                for k in sorted(tree)}
    return [map_tree(fn, v, f"{prefix}/{i}" if prefix else str(i))
            for i, v in enumerate(tree)]


def _fill(path: str, w: torch.Tensor, depth: int, gen: torch.Generator) -> None:
    """The rule: ``w`` holds standard normal values on entry."""
    key = path.rsplit("/", 1)[-1]
    if key in _ONES:
        w.fill_(1.0)
    elif key == "A_log":                       # A = -exp(A_log) in [-16, -1]
        w.uniform_(1.0, 16.0, generator=gen).log_()
    elif key == "dt_bias":                     # softplus^-1 of dt in [1e-3, 0.1]
        dt = w.float().uniform_(math.log(1e-3), math.log(0.1), generator=gen).exp_()
        w.copy_(dt + torch.log(-torch.expm1(-dt)))
    elif key == "tok":                         # the embedding table
        w.mul_(0.02)
    elif key.startswith("lora"):
        w.mul_(0.01)
    elif w.ndim >= 2:                          # [.., fan_in, fan_out]
        scale = 1.0 / math.sqrt(w.shape[-2])
        w.mul_(scale / math.sqrt(2 * depth) if key in _OUT else scale)
    else:
        w.mul_(0.02)


def make(meta_tree, seed: int, device, depth: int):
    """Weights in ``meta_tree``'s structure, on ``device``, from ``seed``.
    Each dtype's leaves are views of one buffer, filled by ``normal_`` in a
    few large calls; ``depth`` scales the output projections."""
    named = named_leaves(meta_tree)
    gen = generator(seed, "weights", device)
    by_dtype: Dict[torch.dtype, int] = {}
    for _, m in named:
        by_dtype[m.dtype] = by_dtype.get(m.dtype, 0) + m.numel()
    buffers, offsets = {}, {}
    for dtype in sorted(by_dtype, key=str):
        buf = torch.empty(by_dtype[dtype], dtype=dtype, device=device)
        for start in range(0, buf.numel(), _CHUNK):
            buf[start:start + _CHUNK].normal_(generator=gen)
        buffers[dtype], offsets[dtype] = buf, 0

    def leaf(path, m):
        o = offsets[m.dtype]
        offsets[m.dtype] = o + m.numel()
        w = buffers[m.dtype][o:o + m.numel()].view(m.shape)
        _fill(path, w, depth, gen)
        return w

    return map_tree(leaf, meta_tree)


def to_host(tree):
    """A copy of ``tree`` in host memory, leaf by leaf."""
    return map_tree(lambda _, w: w.to("cpu"), tree)


def tokens(seed: int, stream: str, shape, vocab: int, device) -> torch.Tensor:
    """Token ids uniform over the vocabulary, from ``seed``'s ``stream``."""
    return torch.randint(0, vocab, tuple(shape), generator=generator(seed, stream, device),
                         device=device)
