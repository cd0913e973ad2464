"""The card's peaks and the least time of each hand-written kernel's call.

Peaks: NVIDIA's data sheet for the H100 SXM, dense rates without sparsity, at
the full 700 W.  A kernel's least time is the larger of the operations its
inputs need over the peak rate for their type and the bytes it must move
(each input read once, each output written once) over the memory rate.  The
counts are taken from the shapes of the call, so they hold whatever kernel
computes the call.

A call is described as the spans record it (``harness.trace.describe``): a
tensor as ``("T", shape, dtype name)``, anything else as its value.
"""
from __future__ import annotations

from typing import Optional, Sequence

PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

_SIZE = {"torch.bfloat16": 2, "torch.float16": 2, "torch.float32": 4}


def _numel(t) -> int:
    n = 1
    for s in t[1]:
        n *= s
    return n


def _bytes(t) -> int:
    return _numel(t) * _SIZE[t[2]]


def _peak(t) -> float:
    return PEAK_FP32_FLOPS if t[2] == "torch.float32" else PEAK_BF16_FLOPS


def least_s(flops: float, n_bytes: float, peak: float) -> float:
    return max(flops / peak, n_bytes / PEAK_BYTES_PER_S)


def visible_pairs(sq: int, skv: int, causal: bool, window: Optional[int]) -> int:
    """(query, key) pairs one head attends over, queries and keys aligned at
    the start (the kernels' convention)."""
    total = 0
    for i in range(sq):
        hi = min(i, skv - 1) if causal else skv - 1
        lo = max(0, i - window + 1) if window else 0
        total += max(0, hi - lo + 1)
    return total


def _pairs(sq, skv, causal, window):
    if window is None and sq == skv:
        return sq * (sq + 1) // 2 if causal else sq * skv
    return visible_pairs(sq, skv, causal, window)


def attention_fwd_s(q, k, v, causal: bool = True, window=None, return_lse=False) -> float:
    """K1: q, k, v read, the output (and the log-sum-exp) written; two
    products over the visible pairs, Q K^T at q's head dim and P V at v's."""
    B, Hq, Sq, D = q[1]
    Dv = v[1][-1]
    n_bytes = _bytes(q) + _bytes(k) + _bytes(v) + B * Hq * Sq * Dv * _SIZE[q[2]]
    n_bytes += B * Hq * Sq * 4 if return_lse else 0
    flops = 2 * B * Hq * (D + Dv) * _pairs(Sq, k[1][2], causal, window)
    return least_s(flops, n_bytes, _peak(q))


def attention_bwd_s(q, k, v, out, lse, do, causal: bool = True, window=None) -> float:
    """K1b: q, k, v, the output, its gradient and the log-sum-exp read; dq,
    dk, dv written; five products over the visible pairs (S, dQ and dK at q's
    head dim, dP and dV at v's)."""
    B, Hq, Sq, D = q[1]
    Dv = v[1][-1]
    n_bytes = (2 * _bytes(q) + _bytes(out) + _bytes(do) + 2 * (_bytes(k) + _bytes(v))
               + _bytes(lse))
    flops = 2 * B * Hq * (3 * D + 2 * Dv) * _pairs(Sq, k[1][2], causal, window)
    return least_s(flops, n_bytes, _peak(q))


def _chunk_pairs(S: int, chunk: int) -> int:
    rows = [min(chunk, S - c0) for c0 in range(0, S, chunk)]
    return sum(r * (r + 1) // 2 for r in rows)


def ssd_fwd_s(x, dt, A, B_, C, chunk: int, init_state=None, variant=None) -> float:
    """K2: x, dt, A, B, C (and the initial state) read, y and the final state
    written; C B^T once a group and the diagonal product per head over the
    pairs j <= i of each chunk, and the chunk states and the inter-chunk
    outputs, 2 P N each a row and head."""
    Bsz, S, H, P = x[1]
    G, N = B_[1][2], B_[1][3]
    n_bytes = (2 * _bytes(x) + _bytes(B_) + _bytes(C) + _bytes(dt) + _bytes(A)
               + Bsz * H * P * N * 4 + (0 if init_state is None else _bytes(init_state)))
    pairs = _chunk_pairs(S, chunk)
    flops = 2 * Bsz * (G * N * pairs + H * P * pairs + 2 * H * P * N * S)
    return least_s(flops, n_bytes, _peak(x))


def ssd_bwd_s(x, dt, A, B_, C, dy, chunk: int, init_state=None, d_final_state=None,
              variant=None) -> float:
    """K2b: x, dt, A, B, C, dy (and the initial state and the final state's
    gradient) read, dx, ddt, dA, dB, dC (and the initial state's gradient)
    written; over the pairs of each chunk C B^T, dC and dB once a group, dy u^T
    and du per head, and five state terms of 2 P N a row and head."""
    Bsz, S, H, P = x[1]
    G, N = B_[1][2], B_[1][3]
    states = 0 if init_state is None else 2 * _bytes(init_state)
    states += 0 if d_final_state is None else _bytes(d_final_state)
    n_bytes = (2 * _bytes(x) + _bytes(dy) + 2 * (_bytes(B_) + _bytes(C))
               + 2 * (_bytes(dt) + _bytes(A)) + states)
    pairs = _chunk_pairs(S, chunk)
    flops = 2 * Bsz * (3 * G * N * pairs + 2 * H * P * pairs + 5 * H * P * N * S)
    return least_s(flops, n_bytes, _peak(x))


def call_least_s(fn, call: Sequence) -> float:
    """``fn`` (one of the above) over a recorded call ``(args, kwargs)``."""
    args, kwargs = call
    return fn(*args, **kwargs)
