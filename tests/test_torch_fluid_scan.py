"""K3's two CUDA variants, as far as the CPU can check them.

``fluid_scan_warp`` takes every sum of a cell on one warp: lane l owns jobs
l + 32 r (register r is row r of ``ref._tree_sum``'s rows), each row is
halved by an xor butterfly, the rows by halving in registers, and the
priority allocator's prefix sum is the Hillis-Steele scan by shuffles.  A
numpy model of that schedule, lane by lane, must give the bits of the plain
version's ``_tree_sum`` and ``_cumsum``, which ``fluid_scan_block`` and the
plain version share; on the card ``chip_smoke.py`` holds both variants to
the plain version bit for bit.  Here also: the variant rule, the refusals
of ``variant=``, and the C source's constants and names against the Python
ones.
"""
from __future__ import annotations

import re

import numpy as np
import pytest
import torch

from repro_torch.kernels.fluid_scan import kernel as k3
from repro_torch.kernels.fluid_scan import ref as k3ref
from repro_torch.simcluster import surrogate as tsur

LANES = 32
BUCKETS = (8, 16, 32, 64, 128)


def _data(n: int, seed: int) -> np.ndarray:
    """fp32 values whose sums depend on their order: wide magnitudes, zeros,
    and a run of values 2^-20 apart."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * 2.0 ** rng.integers(-12, 12, n)).astype(np.float32)
    x[rng.random(n) < 0.2] = 0.0
    run = rng.choice(n, size=n // 4, replace=False)
    x[run] = (1.0 + np.arange(len(run)) * 2.0 ** -20).astype(np.float32)
    return x


def _to_lanes(x: np.ndarray) -> np.ndarray:
    """regs[r, l] = x[l + 32 r]; below 32 jobs the lanes past the bucket
    hold padding (NaN here: nothing of theirs may reach a real lane)."""
    n = x.shape[0]
    rows = max(n // LANES, 1)
    regs = np.full((rows, LANES), np.nan, dtype=np.float32)
    regs.reshape(-1)[:n] = x
    return regs


def _shfl(regs: np.ndarray, src: np.ndarray) -> np.ndarray:
    """__shfl_sync on every row: lane l gets row r's value at lane src[l]."""
    return regs[:, src]


def warp_sum(x: np.ndarray) -> np.ndarray:
    """The warp variant's sum, lane by lane: an xor butterfly over each row
    (offsets width / 2 down to 1, width = min(Jp, 32)), lane 0's sum sent to
    every lane below 32 jobs, then the rows halved in registers.  Returns
    what each of the 32 lanes holds."""
    regs = _to_lanes(x)
    width = min(x.shape[0], LANES)
    lane = np.arange(LANES)
    off = width // 2
    while off > 0:
        regs = regs + _shfl(regs, lane ^ off)
        off //= 2
    if width < LANES:
        regs = _shfl(regs, np.zeros(LANES, dtype=int))
    while regs.shape[0] > 1:
        h = regs.shape[0] // 2
        regs = regs[:h] + regs[h:]
    return regs[0]


def warp_cumsum(x: np.ndarray) -> np.ndarray:
    """The warp variant's inclusive prefix sum, lane by lane: position
    p = l + 32 r takes cur[p] + cur[p - s]; for s < 32 the term is a shuffle
    of row r from lane (l - s) mod 32, or of row r - 1 for lanes below s;
    for s >= 32 it is row r - s / 32 of the same lane."""
    n = x.shape[0]
    cur = _to_lanes(x)
    rows = cur.shape[0]
    lane = np.arange(LANES)
    s = 1
    while s < n:
        nxt = cur.copy()
        if s < LANES:
            sh = _shfl(cur, (lane - s) & (LANES - 1))
            for r in range(rows):
                up = lane >= s
                nxt[r, up] = cur[r, up] + sh[r, up]
                if r > 0:
                    nxt[r, ~up] = cur[r, ~up] + sh[r - 1, ~up]
        else:
            rs = s // LANES
            for r in range(rs, rows):
                nxt[r] = cur[r] + cur[r - rs]
        cur = nxt
        s *= 2
    return cur.reshape(-1)[:n]


@pytest.mark.parametrize("jp", BUCKETS)
def test_warp_schedule_sums_in_the_plain_version_s_order(jp):
    for seed in range(8):
        x = _data(jp, seed)
        want = k3ref._tree_sum(torch.from_numpy(x)).numpy()
        got = warp_sum(x)
        # every lane holds the plain version's bits: the allocators' control
        # flow, which reads the sums on every lane, stays uniform
        assert np.array_equal(got.view(np.int32), np.full(LANES, want).view(np.int32))
    # the data is not blind to order: halving the rows the other way round,
    # (r0 + r1) + (r2 + r3), moves some of these sums at 128 jobs
    if jp == 128:
        moved = 0
        for seed in range(8):
            x = _data(jp, seed)
            rows = x.reshape(4, 32)
            while rows.shape[1] > 1:
                h = rows.shape[1] // 2
                rows = rows[:, :h] + rows[:, h:]
            other = (rows[0, 0] + rows[1, 0]) + (rows[2, 0] + rows[3, 0])
            moved += other != warp_sum(x)[0]
        assert moved > 0


@pytest.mark.parametrize("jp", BUCKETS)
def test_warp_schedule_scans_in_the_plain_version_s_order(jp):
    for seed in range(8):
        x = _data(jp, seed)
        want = k3ref._cumsum(torch.from_numpy(x)[None])[0].numpy()
        got = warp_cumsum(x)
        assert np.array_equal(got.view(np.int32), want.view(np.int32))
        assert not np.isnan(got).any()


def test_variant_rule():
    for e in range(3, 12):
        jp = 2 ** e
        assert k3.takes(jp)
        want = "fluid_scan_warp" if jp <= 128 else "fluid_scan_block"
        assert k3.variant(jp) == want
    assert set(k3.VARIANT_KERNELS) == set(k3.VARIANT_CODES)
    for jp in (4, 12, 100, 4096):
        assert not k3.takes(jp)
        with pytest.raises(ValueError, match="no kernel"):
            k3.variant(jp)


def _inputs(jp: int):
    jobs = torch.zeros((2, len(k3ref.JOB_FIELDS), jp), dtype=torch.float32)
    order = torch.arange(jp, dtype=torch.int32).repeat(2, 1)
    scalars = torch.zeros((2, len(k3ref.SCALAR_FIELDS)), dtype=torch.float32)
    return jobs, order, scalars


@pytest.mark.parametrize("name,jp", [("fluid_scan_tile", 64), ("warp", 64),
                                     ("fluid_scan_warp", 256),
                                     ("fluid_scan_warp", 2048)])
def test_named_variant_that_does_not_take_the_bucket_raises(name, jp, monkeypatch):
    def no_load():
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(k3, "load", no_load)
    jobs, order, scalars = _inputs(jp)
    with pytest.raises(ValueError, match="has no kernel"):
        k3.fluid_scan_cuda(jobs, order, scalars, tsur.PHYSICS, n_steps=256, variant=name)


@pytest.mark.parametrize("name,jp", [("fluid_scan_warp", 8), ("fluid_scan_warp", 128),
                                     ("fluid_scan_block", 8), ("fluid_scan_block", 2048)])
def test_named_variant_that_takes_the_bucket_still_needs_the_card(name, jp, monkeypatch):
    def no_load():
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(k3, "load", no_load)
    jobs, order, scalars = _inputs(jp)
    with pytest.raises(ValueError, match="CUDA tensors"):
        k3.fluid_scan_cuda(jobs, order, scalars, tsur.PHYSICS, n_steps=256, variant=name)


def _body(src: str, signature: str) -> str:
    """The text of the one function whose definition starts with
    `signature`, to its closing brace at the start of a line."""
    at = src.index(signature)
    return src[at:src.index("\n}\n", at)]


def test_cuda_source_names_and_constants_match_the_python_ones():
    src = k3.SOURCE.read_text()
    assert int(re.search(r"constexpr int kWarpMaxJobs = (\d+);", src).group(1)) \
        == k3.WARP_MAX_JOBS
    assert k3.WARP_MAX_JOBS <= k3.SMEM_RING_JOBS
    enum = re.search(r"enum FluidVariant \{([^}]*)\}", src).group(1)
    codes = {m.group(1): int(m.group(2))
             for m in re.finditer(r"kVariant(\w+) = (\d+)", enum)}
    assert {f"fluid_scan_{k.lower()}": v for k, v in codes.items()} == k3.VARIANT_CODES
    table = re.search(r"kKernelNames\[kNumKernels\] = \{([^}]*)\}", src).group(1)
    names = re.findall(r'"(\w+)"', table)
    assert sorted(names) == sorted({k for ks in k3.VARIANT_KERNELS.values() for k in ks})
    for name in names:
        assert re.search(rf"__global__ void __launch_bounds__\(\w+\) {name}\(", src), name


def test_warp_variant_has_no_block_barrier():
    """No __syncthreads (nor any block-wide barrier) in the warp kernel or in
    any device function it reaches: its sums and scans are shuffles, its
    shared scratch is the warp's own."""
    src = k3.SOURCE.read_text()
    texts = {"fluid_scan_warp": _body(src, "__global__ void __launch_bounds__(32) fluid_scan_warp(")}
    todo = ["fluid_scan_warp"]
    while todo:
        for name in re.findall(r"\b(warp_\w+|halve)\s*[<(]", texts[todo.pop()]):
            if name not in texts:
                texts[name] = _body(src, re.search(rf"__device__[^;{{]*? {name}\(", src).group(0))
                todo.append(name)
    assert {"warp_sum", "warp_ring_sum", "warp_live_ring_sum", "warp_allocate",
            "warp_fair_waterfill", "warp_priority_alloc", "halve"} <= set(texts)
    for name, text in texts.items():
        for barrier in ("__syncthreads", "bar.sync", "barrier.sync", "this_grid",
                        "this_thread_block"):
            assert barrier not in text, (name, barrier)
