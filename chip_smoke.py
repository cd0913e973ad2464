#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on the GPU.

    python3 chip_smoke.py [--verbose-build]

Needs one NVIDIA Hopper card, `nvcc` and nothing else; no network.  It builds
the port's kernels (flash attention forward and backward, the Mamba-2 SSD
scan) from the sources in this checkout, holds each against its plain
PyTorch version on the card (naming the CUDA kernels that each call launched,
as the C functions count them), serves tinyllama-1.1b and mamba2-1.3b at full
width (random weights from a seed: batch 8 x prompt 1024, 64 generated
tokens) through the port's prefill and decode steps, times the attention
backward in turns against its earlier variant and PyTorch's fused backends,
trains tinyllama-1.1b at full width and depth (batch 8 x 1024, a few AdamW
steps through the port's train step), holds the kernel paths against the
dense paths (fp32, and bf16 for the gradients), and checks the results.
Every phase prints one JSON line; any failure raises, so the exit code is
not 0.  The last line is `{"ok": true, "device": {...}}`.  Without a CUDA
device it prints no result and exits with code 1.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense, 700 W).
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# (B, Hq, Hkv, Sq, Skv, D) x (causal, window): the sweep of the JAX package's
# kernel tests, and one case at the head dim 80 that stablelm-3b has at full
# width; causal cases need Sq == Skv there and are left out otherwise.
SWEEP_SHAPES = [
    (1, 1, 1, 64, 64, 64),
    (2, 4, 2, 130, 130, 64),      # GQA + ragged
    (1, 2, 2, 97, 257, 128),      # cross lengths (non-causal)
    (2, 4, 2, 300, 300, 128),     # GQA + ragged at head dim 128, every mask
    (1, 8, 1, 64, 64, 32),        # MQA
    (2, 4, 4, 150, 150, 80),      # stablelm-3b's head dim, ragged
]
SWEEP_MASKS = [(True, None), (False, None), (True, 48)]
# relative to max|plain|, for attention's output and for the SSD scan's y and
# final state alike
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}

# The backward (K1b): (B, Hq, Hkv, Sq, Skv, D) x (causal, window), at every
# head dim, GQA and MQA, ragged lengths, Sq != Skv both ways, and a window
# that leaves the later rows of a short kv without a key (zero gradient)
BWD_SHAPES = [
    (1, 2, 2, 64, 64, 32),
    (2, 4, 2, 130, 130, 64),      # GQA + ragged
    (1, 8, 1, 97, 160, 64),       # MQA, Skv > Sq
    (2, 4, 4, 150, 150, 80),      # stablelm-3b's head dim, ragged
    (2, 4, 2, 200, 200, 128),     # GQA + ragged at head dim 128
    (1, 8, 2, 96, 40, 32),        # Skv < Sq
    # the edges of the wgmma variant (128-row items, 64-row tiles), at both
    # of its head dims
    (1, 2, 2, 40, 40, 64),        # Sq below one tile
    (1, 2, 1, 40, 40, 128),
    (1, 4, 2, 257, 257, 64),      # neither length a multiple of 128
    (1, 4, 2, 257, 130, 128),     # and Skv < Sq
    (1, 16, 1, 300, 300, 64),     # MQA, a group of 16
    (1, 16, 1, 300, 300, 128),
]
BWD_MASKS = [(True, None), (False, None), (True, 48), (False, 16)]
# dq, dk, dv relative to max|plain|: fp32 sums in another order than the
# plain version's over up to 200 keys and 4 query heads a KV head; bf16
# rounds P and dS to bf16 for the second products
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# the training shape: tinyllama-1.1b's attention at batch 8 x sequence 1024;
# and llama3.2-3b's at head dim 128, the wgmma backward's other head dim
TRAIN_ATTN_SHAPE = (8, 32, 4, 1024, 1024, 64)
BWD_D128_SHAPE = (8, 24, 8, 1024, 1024, 128)
# PyTorch's fused attention backends whose backward is timed as the library
# call (the fastest one is library_ms)
SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION")
# bf16 training parity: each gradient leaf, kernel path against dense path
BF16_GRAD_TOL = 5e-2

# (B, S, H, P, G, N, chunk) of the SSD scan: the sweep of the JAX package's
# kernel tests (the fp32-pipe kernel in both types), then chunks 64, 128 (the
# JAX kernel's default) and 256 (the model's) at mamba2-1.3b's P and N (the
# tensor-core kernel in bf16), with groups and ragged last chunks.
SSD_SHAPES = [
    (1, 64, 2, 16, 1, 8, 32),
    (2, 100, 4, 16, 2, 8, 32),    # ragged + groups
    (1, 256, 8, 32, 8, 16, 64),
    (2, 200, 2, 64, 1, 128, 64),   # ragged, the smallest chunk of the mma path
    (2, 384, 4, 64, 1, 128, 128),
    (2, 512, 4, 64, 2, 128, 256),
    (1, 700, 4, 64, 1, 128, 256),  # ragged
]
SSD_INIT_STATE = {1, 5}            # cases also run from a random initial state

# K1 at llama3.2-3b's full width (head dim 128, 24 / 8 heads), timed beside the
# main path's shape: the other head dim of the wgmma kernel
K1_D128_SHAPE = (8, 24, 8, 1024, 1024, 128)

# The main paths: each arch served at batch 8 x prompt 1024, 64 generated tokens.
SERVE_ARCHS = ("tinyllama-1.1b", "mamba2-1.3b")
BATCH, PROMPT_LEN, GEN = 8, 1024, 64
SEED = 0
# decode(token S) after prefill(S) against prefill(S + 1), in bf16 through 22
# or 48 layers: the two sides round at different places (attention: bf16
# probabilities over a bf16 cache against fp32 ones; SSD: the chunked scan's
# bf16 y against the recurrent step's), relative to max|logit|
DECODE_TOL = 5e-2
PARITY_TOL = 2e-4     # fp32, kernel path against dense path, 2 layers
# full-width configs for that: the main paths', and the one whose head dim
# (80), partial rotary and layer norm tinyllama does not have
PARITY_ARCHS = ("tinyllama-1.1b", "stablelm-3b", "mamba2-1.3b")

# The training path: tinyllama-1.1b at full width and depth, bf16, remat
# "full" (the config's), batch 8 x sequence 1024, one warm-up step and then
# TRAIN_STEPS timed AdamW steps, all on the first batch of the synthetic
# pipeline, so the loss must fall from timed step to timed step, and end
# below the warm-up step's.  A first Adam step from random weights moves
# every weight by about lr in its gradient's sign, and raises the loss on
# both attention paths and with fp32 weights too; larger lrs without warm-up
# swing wider (scripts/train_lr_sweep.py), so these steps take a small one
TRAIN_ARCH = "tinyllama-1.1b"
TRAIN_STEPS = 3
TRAIN_OPT = dict(lr=1e-5, warmup_steps=0)
# Adam's update lr·m̂/(√v̂ + eps) is ill-conditioned where the gradient (after
# the clip) is within a hundred eps of zero: a difference at rounding level
# there moves an element by up to 2 lr.  The on-card parity of the updated
# params counts such elements and holds the rest to PARITY_TOL.
NEAR_ZERO_GRAD = 1e-6


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of one call, by CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def visible_pairs(sq: int, skv: int, causal: bool, window) -> int:
    """Number of (query, key) pairs one head attends over."""
    qpos = torch.arange(sq)[:, None]
    kpos = torch.arange(skv)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= qpos - kpos < window
    return int(mask.sum())


def attention_bound_ms(q, k, v, causal, window):
    """Least time the card could take: the larger of bytes moved (q, k, v read
    once, o written once) over the memory rate and operations (two products
    over the visible pairs) over the peak rate for the type."""
    B, Hq, Sq, D = q.shape
    n_bytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    flops = 4 * B * Hq * D * visible_pairs(Sq, k.shape[2], causal, window)
    peak = PEAK_BF16_FLOPS if q.dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def ssd_bound_ms(x, dt, A, B_, C, chunk, init_state=None):
    """Least time the card could take for the SSD scan: the larger of bytes
    moved (x, dt, A, B, C and init_state read once, y and the final state
    written once) over the memory rate and operations over the peak rate for
    x's type.  Operations are what these inputs need: C.B^T once per group and
    the diagonal product per head over the pairs j <= i of each chunk, and the
    chunk states and the inter-chunk outputs, 2 P N each per row and head."""
    Bsz, S, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    n_bytes = (2 * x.numel() + B_.numel() + C.numel()) * x.element_size() \
        + (dt.numel() + A.numel() + Bsz * H * P * N) * 4 \
        + (0 if init_state is None else init_state.numel() * 4)
    rows = [min(chunk, S - c0) for c0 in range(0, S, chunk)]
    pairs = sum(q * (q + 1) // 2 for q in rows)
    flops = 2 * Bsz * (G * N * pairs + H * P * pairs + 2 * H * P * N * S)
    peak = PEAK_BF16_FLOPS if x.dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def launched_variant(fn, module, expected: str, variants=None):
    """Run `fn` (one call of a kernel's op) once; the CUDA kernels that the C
    function counted as launched in that call (`module.launch_counts()` read
    before and after) say which variant of `module` ran (of `variants`, the
    variant -> CUDA kernels table, `module.VARIANT_KERNELS` unless given).
    Raises when they are not one variant's kernels or not the variant that
    `module.variant()` names.  Returns (fn's result, variant, CUDA kernels
    launched)."""
    before = module.launch_counts()
    out = fn()
    torch.cuda.synchronize()
    seen = {k: n - before[k] for k, n in module.launch_counts().items()
            if n != before[k]}
    ran = [v for v, ks in (variants or module.VARIANT_KERNELS).items()
           if seen == {k: ks.count(k) for k in ks}]
    if ran != [expected]:
        raise AssertionError(f"one call launched {seen}: variant {ran}, but "
                             f"variant() names {expected}")
    return out, ran[0], sum(seen.values())


def library_attention(q, k, v, causal):
    """One PyTorch call for the same function: the yardstick, used nowhere in
    the port."""
    return lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=True)


def phase_env() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    props = torch.cuda.get_device_properties(0)
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], device=props.name,
         sm_count=props.multi_processor_count,
         memory_bytes=props.total_memory, nvidia_smi=smi)
    return smi.splitlines()[0]


def phase_build(verbose: bool) -> None:
    """Every kernel source, one nvcc each, started together."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.ssd_scan import kernel as ssd
    sources = (fa.SOURCE, fa.SOURCE_BWD, ssd.SOURCE)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        libs = list(pool.map(lambda src: _build.build(src, verbose), sources))
    fa.load(), fa.load_bwd(), ssd.load()
    emit("build", kernels=["flash_attention_fwd", "flash_attention_bwd",
                           "ssd_scan_fwd"],
         sources=[str(src.relative_to(ROOT)) for src in sources],
         libraries=[str(lib.relative_to(ROOT)) for lib in libs],
         seconds=round(time.perf_counter() - t0, 3))


def phase_kernels() -> dict:
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.testing import rel_err

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def make(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)

    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for (B, Hq, Hkv, Sq, Skv, D) in SWEEP_SHAPES:
            for causal, window in SWEEP_MASKS:
                if causal and Sq != Skv:
                    continue
                q = make((B, Hq, Sq, D), dtype)
                k = make((B, Hkv, Skv, D), dtype)
                v = make((B, Hkv, Skv, D), dtype)
                out, ran, _ = launched_variant(
                    lambda: flash_attention(q, k, v, causal=causal, window=window),
                    fa, fa.variant(dtype, D))
                ref = attention_ref(q, k, v, causal=causal, window=window)
                err = rel_err(out, ref)
                cases.append({"shape": [B, Hq, Hkv, Sq, Skv, D],
                              "dtype": str(dtype).split(".")[1],
                              "variant": ran,
                              "causal": causal, "window": window,
                              "rel_err": err, "tol": TOL[dtype]})
                if not (err < TOL[dtype]) or not torch.isfinite(out).all():
                    raise AssertionError(f"flash_attention disagrees: {cases[-1]}")
    # a strided [B, S, H, D] projection viewed as [B, H, S, D], and a row
    # that sees no key (window reaching no key of a shorter kv: exact 0)
    q = make((2, 70, 4, 64), torch.bfloat16).transpose(1, 2)
    k = make((2, 70, 2, 64), torch.bfloat16).transpose(1, 2)
    v = make((2, 70, 2, 64), torch.bfloat16).transpose(1, 2)
    err = rel_err(flash_attention(q, k, v, causal=True),
                  attention_ref(q, k, v, causal=True))
    if not err < TOL[torch.bfloat16]:
        raise AssertionError(f"strided inputs disagree: rel_err {err}")
    for dtype in (torch.float32, torch.bfloat16):
        q = make((1, 2, 200, 64), dtype)
        k = make((1, 2, 40, 64), dtype)
        v = make((1, 2, 40, 64), dtype)
        out = flash_attention(q, k, v, causal=False, window=16)
        ref = attention_ref(q, k, v, causal=False, window=16)
        if rel_err(out, ref) >= TOL[dtype] or float(out[:, :, 60:].abs().max()) != 0.0:
            raise AssertionError("rows that see no key must give exact 0")

    def measure(shape):
        """bf16 causal at a full-width shape: error, and the kernel's time
        beside the plain version's, the library call's and the bound."""
        B, Hq, Hkv, Sq, Skv, D = shape
        q = make((B, Hq, Sq, D), torch.bfloat16)
        k = make((B, Hkv, Skv, D), torch.bfloat16)
        v = make((B, Hkv, Skv, D), torch.bfloat16)
        out, ran, n_kernels = launched_variant(
            lambda: flash_attention(q, k, v, causal=True), fa,
            fa.variant(torch.bfloat16, D))
        ref = attention_ref(q, k, v, causal=True)
        err = rel_err(out, ref)
        abs_err = float((out.float() - ref.float()).abs().max())
        if not err < TOL[torch.bfloat16]:
            raise AssertionError(f"shape {shape} disagrees: rel_err {err}")
        library = library_attention(q, k, v, True)
        lib_err = rel_err(library(), ref)
        plain_ms = time_ms(lambda: attention_ref(q, k, v, causal=True), 5, 1)
        kernel_ms = time_ms(lambda: flash_attention(q, k, v, causal=True), 50)
        library_ms = time_ms(library, 50)
        kernel_ms = min(kernel_ms,
                        time_ms(lambda: flash_attention(q, k, v, causal=True), 50))
        bound_ms, bound_by = attention_bound_ms(q, k, v, True, None)
        return {"shape": list(shape), "dtype": "bfloat16", "causal": True,
                "variant": ran, "cuda_kernels_per_call": n_kernels,
                "max_rel_err": err, "max_abs_err": abs_err,
                "tol": TOL[torch.bfloat16], "kernel_ms": kernel_ms,
                "plain_ms": plain_ms, "library_ms": library_ms,
                "library_rel_err": lib_err, "bound_ms": bound_ms,
                "bound_by": bound_by}

    # the main path's shape (tinyllama-1.1b), then llama3.2-3b's head dim 128
    main = measure((BATCH, 32, 4, PROMPT_LEN, PROMPT_LEN, 64))
    d128 = measure(K1_D128_SHAPE)
    emit("kernels", name="flash_attention_fwd", sweep=cases,
         max_rel_err_fp32=max(c["rel_err"] for c in cases if c["dtype"] == "float32"),
         max_rel_err_bf16=max(c["rel_err"] for c in cases if c["dtype"] == "bfloat16"),
         main_path_shape=main, head_dim_128=d128)
    return main


def attention_bwd_bound_ms(q, k, v, causal, window):
    """Least time the card could take for the backward: the larger of bytes
    moved (q, k, v, o, dO and lse read once, dq, dk, dv written once) over
    the memory rate and operations (five products over the visible pairs,
    2.5 times the forward's two) over the peak rate for the type."""
    B, Hq, Sq, D = q.shape
    n_bytes = (4 * q.numel() + 2 * (k.numel() + v.numel())) * q.element_size() \
        + B * Hq * Sq * 4
    flops = 10 * B * Hq * D * visible_pairs(Sq, k.shape[2], causal, window)
    peak = PEAK_BF16_FLOPS if q.dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def attention_bwd_seven_products_ms(q, k, causal, window):
    """The operations of the two-kernel design over the peak rate: S and dP
    are computed in both the dQ and the dK/dV kernel, seven products over the
    visible pairs for the five of `attention_bwd_bound_ms`."""
    B, Hq, Sq, D = q.shape
    flops = 14 * B * Hq * D * visible_pairs(Sq, k.shape[2], causal, window)
    peak = PEAK_BF16_FLOPS if q.dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    return flops / peak * 1e3


def sdpa_backward(q, k, v, do, causal, backend: str):
    """The backward alone of `F.scaled_dot_product_attention` under one
    backend, replayed on a graph saved once; K and V are repeated to Hq heads
    first where the backend refuses `enable_gqa`.  None where the backend
    takes neither.  The yardstick, used nowhere in the port."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    group = q.shape[1] // k.shape[1]
    for gqa in (True, False):
        kk, vv = (k, v) if gqa else (k.repeat_interleave(group, 1),
                                     v.repeat_interleave(group, 1))
        ins = [x.detach().requires_grad_() for x in (q, kk, vv)]
        try:
            with sdpa_kernel(getattr(SDPBackend, backend)):
                out = F.scaled_dot_product_attention(*ins, is_causal=causal,
                                                     enable_gqa=gqa)
            torch.autograd.grad(out, ins, do, retain_graph=True)
            torch.cuda.synchronize()
        except RuntimeError:
            continue

        def call(out=out, ins=ins, gqa=gqa):
            dq, dk, dv = torch.autograd.grad(out, ins, do, retain_graph=True)
            if not gqa:   # the sum over each KV head's query heads
                B, Hq, S, D = dk.shape
                dk = dk.view(B, Hq // group, group, S, D).sum(2)
                dv = dv.view(B, Hq // group, group, S, D).sum(2)
            return dq, dk, dv
        return call, gqa
    return None, None


def device_split(fn, calls: int = 10) -> dict:
    """Device time of each CUDA kernel that `calls` runs of `fn` launch, by
    torch.profiler: ms a call and share of the total."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    times = {}
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total", None)
        if us is None:
            us = getattr(evt, "cuda_time_total", 0.0)
        if us > 0:
            name = evt.key.replace("void ", "").replace("(anonymous namespace)::", "")
            times[name.split("(")[0]] = us / 1e3 / calls
    total = sum(times.values())
    return {name: {"ms": ms, "share": ms / total if total else None}
            for name, ms in times.items()}


def phase_attention_bwd() -> dict:
    """K1b: the backward kernel against its plain version over the sweep,
    the forward's log-sum-exp against the plain one, and the backward timed
    at the training shape."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                         attention_ref)
    from repro_torch.testing import rel_err

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)

    def make(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)

    def lse_err(lse, ref):
        """rel err over the rows that see a key; the others must both hold
        the masked logit"""
        seen = ref > -1e38
        if not bool(torch.equal(seen, lse > -1e38)):
            raise AssertionError("lse: rows without a key disagree")
        return rel_err(lse[seen], ref[seen]) if bool(seen.any()) else 0.0

    def inputs(shape, dtype, causal, window):
        B, Hq, Hkv, Sq, Skv, D = shape
        q, k, v = make((B, Hq, Sq, D), dtype), make((B, Hkv, Skv, D), dtype), \
            make((B, Hkv, Skv, D), dtype)
        out, lse = attention_ref(q, k, v, causal=causal, window=window,
                                 return_lse=True)
        return q, k, v, out, lse, make((B, Hq, Sq, D), dtype)

    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for shape in BWD_SHAPES:
            D = shape[-1]
            for causal, window in BWD_MASKS:
                q, k, v, out, lse, do = inputs(shape, dtype, causal, window)
                (_, lse_k), _, _ = launched_variant(
                    lambda: fa.flash_attention_fwd(q, k, v, causal=causal,
                                                   window=window, return_lse=True),
                    fa, fa.variant(dtype, D))
                bwd = lambda: fa.flash_attention_bwd(  # noqa: E731
                    q, k, v, out, lse, do, causal=causal, window=window)
                grads, ran, _ = launched_variant(
                    bwd, fa, fa.variant_bwd(dtype, D), fa.VARIANT_KERNELS_BWD)
                again = bwd()
                ref = attention_bwd_ref(q, k, v, out, lse, do, causal=causal,
                                        window=window)
                errs = [rel_err(g, r) for g, r in zip(grads, ref)]
                blind = lse <= -1e38      # rows that see no key: zero dq
                case = {"shape": list(shape), "dtype": str(dtype).split(".")[1],
                        "variant": ran, "causal": causal, "window": window,
                        "dq_rel_err": errs[0], "dk_rel_err": errs[1],
                        "dv_rel_err": errs[2], "tol": BWD_TOL[dtype],
                        "lse_rel_err": lse_err(lse_k, lse), "lse_tol": TOL[dtype],
                        "rows_without_key": int(blind.sum()),
                        "equal_run_to_run": all(torch.equal(a, b)
                                                for a, b in zip(grads, again))}
                cases.append(case)
                wgmma = dtype == torch.bfloat16 and D in fa.WGMMA_HEAD_DIMS
                if not (max(errs) < BWD_TOL[dtype] and case["lse_rel_err"] < TOL[dtype]
                        and all(bool(torch.isfinite(g).all()) for g in grads)
                        and float(grads[0][blind].abs().sum()) == 0.0
                        and case["equal_run_to_run"]
                        and (ran == "fa_bwd_wgmma") == wgmma):
                    raise AssertionError(f"flash_attention_bwd disagrees: {case}")

    def measure(shape) -> dict:
        """bf16 causal at a full-width training shape: error, the kernel
        (variant_bwd's) timed in turns with the PR-14 kernel and with the
        fastest SDPA backend, each backend alone, the split between the CUDA
        kernels, and the bounds."""
        B, Hq, Hkv, Sq, Skv, D = shape
        q, k, v, out, lse, do = inputs(shape, torch.bfloat16, True, None)
        grads, ran, n_kernels = launched_variant(
            lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, causal=True), fa,
            fa.variant_bwd(torch.bfloat16, D), fa.VARIANT_KERNELS_BWD)
        ref = attention_bwd_ref(q, k, v, out, lse, do, causal=True)
        errs = [rel_err(g, r) for g, r in zip(grads, ref)]
        abs_err = max(float((g.float() - r.float()).abs().max())
                      for g, r in zip(grads, ref))
        again = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=True)
        equal = all(torch.equal(a, b) for a, b in zip(grads, again))
        _, lse_k = fa.flash_attention_fwd(q, k, v, causal=True, return_lse=True)
        main_lse_err = lse_err(lse_k, lse)
        if not (max(errs) < BWD_TOL[torch.bfloat16]
                and main_lse_err < TOL[torch.bfloat16] and equal
                and ran == "fa_bwd_wgmma" and n_kernels == 2):
            raise AssertionError(f"training shape {shape} disagrees: {errs}, "
                                 f"lse {main_lse_err}, equal {equal}, {ran} "
                                 f"with {n_kernels} CUDA kernels")
        earlier = "fa_bwd_bf16_mma"   # the PR-14 kernel, at every bf16 head dim
        kernel = lambda: fa.flash_attention_bwd(  # noqa: E731
            q, k, v, out, lse, do, causal=True)
        mma = lambda: fa.flash_attention_bwd(  # noqa: E731
            q, k, v, out, lse, do, causal=True, variant=earlier)
        mma_err = max(rel_err(g, r) for g, r in zip(mma(), ref))
        # every SDPA backend that takes the inputs, alone, then the fastest
        # in turns with the two kernels: new, earlier, library, library,
        # earlier, new
        backends, library_errs = {}, {}
        calls = {}
        for name in SDPA_BACKENDS:
            call, gqa = sdpa_backward(q, k, v, do, True, name)
            if call is None:
                backends[name] = None
                continue
            calls[name] = call
            library_errs[name] = max(rel_err(g, r) for g, r in zip(call(), ref))
            backends[name] = {"ms": time_ms(call, 20), "enable_gqa": gqa}
        timed = [n for n in SDPA_BACKENDS if backends[n] is not None]
        best = min(timed, key=lambda n: backends[n]["ms"]) if timed else None
        turns = [("kernel", kernel), ("earlier", mma)]
        if best is not None:
            turns.append(("library", calls[best]))
        order = turns + turns[::-1]
        ms, in_turns = {name: [] for name, _ in turns}, []
        for name, fn in order:
            ms[name].append(time_ms(fn, 20))
            in_turns.append([name, ms[name][-1]])
        plain_ms = time_ms(lambda: attention_bwd_ref(q, k, v, out, lse, do,
                                                     causal=True), 3, 1)
        bound_ms, bound_by = attention_bwd_bound_ms(q, k, v, True, None)
        seven_ms = attention_bwd_seven_products_ms(q, k, True, None)
        split = device_split(kernel)
        kernel_ms = min(ms["kernel"])
        if shape == TRAIN_ATTN_SHAPE and not kernel_ms < min(ms["earlier"]):
            raise AssertionError(f"{ran} is not faster than {earlier}: {in_turns}")
        return {"shape": list(shape), "dtype": "bfloat16", "causal": True,
                "variant": ran, "cuda_kernels_per_call": n_kernels,
                "dq_rel_err": errs[0], "dk_rel_err": errs[1], "dv_rel_err": errs[2],
                "max_abs_err": abs_err, "lse_rel_err": main_lse_err,
                "equal_run_to_run": equal,
                "tol": BWD_TOL[torch.bfloat16], "kernel_ms": kernel_ms,
                "cuda_kernels": split,
                "earlier_variant": earlier, "earlier_ms": min(ms["earlier"]),
                "earlier_rel_err": mma_err,
                "speedup_over_earlier": min(ms["earlier"]) / kernel_ms,
                "ms_in_turns": in_turns,
                "plain_ms": plain_ms,
                "library_ms": min(ms["library"]) if best else None,
                "library_backend": best, "library_backends": backends,
                "library_rel_err": library_errs,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "bound_ms_seven_products": seven_ms,
                "goal_ms": 0.50 if shape == TRAIN_ATTN_SHAPE else None}

    main = measure(TRAIN_ATTN_SHAPE)
    d128 = measure(BWD_D128_SHAPE)
    # the forward at the training shape, without and with the log-sum-exp,
    # in turns
    B, Hq, Hkv, Sq, Skv, D = TRAIN_ATTN_SHAPE
    q, k, v = make((B, Hq, Sq, D), torch.bfloat16), \
        make((B, Hkv, Skv, D), torch.bfloat16), make((B, Hkv, Skv, D), torch.bfloat16)
    fwd = lambda: fa.flash_attention_fwd(q, k, v, causal=True)  # noqa: E731
    fwd_lse = lambda: fa.flash_attention_fwd(q, k, v, causal=True, return_lse=True)  # noqa: E731
    fwd_ms = [time_ms(fwd, 50), time_ms(fwd_lse, 50), time_ms(fwd_lse, 50), time_ms(fwd, 50)]
    main.update({"fwd_ms_without_lse": min(fwd_ms[0], fwd_ms[3]),
                 "fwd_ms_with_lse": min(fwd_ms[1], fwd_ms[2]),
                 "fwd_ms_in_turns": fwd_ms})
    emit("kernels", name="flash_attention_bwd", sweep=cases,
         max_rel_err_fp32=max(max(c["dq_rel_err"], c["dk_rel_err"], c["dv_rel_err"])
                              for c in cases if c["dtype"] == "float32"),
         max_rel_err_bf16=max(max(c["dq_rel_err"], c["dk_rel_err"], c["dv_rel_err"])
                              for c in cases if c["dtype"] == "bfloat16"),
         max_lse_rel_err_fp32=max(c["lse_rel_err"] for c in cases
                                  if c["dtype"] == "float32"),
         max_lse_rel_err_bf16=max(c["lse_rel_err"] for c in cases
                                  if c["dtype"] == "bfloat16"),
         variants={v: sum(c["variant"] == v for c in cases)
                   for v in fa.VARIANT_CODES_BWD},
         main_path_shape=main, head_dim_128=d128)
    return main


def phase_ssd_kernels() -> dict:
    from repro_torch.kernels.ssd_scan import kernel as kssd
    from repro_torch.kernels.ssd_scan.ops import ssd
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref
    from repro_torch.testing import rel_err

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    def make(B, S, H, P, G, N, dtype, with_init=False):
        """The distributions of the JAX package's kernel tests."""
        x = randn(B, S, H, P, scale=0.5).to(dtype)
        dt = F.softplus(randn(B, S, H))
        A = -torch.exp(randn(H, scale=0.3))
        B_ = randn(B, S, G, N, scale=0.3).to(dtype)
        C = randn(B, S, G, N, scale=0.3).to(dtype)
        h0 = randn(B, H, P, N) if with_init else None
        return (x, dt, A, B_, C), h0

    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for idx, (B, S, H, P, G, N, chunk) in enumerate(SSD_SHAPES):
            for with_init in sorted({False, idx in SSD_INIT_STATE}):
                args, h0 = make(B, S, H, P, G, N, dtype, with_init)
                (y, hT), ran, _ = launched_variant(
                    lambda: ssd(*args, chunk=chunk, init_state=h0,
                                return_state=True),
                    kssd, kssd.variant(dtype, P, N, chunk))
                ry, rh = ssd_chunked_ref(*args, chunk=chunk, init_state=h0)
                err_y, err_h = rel_err(y, ry), rel_err(hT, rh)
                cases.append({"shape": [B, S, H, P, G, N], "chunk": chunk,
                              "dtype": str(dtype).split(".")[1],
                              "variant": ran,
                              "init_state": with_init, "y_rel_err": err_y,
                              "state_rel_err": err_h, "tol": TOL[dtype]})
                if not (err_y < TOL[dtype] and err_h < TOL[dtype]
                        and torch.isfinite(y).all() and torch.isfinite(hT).all()):
                    raise AssertionError(f"ssd disagrees: {cases[-1]}")

    # the main path's shape: one mamba2-1.3b layer's scan at batch 8 x 1024
    B, S, H, P, G, N, chunk = BATCH, PROMPT_LEN, 64, 64, 1, 128, 256
    args, _ = make(B, S, H, P, G, N, torch.bfloat16)
    (y, hT), ran, n_kernels = launched_variant(
        lambda: ssd(*args, chunk=chunk, return_state=True), kssd,
        kssd.variant(torch.bfloat16, P, N, chunk))
    ry, rh = ssd_chunked_ref(*args, chunk=chunk)
    err, err_h = rel_err(y, ry), rel_err(hT, rh)
    abs_err = float((y.float() - ry.float()).abs().max())
    if not (err < TOL[torch.bfloat16] and err_h < TOL[torch.bfloat16]):
        raise AssertionError(f"main-path shape disagrees: y {err}, state {err_h}")
    plain_ms = time_ms(lambda: ssd_chunked_ref(*args, chunk=chunk), 5, 1)
    kernel_ms = time_ms(lambda: ssd(*args, chunk=chunk, return_state=True), 20)
    kernel_ms = min(kernel_ms,
                    time_ms(lambda: ssd(*args, chunk=chunk, return_state=True), 20))
    bound_ms, bound_by = ssd_bound_ms(*args, chunk)
    main = {"shape": [B, S, H, P, G, N], "chunk": chunk, "dtype": "bfloat16",
            "variant": ran, "cuda_kernels_per_call": n_kernels,
            "max_rel_err": err, "state_rel_err": err_h, "max_abs_err": abs_err,
            "tol": TOL[torch.bfloat16], "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": bound_ms, "bound_by": bound_by}
    emit("kernels", name="ssd_scan_fwd", sweep=cases,
         max_rel_err_fp32=max(c["y_rel_err"] for c in cases if c["dtype"] == "float32"),
         max_rel_err_bf16=max(c["y_rel_err"] for c in cases if c["dtype"] == "bfloat16"),
         max_state_rel_err_fp32=max(c["state_rel_err"] for c in cases
                                    if c["dtype"] == "float32"),
         max_state_rel_err_bf16=max(c["state_rel_err"] for c in cases
                                    if c["dtype"] == "bfloat16"),
         main_path_shape=main)
    return main


def phase_serve(arch: str) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.ssd_scan.ops import ssd
    from repro_torch.launch.serve import generate, pad_cache_to
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.common import get_model, param_count
    from repro_torch.testing import rel_err

    cfg = get_config(arch)
    model = get_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = model.init(cfg, gen, "cuda")
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT_LEN),
                            generator=gen, device="cuda")
    generate(cfg, params, prompts, 4)          # warm-up: library handles, caches

    # the main path, with every kernel's count set to 0 just before it: the
    # arch's own kernel runs once per layer in the prefill, the other never
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = flash_attention.bwd_launches = ssd.launches = 0
    tokens, t_prefill, t_decode = generate(cfg, params, prompts, GEN)
    counts = {"flash_attention_fwd": flash_attention.launches,
              "flash_attention_bwd": flash_attention.bwd_launches,
              "ssd_scan_fwd": ssd.launches}
    peak = torch.cuda.max_memory_allocated()
    own = "ssd_scan_fwd" if cfg.family == "ssm" else "flash_attention_fwd"
    launches = counts[own]
    if launches != cfg.num_layers or sum(counts.values()) != launches:
        raise AssertionError(f"kernel launches {counts} in one prefill of "
                             f"{cfg.num_layers} layers of {arch}")
    if tokens.shape != (BATCH, GEN) or int(tokens.min()) < 0 \
            or int(tokens.max()) >= cfg.vocab_size:
        raise AssertionError("generated tokens out of range")

    # decode of token S after prefill(S) against the last position of prefill(S + 1)
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    full, _ = prefill(params, {"tokens": prompts})
    part, cache = prefill(params, {"tokens": prompts[:, :-1]})
    cache = pad_cache_to(cache, PROMPT_LEN + 4)
    step, cache = decode(params, cache, {"tokens": prompts[:, -1:]})
    if not (torch.isfinite(full).all() and torch.isfinite(step).all()):
        raise AssertionError("logits are not finite")
    if full.shape != (BATCH, 1, cfg.vocab_size) or full.dtype != torch.float32:
        raise AssertionError(f"logits {tuple(full.shape)} {full.dtype}")
    decode_err = rel_err(step, full)
    if not decode_err < DECODE_TOL or cache["len"] != PROMPT_LEN:
        raise AssertionError(f"decode after prefill disagrees: {decode_err}")

    steps = GEN - 1
    result = {"arch": arch, "params": param_count(params),
              "dtype": "bfloat16", "batch": BATCH, "prompt_len": PROMPT_LEN,
              "gen": GEN, "prefill_ms": t_prefill * 1e3,
              "decode_ms_per_token": t_decode * 1e3 / steps,
              "decode_tokens_per_s": BATCH * steps / t_decode,
              "peak_memory_bytes": peak, "kernel": own,
              "kernel_launches": launches, "launches_by_kernel": counts,
              "decode_vs_prefill_rel_err": decode_err, "decode_tol": DECODE_TOL}
    emit("serve", **result)
    return result


def phase_parity_on_card(arch: str) -> None:
    from repro_torch.configs import get_config
    from repro_torch.models.common import get_model
    from repro_torch.testing import rel_err

    cfg = get_config(arch).replace(num_layers=2, param_dtype=torch.float32,
                                   compute_dtype=torch.float32)
    model = get_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    params = model.init(cfg, gen, "cuda")
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT_LEN),
                           generator=gen, device="cuda")
    dense = cfg.replace(attn_impl="dense")
    logits_k, cache_k = model.prefill(cfg, params, {"tokens": tokens})
    logits_d, cache_d = model.prefill(dense, params, {"tokens": tokens})
    hidden_err = rel_err(model.forward(cfg, params, tokens),
                         model.forward(dense, params, tokens))
    logits_err = rel_err(logits_k, logits_d)
    cache_err = max(rel_err(val, cache_d[key]) for key, val in cache_k.items()
                    if isinstance(val, torch.Tensor))
    head_dim = cfg.ssm_headdim if cfg.family == "ssm" else cfg.resolved_head_dim
    emit("parity_on_card", arch=arch, head_dim=head_dim, layers=2,
         dtype="float32", logits_rel_err=logits_err,
         hidden_rel_err=hidden_err, cache_rel_err=cache_err, tol=PARITY_TOL)
    if not max(logits_err, hidden_err, cache_err) < PARITY_TOL:
        raise AssertionError(f"{arch}: kernel path and dense path disagree "
                             "on the card")


def _train_batch(cfg) -> dict:
    """The first batch of the port's synthetic pipeline, on the card."""
    from repro_torch.data import DataConfig, ShardedDataset, make_batch_iter
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=PROMPT_LEN,
                      global_batch=BATCH, num_shards=64)
    batch = next(make_batch_iter(ShardedDataset(data, num_hosts=1), hosts=[0]))
    return {k: torch.from_numpy(v).long().cuda() for k, v in batch.items()}


def phase_train() -> dict:
    """tinyllama-1.1b trains: a warm-up step, then TRAIN_STEPS timed steps of
    the port's train step, with every kernel's count set to 0 just before
    them: K1 twice a layer a step (the forward, and again under the full
    remat's recompute), K1b once, K2 never."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.ssd_scan.ops import ssd
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.common import get_model, param_count, tree_leaves
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = get_config(TRAIN_ARCH)
    if cfg.remat != "full" or cfg.param_dtype != torch.bfloat16:
        raise AssertionError(f"{TRAIN_ARCH}: remat {cfg.remat}, {cfg.param_dtype}")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = get_model(cfg).init(cfg, gen, "cuda")
    opt = adamw_init(params)
    batch = _train_batch(cfg)
    step = make_train_step(cfg, AdamWConfig(**TRAIN_OPT))
    t0 = time.perf_counter()
    params, opt, metrics = step(params, opt, batch)          # warm-up
    losses = [float(metrics["loss"])]
    warmup_s = time.perf_counter() - t0

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = flash_attention.bwd_launches = ssd.launches = 0
    fa.flash_attention_bwd.copies = 0
    before = fa.launch_counts()
    times = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, batch)
        losses.append(float(metrics["loss"]))               # waits for the step
        times.append(time.perf_counter() - t0)
    counts = {"flash_attention_fwd": flash_attention.launches,
              "flash_attention_bwd": flash_attention.bwd_launches,
              "ssd_scan_fwd": ssd.launches}
    cuda_kernels = {k: n - before[k] for k, n in fa.launch_counts().items()
                    if n != before[k]}
    bwd_copies = fa.flash_attention_bwd.copies
    peak = torch.cuda.max_memory_allocated()
    expected = {"flash_attention_fwd": 2 * cfg.num_layers * TRAIN_STEPS,
                "flash_attention_bwd": cfg.num_layers * TRAIN_STEPS,
                "ssd_scan_fwd": 0}
    # K1b through the wgmma variant's two CUDA kernels, once each a call
    bwd_kernels = fa.VARIANT_KERNELS_BWD[fa.variant_bwd(cfg.compute_dtype,
                                                        cfg.resolved_head_dim)]
    if counts != expected or any(cuda_kernels.get(k) != expected["flash_attention_bwd"]
                                 for k in bwd_kernels):
        raise AssertionError(f"kernel launches {counts} ({cuda_kernels}) in "
                             f"{TRAIN_STEPS} train steps of {cfg.num_layers} "
                             f"layers, expected {expected} and {bwd_kernels}")
    timed = losses[1:]
    if not all(math.isfinite(x) for x in losses) or timed[-1] >= losses[0] or \
            any(b >= a for a, b in zip(timed, timed[1:])):
        raise AssertionError(f"train losses (warm-up, then timed) not finite "
                             f"and falling: {losses}")
    n_params = param_count(params)
    ms = sum(times) / len(times) * 1e3
    result = {"arch": TRAIN_ARCH, "params": n_params, "dtype": "bfloat16",
              "remat": cfg.remat, "batch": BATCH, "seq": PROMPT_LEN,
              "steps_timed": TRAIN_STEPS, "warmup_step_s": warmup_s,
              "ms_per_step": ms, "ms_per_step_each": [t * 1e3 for t in times],
              "tokens_per_s": BATCH * PROMPT_LEN / (ms / 1e3),
              "warmup_loss": losses[0], "losses": timed,
              "peak_memory_bytes": peak,
              "param_bytes": sum(x.numel() * x.element_size() for x in tree_leaves(params)),
              "moment_bytes": 2 * 4 * n_params, "fp32_grad_bytes": 4 * n_params,
              "launches_by_kernel": counts, "cuda_kernel_launches": cuda_kernels,
              "bwd_calls_that_copied_out_or_do": bwd_copies}
    emit("train", **result)
    return result


def phase_train_parity_bf16() -> None:
    """The gradients of tinyllama-1.1b at full width, 2 layers, in bf16 (the
    config's types), kernel path against dense path: the path the fp32 run
    cannot reach, K1b's wgmma variant.  Each gradient leaf within
    BF16_GRAD_TOL, relative to its dense max."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models.common import get_model
    from repro_torch.testing import rel_err

    cfg = get_config(TRAIN_ARCH).replace(num_layers=2)
    if cfg.compute_dtype != torch.bfloat16:
        raise AssertionError(f"{TRAIN_ARCH} computes in {cfg.compute_dtype}")
    dense = cfg.replace(attn_impl="dense")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    params = get_model(cfg).init(cfg, gen, "cuda")
    batch = _train_batch(cfg)
    before = fa.launch_counts()
    loss_k, grads_k = loss_and_grads(cfg, params, batch)
    torch.cuda.synchronize()
    ran = {k: n - before[k] for k, n in fa.launch_counts().items() if n != before[k]}
    loss_d, grads_d = loss_and_grads(dense, params, batch)
    grad_errs = [rel_err(a, b) for a, b in zip(grads_k, grads_d)]
    loss_err = abs(float(loss_k) - float(loss_d)) / abs(float(loss_d))
    result = {"arch": TRAIN_ARCH, "layers": 2, "dtype": "bfloat16",
              "loss_rel_err": loss_err, "max_grad_rel_err": max(grad_errs),
              "median_grad_rel_err": sorted(grad_errs)[len(grad_errs) // 2],
              "leaves": len(grad_errs), "cuda_kernels": ran,
              "tol": BF16_GRAD_TOL}
    emit("train_parity_on_card", **result)
    expected = fa.VARIANT_KERNELS_BWD[fa.variant_bwd(torch.bfloat16,
                                                     cfg.resolved_head_dim)]
    if not (max(grad_errs) < BF16_GRAD_TOL and loss_err < BF16_GRAD_TOL
            and all(ran.get(k) == cfg.num_layers for k in expected)):
        raise AssertionError(f"bf16 training: kernel path and dense path "
                             f"disagree: {result}")


def phase_train_parity_on_card() -> None:
    """One train step of tinyllama-1.1b at full width, 2 layers, fp32, with
    the kernels against the dense path: loss, every gradient and the updated
    params (the ill-conditioned elements counted, the rest) at PARITY_TOL."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.models.common import get_model, tree_leaves, tree_map
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.testing import rel_err

    cfg = get_config(TRAIN_ARCH).replace(num_layers=2, param_dtype=torch.float32,
                                         compute_dtype=torch.float32)
    dense = cfg.replace(attn_impl="dense")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    params = get_model(cfg).init(cfg, gen, "cuda")
    batch = _train_batch(cfg)
    loss_k, grads_k = loss_and_grads(cfg, params, batch)
    loss_d, grads_d = loss_and_grads(dense, params, batch)
    grad_errs = [rel_err(a, b) for a, b in zip(grads_k, grads_d)]
    stepped = {}
    for name, c in (("kernel", cfg), ("dense", dense)):
        p = tree_map(torch.clone, params)
        p, _, m = make_train_step(c, AdamWConfig(**TRAIN_OPT))(p, adamw_init(p), batch)
        stepped[name] = (p, float(m["loss"]))
    # the gradient Adam sees on the dense path: after the global-norm clip
    norm = float(torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads_d)))
    clip = min(1.0, AdamWConfig().clip_norm / max(norm, 1e-9))
    n_ill, ill_max_abs, ill_max_g, param_err = 0, 0.0, 0.0, 0.0
    for a, b, g in zip(tree_leaves(stepped["kernel"][0]),
                       tree_leaves(stepped["dense"][0]), grads_d):
        diff = (a - b).abs()
        ill = (g.float() * clip).abs() < NEAR_ZERO_GRAD
        scale = float(b.abs().max()) + 1e-9
        if bool((~ill).any()):
            param_err = max(param_err, float(diff[~ill].max()) / scale)
        off = ill & (diff > PARITY_TOL * scale)
        n_ill += int(off.sum())
        if bool(off.any()):
            ill_max_abs = max(ill_max_abs, float(diff[off].max()))
            ill_max_g = max(ill_max_g, float((g.float() * clip).abs()[off].max()))
    loss_err = abs(float(loss_k) - float(loss_d)) / abs(float(loss_d))
    step_loss_err = abs(stepped["kernel"][1] - stepped["dense"][1]) / abs(stepped["dense"][1])
    n_params = sum(x.numel() for x in tree_leaves(params))
    result = {"arch": TRAIN_ARCH, "layers": 2, "dtype": "float32",
              "loss_rel_err": loss_err, "step_loss_rel_err": step_loss_err,
              "max_grad_rel_err": max(grad_errs), "params_rel_err": param_err,
              "grad_norm": norm, "ill_conditioned_elements_off": n_ill,
              "ill_conditioned_max_abs_diff": ill_max_abs,
              "ill_conditioned_max_clipped_grad": ill_max_g,
              "params": n_params, "tol": PARITY_TOL}
    emit("train_parity_on_card", **result)
    if not (max(loss_err, step_loss_err, max(grad_errs), param_err) < PARITY_TOL
            and n_ill <= 1e-4 * n_params
            and ill_max_abs <= 2 * TRAIN_OPT["lr"] * 1.01):
        raise AssertionError(f"training: kernel path and dense path disagree: {result}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (without the package: fail before any output)
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products in full fp32
    smi_line = phase_env()
    phase_build(verbose="--verbose-build" in sys.argv[1:])
    k1 = phase_kernels()
    k2 = phase_ssd_kernels()
    serves = {arch: phase_serve(arch) for arch in SERVE_ARCHS}
    for arch in PARITY_ARCHS:
        phase_parity_on_card(arch)
    k1b = phase_attention_bwd()
    trained = phase_train()
    phase_train_parity_on_card()
    phase_train_parity_bf16()

    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.ssd_scan import kernel as ssd
    # one row per TPU kernel, and one for the attention backward (the JAX
    # package's blocked jnp backward, a hand-written kernel here); `launches`
    # counts calls of the op on the main path; `variant` and
    # `cuda_kernels_per_call` are what the C function counted one call launch
    # at the main path's shape (the SSD scan's wgmma variant: the state pass,
    # then the outputs; the backward's: dQ with delta, then dK/dV)
    rows = []
    for name, module, replaces, numbers, arch in (
            ("flash_attention_fwd", fa,
             "src/repro/kernels/flash_attention/kernel.py:32", k1,
             "tinyllama-1.1b"),
            ("ssd_scan_fwd", ssd, "src/repro/kernels/ssd_scan/kernel.py:27",
             k2, "mamba2-1.3b"),
            ("flash_attention_bwd", fa, "src/repro/models/flash.py:197", k1b,
             None)):
        rows.append({
            "name": name,
            "route": "cuda",
            "source": str((fa.SOURCE_BWD if arch is None else module.SOURCE)
                          .relative_to(ROOT)),
            "replaces": replaces,
            # the serving kernels' launches in one prefill; the backward's in
            # the timed train steps
            "launches": (trained["launches_by_kernel"][name] if arch is None
                         else serves[arch]["kernel_launches"]),
            "max_abs_err": numbers["max_abs_err"],
            "ms": numbers["kernel_ms"],
            "plain_ms": numbers["plain_ms"],
            "bound_ms": numbers["bound_ms"],
            "bound_by": numbers["bound_by"],
            "library_ms": numbers["library_ms"],
            "variant": numbers["variant"],
            "cuda_kernels_per_call": numbers["cuda_kernels_per_call"],
        })
    print(json.dumps({"kernels": rows}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
