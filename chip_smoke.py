#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on the GPU.

    python3 chip_smoke.py

Needs one NVIDIA Hopper card, `nvcc` and nothing else; no network.  It builds
the port's two kernels (flash attention, the Mamba-2 SSD scan) from the
sources in this checkout, holds each against its plain PyTorch version on the
card, serves tinyllama-1.1b and mamba2-1.3b at full width (random weights from
a seed: batch 8 x prompt 1024, 64 generated tokens) through the port's
prefill and decode steps, and checks the results.  Every phase prints one
JSON line; any failure raises, so the exit code is not 0.  The last line is
`{"ok": true, "device": {...}}`.  Without a CUDA device it prints no result
and exits with code 1.
"""
from __future__ import annotations

import json
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
    (1, 8, 1, 64, 64, 32),        # MQA
    (2, 4, 4, 150, 150, 80),      # stablelm-3b's head dim, ragged
]
SWEEP_MASKS = [(True, None), (False, None), (True, 48)]
# relative to max|plain|, for attention's output and for the SSD scan's y and
# final state alike
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}

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
    """Both kernels, one nvcc each, started together."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.ssd_scan import kernel as ssd
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        libs = list(pool.map(lambda k: k.build(verbose=verbose), (fa, ssd)))
    for module in (fa, ssd):
        module.load()
    emit("build", kernels=["flash_attention_fwd", "ssd_scan_fwd"],
         sources=[str(m.SOURCE.relative_to(ROOT)) for m in (fa, ssd)],
         libraries=[str(lib.relative_to(ROOT)) for lib in libs],
         seconds=round(time.perf_counter() - t0, 3))


def phase_kernels() -> dict:
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
                out = flash_attention(q, k, v, causal=causal, window=window)
                torch.cuda.synchronize()
                ref = attention_ref(q, k, v, causal=causal, window=window)
                err = rel_err(out, ref)
                cases.append({"shape": [B, Hq, Hkv, Sq, Skv, D],
                              "dtype": str(dtype).split(".")[1],
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

    # the main path's shape
    cfg_shape = (BATCH, 32, 4, PROMPT_LEN, PROMPT_LEN, 64)
    B, Hq, Hkv, Sq, Skv, D = cfg_shape
    q = make((B, Hq, Sq, D), torch.bfloat16)
    k = make((B, Hkv, Skv, D), torch.bfloat16)
    v = make((B, Hkv, Skv, D), torch.bfloat16)
    out = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    ref = attention_ref(q, k, v, causal=True)
    err = rel_err(out, ref)
    abs_err = float((out.float() - ref.float()).abs().max())
    if not err < TOL[torch.bfloat16]:
        raise AssertionError(f"main-path shape disagrees: rel_err {err}")
    library = library_attention(q, k, v, True)
    lib_err = rel_err(library(), ref)
    plain_ms = time_ms(lambda: attention_ref(q, k, v, causal=True), 5, 1)
    kernel_ms = time_ms(lambda: flash_attention(q, k, v, causal=True), 50)
    library_ms = time_ms(library, 50)
    kernel_ms = min(kernel_ms,
                    time_ms(lambda: flash_attention(q, k, v, causal=True), 50))
    bound_ms, bound_by = attention_bound_ms(q, k, v, True, None)
    main = {"shape": list(cfg_shape), "dtype": "bfloat16", "causal": True,
            "max_rel_err": err, "max_abs_err": abs_err, "tol": TOL[torch.bfloat16],
            "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_rel_err": lib_err,
            "bound_ms": bound_ms, "bound_by": bound_by}
    emit("kernels", name="flash_attention_fwd", sweep=cases,
         max_rel_err_fp32=max(c["rel_err"] for c in cases if c["dtype"] == "float32"),
         max_rel_err_bf16=max(c["rel_err"] for c in cases if c["dtype"] == "bfloat16"),
         main_path_shape=main)
    return main


def phase_ssd_kernels() -> dict:
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
                y, hT = ssd(*args, chunk=chunk, init_state=h0, return_state=True)
                torch.cuda.synchronize()
                ry, rh = ssd_chunked_ref(*args, chunk=chunk, init_state=h0)
                err_y, err_h = rel_err(y, ry), rel_err(hT, rh)
                cases.append({"shape": [B, S, H, P, G, N], "chunk": chunk,
                              "dtype": str(dtype).split(".")[1],
                              "init_state": with_init, "y_rel_err": err_y,
                              "state_rel_err": err_h, "tol": TOL[dtype]})
                if not (err_y < TOL[dtype] and err_h < TOL[dtype]
                        and torch.isfinite(y).all() and torch.isfinite(hT).all()):
                    raise AssertionError(f"ssd disagrees: {cases[-1]}")

    # the main path's shape: one mamba2-1.3b layer's scan at batch 8 x 1024
    B, S, H, P, G, N, chunk = BATCH, PROMPT_LEN, 64, 64, 1, 128, 256
    args, _ = make(B, S, H, P, G, N, torch.bfloat16)
    y, hT = ssd(*args, chunk=chunk, return_state=True)
    torch.cuda.synchronize()
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
    flash_attention.launches = ssd.launches = 0
    tokens, t_prefill, t_decode = generate(cfg, params, prompts, GEN)
    counts = {"flash_attention_fwd": flash_attention.launches,
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

    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.ssd_scan import kernel as ssd
    rows = []
    for name, module, replaces, numbers, arch in (
            ("flash_attention_fwd", fa,
             "src/repro/kernels/flash_attention/kernel.py:32", k1,
             "tinyllama-1.1b"),
            ("ssd_scan_fwd", ssd, "src/repro/kernels/ssd_scan/kernel.py:27",
             k2, "mamba2-1.3b")):
        rows.append({
            "name": name,
            "route": "cuda",
            "source": str(module.SOURCE.relative_to(ROOT)),
            "replaces": replaces,
            "launches": serves[arch]["kernel_launches"],
            "max_abs_err": numbers["max_abs_err"],
            "ms": numbers["kernel_ms"],
            "plain_ms": numbers["plain_ms"],
            "bound_ms": numbers["bound_ms"],
            "bound_by": numbers["bound_by"],
            "library_ms": numbers["library_ms"],
        })
    print(json.dumps({"kernels": rows}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
