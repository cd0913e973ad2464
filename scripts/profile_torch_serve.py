#!/usr/bin/env python3
"""Where the time goes when the PyTorch/CUDA port serves or trains a model.

    PYTHONPATH=src python3 scripts/profile_torch_serve.py [--arch A] [--layers N]
    PYTHONPATH=src python3 scripts/profile_torch_serve.py --train [--layers N]

Needs one CUDA card.  Serves the full-width model (tinyllama-1.1b unless
``--arch`` names another ported arch; random weights from a seed, batch 8 x
prompt 1024) and traces one prefill and a window of decode steps with
torch.profiler; with ``--train`` it instead trains the arch (dense, Qwen2-VL,
Mamba-2, Zamba2 or MoE; bf16, the config's remat, AdamW) on batch 8 x
sequence 1024 and traces one train step after a warm-up step, and prints the
step's peak device memory.  Prints one JSON line per phase: the wall time,
the time the device was busy, its idle share, the number of kernels, and the
kernels that took most of the device time.  For the MoE archs it also splits
the busy time by region (``REGIONS``): the router, the dispatch, the expert
products, the un-dispatch, MLA's cache expansion and its dense attention,
each with the backward of what ran inside it.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.configs import PORTED_ARCHS, get_config
from repro_torch.launch.serve import pad_cache_to, resolve_device, sample
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models import layers, moe
from repro_torch.models.common import get_model
from repro_torch.optim import AdamWConfig, adamw_init

BATCH, PROMPT_LEN, DECODE_STEPS = 8, 1024, 16


# the MoE archs' regions: each function runs inside a torch.profiler range
# named after its region while `regions()` is open
RANGE = "region:"
REGIONS = (("moe_router", moe, "route"), ("moe_dispatch", moe, "dispatch"),
           ("moe_experts", moe, "expert_products"), ("moe_combine", moe, "combine"),
           ("mla_expand", moe, "_mla_expand"),
           ("dense_attention", layers, "attention_dense"))


@contextlib.contextmanager
def regions():
    saved = []
    for region, module, attr in REGIONS:
        fn = getattr(module, attr)

        def ranged(*args, _fn=fn, _name=RANGE + region, **kwargs):
            with record_function(_name):
                return _fn(*args, **kwargs)
        setattr(module, attr, ranged)
        saved.append((module, attr, fn))
    try:
        yield
    finally:
        for module, attr, fn in saved:
            setattr(module, attr, fn)


def traced(fn):
    """Run fn under the profiler; return (wall ms, kernel events, all
    events)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.name.startswith(RANGE)]
    return wall_ms, kernels, events


def _region_of(evt):
    """The region whose range encloses a CPU event, innermost first."""
    while evt is not None:
        if evt.name.startswith(RANGE):
            return evt.name[len(RANGE):]
        evt = evt.cpu_parent
    return None


def _backward_parent(evt):
    """The backward node (scope 1) or the engine's call of it that encloses a
    CPU event; both carry the forward op's sequence number."""
    while evt is not None and not (
            evt.scope == 1 or evt.name.startswith("autograd::engine::evaluate_function")):
        evt = evt.cpu_parent
    return evt


def split_by_region(events, busy_ms: float) -> dict:
    """Device ms of each region: the kernels launched inside its range (its
    forward and, under remat, its recompute) and by the backward of each op
    that ran inside it (matched as torch.profiler matches them, by the
    forward op's sequence number and thread; a number that several forward
    ops saw belongs to the last, the op that made the autograd node); and
    the rest of the busy time."""
    cpu = sorted((e for e in events if e.device_type == DeviceType.CPU),
                 key=lambda e: e.time_range.start)
    forward = {}
    for e in cpu:
        if e.sequence_nr >= 0 and _backward_parent(e) is None:
            forward[(e.sequence_nr, e.thread)] = _region_of(e)
    ms = collections.Counter()
    for e in cpu:
        if not e.kernels:
            continue
        region = _region_of(e)
        if region is None:
            bwd = _backward_parent(e)
            if bwd is not None:
                region = forward.get((bwd.sequence_nr, bwd.fwd_thread))
        if region is not None:
            ms[region] += sum(k.duration for k in e.kernels) / 1e3
    out = {region: ms[region] for region, _, _ in REGIONS}
    out["rest"] = busy_ms - sum(out.values())
    return out


# device time by kind of kernel, by name: the port's own kernels, the
# matrix products (cuBLAS), and everything else (elementwise passes, copies,
# casts, reductions)
CATEGORIES = (("port_kernels", ("fa_fwd", "fa_bwd", "ssd_")),
              ("products", ("nvjet", "gemm", "xmma", "cutlass")))


def category(name: str) -> str:
    for cat, marks in CATEGORIES:
        if any(m in name for m in marks):
            return cat
    return "elementwise_and_other"


def summarize(phase, wall_ms, kernels, per=1, top=8, events=None, **extra):
    by_name = collections.Counter()
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us() / 1e3
    busy_ms = sum(by_name.values())
    if not kernels or busy_ms == 0:
        raise RuntimeError("the profiler recorded no device time")
    by_cat = collections.Counter()
    for name, ms in by_name.items():
        by_cat[category(name)] += ms
    if events is not None:
        extra["busy_ms_by_region"] = {
            r: ms / per for r, ms in split_by_region(events, busy_ms).items()}
    print(json.dumps({
        "phase": phase, **extra,
        "wall_ms": wall_ms / per, "device_busy_ms": busy_ms / per,
        "device_idle_share": max(0.0, 1 - busy_ms / wall_ms),
        "kernels": len(kernels) / per,
        "busy_ms_by_category": {c: ms / per for c, ms in by_cat.most_common()},
        "top_kernels": [{"name": n[:90], "ms": ms / per, "share_of_busy": ms / busy_ms}
                        for n, ms in by_name.most_common(top)],
    }), flush=True)


def profile_train(cfg, device, smi: str) -> None:
    """One traced train step after a warm-up step, on one batch."""
    model = get_model(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    state = {"params": model.init(cfg, gen, device)}
    state["opt"] = adamw_init(state["params"])
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT_LEN + 1),
                           generator=gen, device=device)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    step = make_train_step(cfg, AdamWConfig(lr=1e-5, warmup_steps=0))

    def run_step():
        state["params"], state["opt"], metrics = step(state["params"],
                                                      state["opt"], batch)
        state["loss"] = float(metrics["loss"])

    run_step()              # warm-up: library handles, the kernels' build
    print(json.dumps({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
                      "arch": cfg.arch, "layers": cfg.num_layers, "batch": BATCH,
                      "seq": PROMPT_LEN, "remat": cfg.remat}), flush=True)
    torch.cuda.reset_peak_memory_stats()
    with regions() if cfg.family == "moe" else contextlib.nullcontext():
        wall, kernels, events = traced(run_step)
    summarize("train_step", wall, kernels, top=14, loss=state["loss"],
              peak_memory_bytes=torch.cuda.max_memory_allocated(),
              events=events if cfg.family == "moe" else None)


def main() -> None:
    ap = argparse.ArgumentParser()
    # Whisper's prefill and loss take its frontend's frames: chip_smoke.py
    # drives it
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    choices=[a for a in PORTED_ARCHS if a != "whisper-large-v3"])
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth (default: the arch's full depth)")
    ap.add_argument("--train", action="store_true",
                    help="trace a train step instead of serving")
    args = ap.parse_args()
    device = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    cfg = get_config(args.arch)
    if args.layers:
        cfg = cfg.replace(num_layers=args.layers)
    if args.train:
        profile_train(cfg, device, smi)
        return
    model = get_model(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    params = model.init(cfg, gen, device)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT_LEN),
                            generator=gen, device=device)
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    state = {}

    def run_prefill():
        logits, cache = prefill(params, {"tokens": prompts})
        state["cache"] = pad_cache_to(cache, PROMPT_LEN + 2 * DECODE_STEPS + 2,
                                      cfg.window)
        state["tok"] = sample(logits, 0.0, None)

    def run_decode():
        for _ in range(DECODE_STEPS):
            logits, state["cache"] = decode(params, state["cache"],
                                            {"tokens": state["tok"]})
            state["tok"] = sample(logits, 0.0, None)

    run_prefill()           # warm-up: library handles, the kernel's build
    run_decode()
    print(json.dumps({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
                      "arch": args.arch, "layers": cfg.num_layers, "batch": BATCH,
                      "prompt_len": PROMPT_LEN}), flush=True)
    split = cfg.family == "moe"
    with regions() if split else contextlib.nullcontext():
        wall, kernels, events = traced(run_prefill)
        summarize("prefill", wall, kernels, events=events if split else None)
        wall, kernels, events = traced(run_decode)
        summarize("decode", wall, kernels, per=DECODE_STEPS, steps=DECODE_STEPS,
                  events=events if split else None)


if __name__ == "__main__":
    main()
