#!/usr/bin/env python3
"""Where the time goes when the PyTorch/CUDA port serves or trains a model.

    PYTHONPATH=src python3 scripts/profile_torch_serve.py [--arch A] [--layers N]
    PYTHONPATH=src python3 scripts/profile_torch_serve.py --train [--layers N]

Needs one CUDA card.  Serves the full-width model (tinyllama-1.1b unless
``--arch`` names another ported arch; random weights from a seed, batch 8 x
prompt 1024) and traces one prefill and a window of decode steps with
torch.profiler; with ``--train`` it instead trains the dense arch (bf16, the
config's remat, AdamW) on batch 8 x sequence 1024 and traces one train step
after a warm-up step.  Prints one JSON line per phase: the wall time, the time
the device was busy, its idle share, the number of kernels, and the kernels
that took most of the device time.
"""
from __future__ import annotations

import argparse
import collections
import json
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import PORTED_ARCHS, get_config
from repro_torch.launch.serve import pad_cache_to, resolve_device, sample
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models.common import get_model
from repro_torch.optim import AdamWConfig, adamw_init

BATCH, PROMPT_LEN, DECODE_STEPS = 8, 1024, 16


def traced(fn):
    """Run fn under the profiler; return (wall ms, kernel events)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return wall_ms, kernels


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


def summarize(phase, wall_ms, kernels, per=1, top=8, **extra):
    by_name = collections.Counter()
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us() / 1e3
    busy_ms = sum(by_name.values())
    if not kernels or busy_ms == 0:
        raise RuntimeError("the profiler recorded no device time")
    by_cat = collections.Counter()
    for name, ms in by_name.items():
        by_cat[category(name)] += ms
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
    wall, kernels = traced(run_step)
    summarize("train_step", wall, kernels, top=14, loss=state["loss"])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=PORTED_ARCHS)
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
        state["cache"] = pad_cache_to(cache, PROMPT_LEN + 2 * DECODE_STEPS + 2)
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
    wall, kernels = traced(run_prefill)
    summarize("prefill", wall, kernels)
    wall, kernels = traced(run_decode)
    summarize("decode", wall, kernels, per=DECODE_STEPS, steps=DECODE_STEPS)


if __name__ == "__main__":
    main()
