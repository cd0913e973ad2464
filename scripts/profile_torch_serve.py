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
kernels that took most of the device time, and the busy time split by the
program's own spans (``repro_torch.spans``): each device operation goes, once,
to the innermost span open when the host launched it, or, for a backward, when
it ran the forward op: the step, the optimizer and its norm, the MoE layer's
router, dispatch, expert products and un-dispatch, MLA's cache expansion,
attention on the flash-attention kernels and on the dense path, the kernels'
own calls.
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

from repro_torch import spans
from repro_torch.configs import PORTED_ARCHS, get_config
from repro_torch.launch.serve import pad_cache_to, resolve_device, sample
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models.common import get_model
from repro_torch.optim import AdamWConfig, adamw_init

BATCH, PROMPT_LEN, DECODE_STEPS = 8, 1024, 16


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
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    return wall_ms, kernels, events


def _span_of(evt):
    """The innermost of the program's spans that encloses a CPU event, by its
    name without the prefix."""
    while evt is not None:
        if evt.name.startswith(spans.PREFIX):
            return evt.name[len(spans.PREFIX):]
        evt = evt.cpu_parent
    return None


def _backward_parent(evt):
    """The backward node (scope 1) or the engine's call of it that encloses a
    CPU event; both carry the forward op's sequence number."""
    while evt is not None and not (
            evt.scope == 1 or evt.name.startswith("autograd::engine::evaluate_function")):
        evt = evt.cpu_parent
    return evt


def split_by_span(events, busy_ms: float) -> dict:
    """Device ms of each span, largest first: the kernels launched inside it
    and no deeper span (its forward and, under remat, its recompute) and by
    the backward of each op that ran there (matched as torch.profiler
    matches them, by the forward op's sequence number and thread; a number
    that several forward ops saw belongs to the last, the op that made the
    autograd node); and the rest of the busy time.  A host event that shares
    its op's id carries the op's kernels too (``Command Buffer Full``, which
    the runtime records inside an op whose launch waited for room in the
    queue): each id's kernels count once, on the event that began first."""
    cpu = sorted((e for e in events if e.device_type == DeviceType.CPU),
                 key=lambda e: e.time_range.start)
    forward = {}
    for e in cpu:
        if e.sequence_nr >= 0 and _backward_parent(e) is None:
            forward[(e.sequence_nr, e.thread)] = _span_of(e)
    ms, counted = collections.Counter(), set()
    for e in cpu:
        if not e.kernels or e.id in counted:
            continue
        counted.add(e.id)
        span = _span_of(e)
        if span is None:
            bwd = _backward_parent(e)
            if bwd is not None:
                span = forward.get((bwd.sequence_nr, bwd.fwd_thread))
        if span is not None:
            ms[span] += sum(k.duration for k in e.kernels) / 1e3
    out = dict(ms.most_common())
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


def summarize(phase, wall_ms, kernels, events, per=1, top=8, **extra):
    by_name = collections.Counter()
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us() / 1e3
    busy_ms = sum(by_name.values())
    if not kernels or busy_ms == 0:
        raise RuntimeError("the profiler recorded no device time")
    by_cat = collections.Counter()
    for name, ms in by_name.items():
        by_cat[category(name)] += ms
    extra["busy_ms_by_span"] = {
        r: ms / per for r, ms in split_by_span(events, busy_ms).items()}
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
    wall, kernels, events = traced(run_step)
    summarize("train_step", wall, kernels, events, top=14, loss=state["loss"],
              peak_memory_bytes=torch.cuda.max_memory_allocated())


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
    wall, kernels, events = traced(run_prefill)
    summarize("prefill", wall, kernels, events)
    wall, kernels, events = traced(run_decode)
    summarize("decode", wall, kernels, events, per=DECODE_STEPS, steps=DECODE_STEPS)


if __name__ == "__main__":
    main()
