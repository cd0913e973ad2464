#!/usr/bin/env python3
"""What holds K3, the fluid surrogate's scan: each CUDA variant timed against
copies of its source with one part of a step cut out.

    PYTHONPATH=src python3 scripts/fluid_scan_ablation.py [--kernel block] [--kernel warp]

Needs one CUDA card and nvcc.  Each cut is csrc/fluid_scan.cu with checked
text edits, written into build/ablation/<cut>/ and built there with _build's
flags (-fmad=false among them; one nvcc each, started together), then loaded
in place of the library.  The cuts compute wrong results and are timings
only:
  block_as_is        fluid_scan_block as it is
  block_no_barriers  block_sum's and priority_alloc's __syncthreads replaced
                     by __syncwarp (cut)
  block_one_column   ring_sum reads one column instead of 64 (cut)
  block_no_alloc     both allocators replaced by a split with no pass: each
                     job min(demand, capacity / Jp) (cut)
  block_all_cut      the three cuts together: what is left of a step
  warp_as_is         fluid_scan_warp as it is
  warp_one_column    warp_ring_sum reads one column instead of 64 (cut)
  warp_no_alloc      both allocators replaced as in block_no_alloc (cut)
  warp_all_cut       the two cuts together
Timed on the bucket of the bench grid (benchmarks/bench_surrogate.py's 1000
cells of 128 padded jobs, built as scripts/bench_torch_surrogate.py builds
them) and on its first 64 cells, by CUDA events, in turns (every cut, then
every cut again in reverse order), each at the grid's horizon (512 steps;
every cell of the uncut kernels exits at 256) and at 256 steps, where every
cell integrates exactly 256 steps whatever a cut does to the dynamics.  The
split of a step is read at 256 steps: barriers = as_is - no_barriers, ring
sums = as_is - one_column, allocators = as_is - no_alloc (their barriers
included), the rest = all_cut, and the overlap of the three parts.  With
--buckets, both uncut variants are also timed in turns at every bucket the
warp variant takes (8 to 128 padded jobs: 132 cells of the `mix` preset
with 5/8 as many jobs on 20 x 2 machines, the bucket's most common
horizon), which is what kernel.variant's rule rests on.  Also prints, from
cuobjdump, each uncut CUDA kernel's instructions by kind
(shared, local and global loads and stores, shuffles, fp32 adds, barriers)
and its size.  One JSON line a result; the card's name and power limit
first.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import re
import shutil
import subprocess
import sys
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

REPO_ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO_ROOT / "src"))
sys.path.insert(0, str(REPO_ROOT / "scripts"))

from bench_torch_surrogate import build_inputs, sweep_spec              # noqa: E402
from repro_torch.core.types import ClusterSpec                         # noqa: E402
from repro_torch.experiments.runner import TraceRef                    # noqa: E402
from repro_torch.kernels import _build                                 # noqa: E402
from repro_torch.kernels.fluid_scan import kernel as fluid             # noqa: E402
from repro_torch.simcluster import surrogate as tsur                   # noqa: E402
from repro_torch.simcluster.traces import PRESETS                      # noqa: E402

GRID_SEEDS = 200
SUBBATCH = 64
SPLIT_STEPS = 256

# a split of the free slots with no pass over the jobs (a timing stand-in)
_NO_PASS = ("{\n#pragma unroll\n  for (int k = 0; k < K; ++k) "
            "alloc[k] = fminf(demand[k], capacity / static_cast<float>(Jp));\n}")

# (function's signature start, old text, new text, expected count) edits
# inside one function's body; a cut's edits are all of its parts'
PARTS = {
    "block_barriers": [
        ("__device__ __forceinline__ void block_sum(", "__syncthreads();", "__syncwarp();", 2),
        ("__device__ __forceinline__ void priority_alloc(", "__syncthreads();",
         "__syncwarp();", 4)],
    "block_rings": [
        ("__device__ __forceinline__ float ring_sum(", None,
         "{\n  return ring[j];\n}", 1)],
    "block_alloc": [
        ("__device__ __forceinline__ void allocate(", None, _NO_PASS, 1)],
    "warp_rings": [
        ("__device__ __forceinline__ float warp_ring_sum(", None,
         "{\n  return row[0];\n}", 1)],
    "warp_alloc": [
        ("__device__ __forceinline__ void warp_allocate(", None, _NO_PASS, 1)],
}
CUTS = {
    "block": {"block_as_is": [], "block_no_barriers": ["block_barriers"],
              "block_one_column": ["block_rings"], "block_no_alloc": ["block_alloc"],
              "block_all_cut": ["block_barriers", "block_rings", "block_alloc"]},
    "warp": {"warp_as_is": [], "warp_one_column": ["warp_rings"],
             "warp_no_alloc": ["warp_alloc"], "warp_all_cut": ["warp_rings", "warp_alloc"]},
}


def _function_span(text: str, signature: str) -> tuple:
    """(start, end) of the body of the one function whose definition starts
    with `signature`: from its opening brace to the closing brace at the
    start of a line."""
    at = text.find(signature)
    if at < 0 or text.find(signature, at + 1) >= 0:
        raise RuntimeError(f"the source holds {signature!r} "
                           f"{text.count(signature)} times, not once")
    body = text.index(") {\n", at) + 2
    end = text.index("\n}\n", body) + 2
    return body, end


def edited(text: str, parts: list) -> str:
    """`text` with each part's edits made, each checked to apply."""
    for part in parts:
        for signature, old, new, count in PARTS[part]:
            start, end = _function_span(text, signature)
            body = text[start:end]
            if old is None:                     # the whole body
                body = new
            else:
                if body.count(old) != count:
                    raise RuntimeError(f"{part}: {signature!r} holds {old!r} "
                                       f"{body.count(old)} times, not {count}")
                body = body.replace(old, new)
            text = text[:start] + body + text[end:]
    return text


def cut_sources(kernels: list, out_dir: Path) -> dict:
    """Each cut's source, in a directory of its own so that it keeps the
    stem (and so _build's flags) of fluid_scan.cu."""
    src = fluid.SOURCE.read_text()
    paths = {}
    for kern in kernels:
        for name, parts in CUTS[kern].items():
            path = out_dir / name / fluid.SOURCE.name
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(edited(src, parts))
            paths[name] = path
    return paths


# the SASS opcode families counted in each kernel, by full opcode
FAMILIES = ("LDS", "STS", "LD", "ST", "LDL", "STL", "LDG", "STG", "SHFL", "FADD", "FMUL",
            "FFMA", "MUFU", "BAR", "WARPSYNC", "VOTE", "CALL", "BRA")


def sass_counts(lib_path) -> dict:
    """Each CUDA kernel's instructions in all and by opcode (of FAMILIES), in
    the SASS of a built library."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    counts = {}
    for block in sass.split("Function : ")[1:]:
        m = re.search(r"(fluid_scan_(?:warp|block))ILi(\d+)", block.split("\n", 1)[0])
        if not m:
            continue
        ops = [ln.split("*/", 1)[1].split(";")[0].split() for ln in block.splitlines()
               if re.match(r"\s+/\*[0-9a-f]{4,}\*/", ln)]
        ops = [o[1] if o[0].startswith("@") else o[0] for o in ops if o]
        hist = Counter(ops)
        counts[f"{m.group(1)}<{m.group(2)}>"] = {
            "instructions": len(ops),
            **{op: n for op, n in sorted(hist.items()) if op.split(".")[0] in FAMILIES}}
    return counts


def time_ms(fn, iters: int) -> float:
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


def bucket_cells(jp: int, n_cells: int = 132) -> list:
    """n_cells cells of the `mix` preset whose jobs pad to `jp`, of the
    most common horizon among them."""
    cfg = dataclasses.replace(PRESETS["mix"], name=f"mix_{jp}", num_jobs=max(jp * 5 // 8, 5))
    cluster = ClusterSpec(num_machines=20, vms_per_machine=2, replication=1)
    cells, seed = [], 0
    while len(cells) < 4 * n_cells:
        trace = TraceRef(config=cfg).resolve(seed)
        cells += [tsur.build_cell(trace, cluster, pol, seed)
                  for pol in ("proposed", "fair", "fifo", "delay", "edf_nopark")]
        seed += 1
    horizons = [c.n_steps() for c in cells]
    ns = max(set(horizons), key=horizons.count)
    return [c for c in cells if c.n_steps() == ns][:n_cells]


def split(ms: dict, kern: str) -> dict:
    """The split of a step at SPLIT_STEPS steps, in ms and as shares of the
    uncut kernel's time."""
    a = ms[f"{kern}_as_is"]
    parts = {"ring_sums": a - ms[f"{kern}_one_column"],
             "allocators": a - ms[f"{kern}_no_alloc"]}
    if kern == "block":
        parts = {"barriers": a - ms["block_no_barriers"], **parts}
    parts["rest"] = ms[f"{kern}_all_cut"]
    parts["overlap"] = sum(parts.values()) - a
    return {"as_is_ms": a, "us_a_step": a * 1e3 / SPLIT_STEPS,
            "ms": parts, "share": {k: v / a for k, v in parts.items()}}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", action="append", choices=sorted(CUTS),
                    help="a variant to cut (repeatable; default both)")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--buckets", action="store_true",
                    help="also time both uncut variants at every bucket from 8 to 128 jobs")
    args = ap.parse_args()
    kernels = args.kernel or sorted(CUTS)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}),
          flush=True)
    paths = cut_sources(kernels, _build.BUILD_DIR / "ablation")
    with ThreadPoolExecutor(max_workers=len(paths)) as pool:
        libs = dict(zip(paths, pool.map(_build.build, paths.values())))
    for kern in kernels:
        print(json.dumps({"cut": f"{kern}_as_is", "sass": sass_counts(libs[f"{kern}_as_is"])}),
              flush=True)
    cells = build_inputs(sweep_spec(GRID_SEEDS))
    (jp, horizon), = sorted({(c.padded_jobs(), c.n_steps()) for c in cells})
    dev = torch.device("cuda")
    places = {"grid": tsur._stack(cells, dev), "subbatch": tsur._stack(cells[:SUBBATCH], dev)}
    for place, (jobs, order, scalars) in places.items():
        for n_steps in (horizon, SPLIT_STEPS):
            ms = {name: [] for name in libs}
            steps = {}
            for name in list(libs) + list(libs)[::-1]:
                fluid._lib = fluid.bind(ctypes.CDLL(str(libs[name])))
                kind = "fluid_scan_" + name.split("_")[0]

                def run():
                    return fluid.fluid_scan_cuda(jobs, order, scalars, tsur.PHYSICS,
                                                 n_steps=n_steps, variant=kind)

                ms[name].append(time_ms(run, args.iters))
                steps[name] = run()["steps"]
            for name in libs:
                print(json.dumps({
                    "place": place, "cells": jobs.shape[0], "padded_jobs": jp,
                    "n_steps": n_steps, "cut": name, "ms": min(ms[name]),
                    "ms_in_turns": ms[name],
                    "steps_integrated": [int(steps[name].min()), int(steps[name].max())]}),
                    flush=True)
            if n_steps == SPLIT_STEPS:
                best = {name: min(v) for name, v in ms.items()}
                for kern in kernels:
                    print(json.dumps({"place": place, "kernel": f"fluid_scan_{kern}",
                                      "split": split(best, kern)}), flush=True)
    if args.buckets:
        fluid._lib = fluid.bind(ctypes.CDLL(str(libs[f"{kernels[0]}_as_is"])))
        for jp in (8, 16, 32, 64, 128):
            cells = bucket_cells(jp)
            assert {c.padded_jobs() for c in cells} == {jp}
            ns = cells[0].n_steps()
            args_ = tsur._stack(cells, dev)
            ms = {v: [] for v in ("fluid_scan_warp", "fluid_scan_block")}
            for v in list(ms) + list(ms)[::-1]:
                ms[v].append(time_ms(lambda: fluid.fluid_scan_cuda(
                    *args_, tsur.PHYSICS, n_steps=ns, variant=v), args.iters))
            steps = fluid.fluid_scan_cuda(*args_, tsur.PHYSICS, n_steps=ns)["steps"]
            print(json.dumps({"bucket": [jp, ns], "cells": len(cells),
                              "steps_integrated": [int(steps.min()), int(steps.max())],
                              "rule": fluid.variant(jp), "ms": {v: min(x) for v, x in ms.items()},
                              "ms_in_turns": ms}), flush=True)
    fluid._lib = None


if __name__ == "__main__":
    main()
