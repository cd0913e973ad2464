#!/usr/bin/env python3
"""What holds K1b's wgmma backward: the kernel timed against copies of its
source with one design choice undone or one part of the work cut out.

    PYTHONPATH=src python3 scripts/flash_bwd_ablation.py

Needs one CUDA card and nvcc.  Each variant is flash_bwd.cu with a text
edit, built into build/ablation/ (one nvcc each, started together) and
loaded in place of the library.  At tinyllama-1.1b's training shape
(q [8,32,1024,64], k, v [8,4,1024,64]) and llama3.2-3b's (head dim 128),
bf16, causal, every variant is timed by CUDA events, in turns (all variants,
then all again in reverse order), and split between the two CUDA kernels by
torch.profiler.  The cuts compute wrong gradients and are timings only:
  as_is               the source as it is
  mask_every_element  the mask tested on every element of every tile
  unchained           each tile's second products waited for at once
  chained             kept in flight at head dim 128 too
  no_second_products  dQ, dK and dV products dropped, and with them the
                      elementwise pass whose results only they read (cut)
  no_ex2              P without ex2 (cut)
  no_dp_products      dP from its first k-step only (cut)
  no_o_loads          delta without reading O (cut)
Also prints, from cuobjdump, each wgmma kernel's HGMMA count beside its
wgmma waits (equal counts: ptxas serialized the products), and the
instructions between the wait for S and dP and the dQ products of
fa_bwd_dq_wgmma<64> (its elementwise pass; as_is holds two copies, with
and without the mask, mask_every_element one).  One JSON line a
result; the card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import kernel as fa
from repro_torch.kernels.flash_attention.ref import attention_ref

SHAPES = [(8, 32, 4, 1024, 1024, 64), (8, 24, 8, 1024, 1024, 128)]
EDITS = {
    "as_is": [],
    "mask_every_element": [
        ("if (tile_is_full(p, qw_start, 64, k_start, kWTile)) {", "if (false) {"),
        ("if (tile_is_full(p, q_start, kWTile, kw_start, 64)) {", "if (false) {")],
    "unchained": [("constexpr bool chain_products() {\n  return D == 64;",
                   "constexpr bool chain_products() {\n  return false;")],
    "chained": [("constexpr bool chain_products() {\n  return D == 64;",
                 "constexpr bool chain_products() {\n  return true;")],
    "no_second_products": [
        ("for (int kk = 0; kk < KN; ++kk) wgmma_rs_d<D>(dq, da[kk], mnmajor<kWTile>(Kt, kk));", ""),
        ("for (int kk = 0; kk < KN; ++kk) wgmma_rs_d<D>(dv, pa[kk], mnmajor<kWTile>(dOt, kk));", ""),
        ("for (int kk = 0; kk < KN; ++kk) wgmma_rs_d<D>(dk, sa[kk], mnmajor<kWTile>(Qt, kk));", "")],
    "no_ex2": [
        ("float pv = fast_exp2(fmaf(sc[i], p.scale_log2, -lse2[r]));",
         "float pv = sc[i] - lse2[r];"),
        ("float pt = fast_exp2(fmaf(st[i], p.scale_log2, -((e & 1) ? l2.y : l2.x)));",
         "float pt = st[i] - ((e & 1) ? l2.y : l2.x);")],
    "no_dp_products": [
        ("wgmma_ss_n64<0, 0>(dp, kmajor<kWRows>(dOw, kk), kmajor<kWTile>(Vt, kk), 1);", ""),
        ("wgmma_ss_n64<0, 0>(dpt, kmajor<kWRows>(Vw, kk), kmajor<kWTile>(dOt, kk), 1);", "")],
    "no_o_loads": [("      if (qpos_d < p.sq)\n        ov[i] =", "      if (qpos_d < 0)\n        ov[i] =")],
}


def variant_sources(out_dir: Path) -> dict:
    """Each variant's source, with the shared headers included by absolute
    path so that it builds from out_dir."""
    src = fa.SOURCE_BWD.read_text().replace(
        '#include "../../csrc/', f'#include "{_build.HEADER_DIR}/')
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, edits in EDITS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: the source no longer holds {old!r}")
            text = text.replace(old, new)
        paths[name] = out_dir / f"flash_bwd_{name}.cu"
        paths[name].write_text(text)
    return paths


def load(lib_path: Path) -> ctypes.CDLL:
    """A built variant with the argument types of kernel.load_bwd."""
    lib = ctypes.CDLL(str(lib_path))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fa_bwd.argtypes = ([ptr] * 10 + [i32] * 6 + [i64] * 15
                           + [i32, i32, ctypes.c_float, i32, ptr])
    lib.fa_bwd.restype = i32
    lib.fa_bwd_error_string.argtypes = [i32]
    lib.fa_bwd_error_string.restype = ctypes.c_char_p
    return lib


def time_ms(fn, iters: int = 30) -> float:
    for _ in range(3):
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


def split_ms(fn, calls: int = 10) -> dict:
    """Device ms a call of each CUDA kernel, by torch.profiler."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total", None) or getattr(evt, "cuda_time_total", 0)
        if us:
            name = evt.key.replace("void ", "").replace("(anonymous namespace)::", "")
            out[re.sub(r"\(.*", "", name)] = us / 1e3 / calls
    return out


def sass_counts(lib_path: Path) -> dict:
    """HGMMA instructions and wgmma waits of each wgmma kernel in the SASS;
    for fa_bwd_dq_wgmma<64> also the instructions from the last product of
    the S and dP batch to the next wgmma fence (the batch's wait and the
    elementwise pass before the dQ products)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    counts = {}
    for block in sass.split("Function : ")[1:]:
        name = block.split("\n", 1)[0]
        m = re.search(r"(fa_bwd_\w+_wgmma)ILi(\d+)", name)
        if not m:
            continue
        key = f"{m.group(1)}<{m.group(2)}>"
        counts[key] = {"hgmma": block.count("HGMMA."),
                       "waits": block.count("WARPGROUP.DEPBAR")}
        if key == "fa_bwd_dq_wgmma<64>":
            code = [ln for ln in block.splitlines() if re.match(r"\s+/\*[0-9a-f]{4}\*/", ln)]
            # the last HGMMA of the S and dP batch (shared-memory operands)
            first = next(i for i, ln in enumerate(code)
                         if "HGMMA." in ln and "gsb0" in ln and "tnspB" not in ln)
            fence = next(i for i in range(first, len(code)) if "WARPGROUP.ARRIVE" in code[i])
            counts[key]["elementwise_instructions"] = fence - first - 1
    return counts


def main() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}))
    paths = variant_sources(_build.BUILD_DIR / "ablation")
    with ThreadPoolExecutor(max_workers=len(paths)) as pool:
        libs = dict(zip(paths, pool.map(_build.build, paths.values())))
    for name in ("as_is", "mask_every_element"):
        print(json.dumps({"variant": name, "sass": sass_counts(libs[name])}))
    gen = torch.Generator(device="cuda").manual_seed(0)

    def make(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    for B, Hq, Hkv, Sq, Skv, D in SHAPES:
        q, k, v = make((B, Hq, Sq, D)), make((B, Hkv, Skv, D)), make((B, Hkv, Skv, D))
        out, lse = attention_ref(q, k, v, causal=True, return_lse=True)
        do = make((B, Hq, Sq, D))
        ms = {name: [] for name in libs}
        split = {}
        for name in list(libs) + list(libs)[::-1]:
            fa._lib_bwd = load(libs[name])
            fn = lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, causal=True)  # noqa: E731
            ms[name].append(time_ms(fn))
            if name not in split:
                split[name] = split_ms(fn)
        for name in libs:
            print(json.dumps({"shape": [B, Hq, Hkv, Sq, Skv, D], "variant": name,
                              "ms": min(ms[name]), "ms_in_turns": ms[name],
                              "split_ms": split[name]}))
    fa._lib_bwd = None


if __name__ == "__main__":
    main()
