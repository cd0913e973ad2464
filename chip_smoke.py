#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on the GPU.

    python3 chip_smoke.py [--verbose-build]

Needs one NVIDIA Hopper card, `nvcc` and nothing else; no network.  It builds
the port's kernels (flash attention forward and backward, the Mamba-2 SSD
scan forward and backward, the fluid surrogate's scan) from the sources in
this checkout, holds each
against its plain PyTorch version on the card (naming the CUDA kernels that
each call launched, as the C functions count them), times the attention
forward and backward in turns against their earlier variants and PyTorch's
fused backends and the SSD scan's forward and backward against their
fp32-pipe variants, and each kernel at the full-width shapes of Qwen2-VL,
Whisper, Zamba2, nemotron-4-15b, Mixtral's window and DeepSeek's MLA (q·k
head dim 192, v 128); runs the paper's five
MapReduce workloads on 2^30 tokens on the card against a numpy oracle;
serves tinyllama-1.1b, stablelm-3b, mamba2-1.3b, qwen2-vl-2b, zamba2-1.2b,
whisper-large-v3, llama3.2-3b, nemotron-4-15b and deepseek-v2-lite-16b at
full width and depth, and mixtral-8x22b at full width and 8 of its 56 layers
(random weights from a seed: batch 8 x prompt 1024, 64 generated tokens;
Whisper 1500 frames of random embeddings and a decoder prompt of 375)
through the port's `launch.serve.generate`, and mixtral-8x22b once more past
its window (1 x 4608: a ring cache); trains all but nemotron-4-15b at full
width (batch 8 x 1024; Whisper 8 x 375 over 1500 frames; a few AdamW steps
through the port's train step), at full depth but the MoE archs' (6 layers
of deepseek-v2-lite-16b, 1 of mixtral-8x22b), holds the kernel paths against
the dense paths (fp32, and bf16 for the gradients), checks the results, and
saves and restores tinyllama-1.1b's full training state (the step after it
bit for bit).  The paper's batched fluid surrogate runs on the card too: the
1000-cell grid of benchmarks/bench_surrogate.py through the port's
`experiments.surrogate.run_surrogate` on the fluid scan's warp variant; both
of its CUDA variants are held bit for bit against its plain version over the
calibration cells, a sub-batch of the grid and one cell's diagnostics, the
block variant also over a bucket larger than the warp variant takes, the
determinism contract is checked on the card, and the two are timed in turns.
Its calibration runs on the port alone: `experiments.surrogate.calibrate` on
every calibrated (preset, shape) pair, the port's event engine on the host
as the oracle and the fluid scan on the card, must put every allowlisted
policy's gain inside the oracle's CI, and is served from its cache the
second time; the `surrogate` verb runs as a user runs it; and one cell at
20 and 100 machines is timed through both engines.  The paper's own
evaluation and the rest of the experiments layer run on the host as a user
runs them: `paper` at its twelve seeds must reproduce the paper's claims and
print the report a CPU test pins, the atlas's quick sub-grid runs and is then
served from its cache, `explain` exports its traces, and the two event
engines (the indexed one and the frozen seed engine) are timed side by side
and must agree on every decision.
The multi-rank layer runs on one rank of NCCL and a (data=1, model=1) mesh:
tinyllama-1.1b trains at full width and depth through the launcher's `train`
with `data_axis=1` (DTensor params, gradients redistributed onto them) in
turns with the plain one-device path, whose losses it must give (step 1
within 1e-6, step 2 within 5e-3) while launching the attention kernels
forward and backward; llama3.2-3b's attention runs through `attn_sm`'s row
layout on the forward kernel against the heads layout; `pipeline_apply`
runs one stage over tinyllama-1.1b's 22 layers against `reference_apply`;
and `compressed_psum` quantizes its full fp32 gradient tree to int8.
The paper's Algorithm 1 and Eq. 10 then move eight logical chips of the card
between three training jobs (tinyllama-1.1b at full width, two of its layers)
through the port's elastic fleet, by checkpoint, rebuild and restore, with a
host failed mid-run: every restore must give back the saved state bit for
bit, the attention kernels must run on the jobs' steps, and a step at widths
2 and 4 must give width 1's loss and gradients; examples/train_100m_torch.py
trains its 100 M-parameter preset on the card.
Every phase prints one JSON line; any failure raises, so the exit code is
not 0.  Everything printed also goes to `chiprun_out/chip_smoke.log`.  The
last line is `{"ok": true, "device": {...}}`.  Without a CUDA device it
prints no result and exits with code 1.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense, 700 W).
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# (B, Hq, Hkv, Sq, Skv, D) x (causal, window): the sweep of the JAX package's
# kernel tests, cases at the head dim 80 that stablelm-3b has at full width,
# and the wgmma kernel's edges at 80 and 32 (the last 64-column atom only
# part D); causal cases need Sq == Skv there and are left out otherwise.
SWEEP_SHAPES = [
    (1, 1, 1, 64, 64, 64),
    (2, 4, 2, 130, 130, 64),      # GQA + ragged
    (1, 2, 2, 97, 257, 128),      # cross lengths (non-causal)
    (2, 4, 2, 300, 300, 128),     # GQA + ragged at head dim 128, every mask
    (1, 8, 1, 64, 64, 32),        # MQA
    (2, 4, 4, 150, 150, 80),      # stablelm-3b's head dim, ragged
    (1, 2, 2, 40, 40, 80),        # Sq below one tile
    (1, 4, 2, 257, 130, 80),      # neither length a multiple of 128
    (1, 16, 1, 300, 300, 32),     # MQA, a group of 16
    (1, 4, 2, 257, 257, 32),
    (1, 12, 2, 300, 300, 128),    # Qwen2-VL's group of 6 at head dim 128, ragged
    (1, 4, 4, 375, 1500, 64),     # Whisper's cross-attention (non-causal)
    (1, 4, 4, 1500, 1500, 64),    # Whisper's encoder length
]
SWEEP_MASKS = [(True, None), (False, None), (True, 48)]
# (B, Hq, Hkv, Sq, Skv, D, Dv) at MLA's head dims (deepseek-v2-lite-16b: q·k
# 192 = nope 128 + rope 64, v 128), forward and backward, over the masks of
# each sweep: below one tile, ragged, GQA, Sq != Skv, a group of 1 as MLA has
MLA_SWEEP_SHAPES = [
    (1, 2, 2, 40, 40, 192, 128),
    (2, 4, 4, 130, 130, 192, 128),
    (1, 4, 2, 257, 257, 192, 128),
    (1, 2, 2, 97, 160, 192, 128),
    (1, 3, 3, 300, 300, 192, 128),
]
# deepseek-v2-lite-16b's attention at full width: 16 heads, each its own K
# and V (MLA expands them per head), batch 8 x 1024, timed in the kernels
# phases
MLA_ATTN_SHAPE = (8, 16, 16, 1024, 1024, 192, 128)
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
    # the edges of the wgmma variant (128-row items, 64-row tiles), at every
    # head dim (at 32 and 80 the last 64-column atom only part D)
    (1, 2, 2, 40, 40, 64),        # Sq below one tile
    (1, 2, 1, 40, 40, 128),
    (1, 2, 2, 40, 40, 80),
    (1, 2, 1, 40, 40, 32),
    (1, 4, 2, 257, 257, 64),      # neither length a multiple of 128
    (1, 4, 2, 257, 130, 128),     # and Skv < Sq
    (1, 4, 2, 257, 257, 80),
    (1, 4, 2, 257, 130, 32),
    (1, 16, 1, 300, 300, 64),     # MQA, a group of 16
    (1, 16, 1, 300, 300, 128),
    (1, 16, 1, 300, 300, 80),
    (1, 16, 1, 300, 300, 32),
    (1, 12, 2, 300, 300, 128),    # Qwen2-VL's group of 6, ragged
    (1, 4, 4, 375, 1500, 64),     # Whisper's cross-attention lengths
    (1, 4, 4, 1500, 1500, 64),    # Whisper's encoder length
]
BWD_MASKS = [(True, None), (False, None), (True, 48), (False, 16)]
# dq, dk, dv relative to max|plain|: fp32 sums in another order than the
# plain version's over up to 200 keys and 4 query heads a KV head; bf16
# rounds P and dS to bf16 for the second products
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# the training shapes: tinyllama-1.1b's attention at batch 8 x sequence 1024,
# and stablelm-3b's (head dim 80, MHA); llama3.2-3b's at head dim 128 and
# mixtral-8x22b's (48 / 8 heads of 128, NEMOTRON_ATTN_SHAPE: its window of
# 4096 does not mask at 1024); and head dim 32, which no config has at full
# width, at stablelm-3b's heads
TRAIN_ATTN_SHAPE = (8, 32, 4, 1024, 1024, 64)
STABLELM_ATTN_SHAPE = (8, 32, 32, 1024, 1024, 80)
BWD_D128_SHAPE = (8, 24, 8, 1024, 1024, 128)
D32_SHAPE = (8, 32, 32, 1024, 1024, 32)
# PyTorch's fused attention backends whose backward is timed as the library
# call (the fastest one is library_ms)
SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION")
# bf16 training parity: each gradient leaf, kernel path against dense path
BF16_GRAD_TOL = 5e-2

# (B, S, H, P, G, N, chunk) of the SSD scan: the sweep of the JAX package's
# kernel tests (the fp32-pipe kernel in both types), then chunks 64, 128 (the
# JAX kernel's default) and 256 (the model's) at mamba2-1.3b's P and N 128
# and zamba2-1.2b's N 64 (the tensor-core kernels in bf16, one or two
# 64-column atoms of the state), with groups and ragged last chunks.
SSD_SHAPES = [
    (1, 64, 2, 16, 1, 8, 32),
    (2, 100, 4, 16, 2, 8, 32),    # ragged + groups
    (1, 256, 8, 32, 8, 16, 64),
    (2, 200, 2, 64, 1, 128, 64),   # ragged, the smallest chunk of the mma path
    (2, 384, 4, 64, 1, 128, 128),
    (2, 512, 4, 64, 2, 128, 256),
    (1, 700, 4, 64, 1, 128, 256),  # ragged
    # three heads in a group (a head tile of one: the backward's second
    # warpgroup idle), the last chunk short of its second row tile
    (1, 300, 3, 64, 1, 128, 128),
    # Zamba2's N 64 in the corners of the wgmma domain: chunk 256, ragged;
    (1, 600, 8, 64, 1, 64, 256),
    (2, 200, 2, 64, 1, 64, 64),    # ragged, the smallest chunk
    (2, 384, 4, 64, 2, 64, 128),   # two groups
    (1, 300, 3, 64, 1, 64, 128),   # three heads in a group, a short last chunk
]
SSD_INIT_STATE = {1, 5, 7, 8, 9, 10, 11}   # cases also run from a random
# initial state (and, for the backward, with a gradient of the final state)

# K1 at llama3.2-3b's full width (head dim 128, 24 / 8 heads: a group of 3)
# and nemotron-4-15b's (48 / 8: a group of 6), timed beside the main paths'
# shapes
K1_D128_SHAPE = (8, 24, 8, 1024, 1024, 128)
NEMOTRON_ATTN_SHAPE = (8, 48, 8, 1024, 1024, 128)
# the later families' full-width shapes, timed too: Qwen2-VL's attention (a
# group of 6 at head dim 128), Whisper's cross-attention (375 decoder rows
# over 1500 frames, non-causal), its encoder's self-attention (1500 frames,
# non-causal) and its decoder's (375 rows, causal), Zamba2's scan (B, S, H,
# P, G, N; chunk 256: N 64, one 64-column atom of the state)
QWEN2_VL_ATTN_SHAPE = (8, 12, 2, 1024, 1024, 128)
WHISPER_CROSS_SHAPE = (8, 20, 20, 375, 1500, 64)
WHISPER_ENCODER_SHAPE = (8, 20, 20, 1500, 1500, 64)
WHISPER_DECODER_SHAPE = (8, 20, 20, 375, 375, 64)
ZAMBA2_SSD_SHAPE = (8, 1024, 64, 64, 1, 64)
# mixtral-8x22b past its window: one prompt of 4096 + 512, 48 / 8 heads of
# 128, causal, window 4096 (its main path's 1024 is inside the window)
MIXTRAL_WINDOW = 4096
MIXTRAL_WINDOW_PROMPT = MIXTRAL_WINDOW + 512
MIXTRAL_WINDOW_DECODE = 4
MIXTRAL_WINDOW_SHAPE = (1, 48, 8, MIXTRAL_WINDOW_PROMPT, MIXTRAL_WINDOW_PROMPT, 128)

# The main paths: each arch served at batch 8 x prompt 1024, 64 generated
# tokens; Whisper's decoder over 1500 frames with a prompt of 1500 // 4
SERVE_ARCHS = ("tinyllama-1.1b", "stablelm-3b", "mamba2-1.3b", "qwen2-vl-2b",
               "zamba2-1.2b", "whisper-large-v3", "llama3.2-3b", "nemotron-4-15b",
               "deepseek-v2-lite-16b", "mixtral-8x22b")
# every arch serves at full depth but mixtral-8x22b: its 56 layers hold
# 140.6 B parameters, 281 GB in bf16; 8 hold 20.4 B (40.9 GB) and run 8 K1 a
# prefill (the full depth waits for four cards, ROADMAP M12)
SERVE_LAYERS = {"mixtral-8x22b": 8}
# The MoE archs' decode checks run where no token drops: the tokens that
# capacity drops differ between a prefill of 8 x 1024 and a decode of 8 x 1,
# which is routing, not the cache (the reference's own prefill/decode test
# does the same at capacity factor 8.0).  8.0 leaves every token of a group
# a slot at each expert only while the experts are at most 8 x top-k
# (mixtral-8x22b's 8 of top-2); deepseek-v2-lite-16b's 64 of top-6 need
# 64 / 6, which gives each expert a slot for every token (`no_drops`)
MOE_NO_DROPS = 8.0
BATCH, PROMPT_LEN, GEN = 8, 1024, 64
WHISPER_FRAMES = 1500
SEED = 0
# decode(token S) after prefill(S) against prefill(S + 1), in bf16 through 22
# or 48 layers: the two sides round at different places (attention: bf16
# probabilities over a bf16 cache against fp32 ones; SSD: the chunked scan's
# bf16 y against the recurrent step's), relative to max|logit|
DECODE_TOL = 5e-2
PARITY_TOL = 2e-4     # fp32, kernel path against dense path, 2 layers
# full-width configs for that: every served arch (2 layers; deepseek's first
# is its dense layer), and the train step's parity at 2 layers but
# mixtral-8x22b's 1 (its fp32 params, grads and moments at 2 layers would
# not fit 80 GB).  The MoE archs' chosen experts must be equal on both
# paths, each path routing on its own.  The router ranks bf16-rounded
# probabilities, so two correct fp32 paths (1e-7 apart) can order a
# near-tied pair differently: with K1 on MLA, deepseek-v2-lite-16b's 64
# experts flipped 2 of 8192 prefill tokens against the dense path.  Only the
# archs of ROUTING_TIE_ARCHS may show such flips, and only where each
# flipped slot is a tie of that rounding: the two experts' fp32
# probabilities under TIE_BF16_STEPS bf16 steps apart on both paths, the
# router's probabilities within PARITY_TOL.  The values are then compared
# with the dense path run again on the kernel path's experts
# (`replaying_routes`), so that both are one model; with no flip, with each
# path's own experts
TIE_BF16_STEPS = 1
ROUTING_TIE_ARCHS = ("deepseek-v2-lite-16b",)
PARITY_ARCHS = SERVE_ARCHS
PARITY_TRAIN_LAYERS = {"mixtral-8x22b": 1}
# Qwen2-VL's parity also takes one loss with vision embeddings prepended
VISION_TOKENS = 256

# The training paths: every served arch but nemotron-4-15b (bf16 weights, fp32
# grads and two fp32 moments of 15.6 B parameters do not fit one card) at
# full width and depth, bf16, the configs' remat ("full"; llama3.2-3b's
# "comm" checkpoints attention and FFN halves, which recomputes attention
# as often), batch 8 x sequence 1024, one warm-up step
# and then TRAIN_STEPS timed AdamW steps, all on the first batch of the synthetic
# pipeline, so the loss must fall from timed step to timed step, and end
# below the warm-up step's.  A first Adam step from random weights moves
# every weight by about lr in its gradient's sign, and raises the loss on
# both attention paths and with fp32 weights too; larger lrs without warm-up
# swing wider (scripts/train_lr_sweep.py), so these steps take a small one
TRAIN_ARCHS = ("tinyllama-1.1b", "stablelm-3b", "mamba2-1.3b", "qwen2-vl-2b",
               "zamba2-1.2b", "whisper-large-v3", "llama3.2-3b",
               "deepseek-v2-lite-16b", "mixtral-8x22b")
# the MoE archs train at full width and a cut depth, their state (bf16
# params, fp32 grads, two fp32 moments: some 14 bytes a parameter) within one
# card: deepseek-v2-lite-16b's first 6 layers (1 dense + 5 MoE, 3.42 B
# parameters, about 48 GB) and mixtral-8x22b's 1 (2.91 B, about 41 GB; 2 K1
# and 1 K1b a step)
TRAIN_LAYERS = {"deepseek-v2-lite-16b": 6, "mixtral-8x22b": 1}
TRAIN_STEPS = 3
TRAIN_OPT = dict(lr=1e-5, warmup_steps=0)
# qwen2-vl-2b's and zamba2-1.2b's losses swing at lr 1e-5 (12.12, 9.75,
# 11.30, 10.29 and 10.77, 8.68, 8.83, 8.12) on both attention paths alike
# and with fp32 weights too; at 3e-6 they fall step after step
# (scripts/train_lr_sweep.py --arch ...), so their steps take that
TRAIN_LR = {"qwen2-vl-2b": 3e-6, "zamba2-1.2b": 3e-6}
# deepseek-v2-lite-16b's (6 layers) swings at lr 1e-5 without warm-up too
# (11.98, 9.93, 10.05, 9.08, on both paths alike and with fp32 weights); at
# 1e-5 with the schedule's warm-up over 4 steps it falls step after step
# (11.98, 11.78, 11.05, 10.27; scripts/train_lr_sweep.py --layers 6), so
# its steps take that
TRAIN_WARMUP = {"deepseek-v2-lite-16b": 4}
# Adam's update lr·m̂/(√v̂ + eps) is ill-conditioned where the gradient (after
# the clip) is within a hundred eps of zero: a difference at rounding level
# there moves an element by up to 2 lr.  The on-card parity of the updated
# params counts such elements and holds the rest to PARITY_TOL.
NEAR_ZERO_GRAD = 1e-6

# The MapReduce data plane: each of the paper's five workloads on one job of
# 256 blocks of 4 Mi tokens (2^30 int32 tokens, 4 GiB on the card, 16 MiB a
# block), 8 reducers; the oracle's vocabulary and grep's needle
MR_JOB = dict(n_blocks=256, block_tokens=1 << 22, n_reducers=8, seed=SEED)
MR_VOCAB, MR_NEEDLE = 4096, 7
# The checkpoint phase's model: its full training state (bf16 params, fp32
# moments) saved, restored, and stepped on
CKPT_ARCH = "tinyllama-1.1b"
# The fluid surrogate: the grid of benchmarks/bench_surrogate.py (the
# heavy_tail preset on a 200-machine x 2-VM fleet, replication 2, the five
# lowerable policies x 200 seeds: 1000 cells of 80 jobs, padded to 128, 512
# steps), the calibration cells (the CALIBRATED presets at 20 x 2, seeds 0-3),
# and one bucket larger than the kernel's block: 1500 jobs of the `mix`
# preset arriving at 7200 an hour on 200 x 2 (2048 padded jobs)
SUR_POLICIES = ("proposed", "fair", "fifo", "delay", "edf_nopark")
SUR_GRID_SEEDS = 200
SUR_BIG = dict(num_jobs=1500, rate_per_hour=7200.0)
SUR_SUBBATCH = 64          # the original's sub-batch: the plain version's timing
SUR_TIMING_ITERS = 5       # launches a reading, both variants in turns
SUR_LOCALITY_TOL = 1e-6
# the calibration phase: the surrogate verb as a user runs it, and the shapes
# of the one heavy_tail cell timed through both engines
CAL_VERB = ("surrogate", "--shape", "20x2", "--seeds", "0:8")
CAL_VERB_TIMEOUT_S = 300
CAL_HOST_SHAPES = ("20x2", "100x2")
# fp32 operations of one integrated step a padded job, counted for the bound:
# the four rings' sums over 64 columns (63 adds each) and some 80 elementwise
# operations; the allocators' rounds, which depend on the data, are left out,
# so the bound is below what the data needs
FLUID_OPS_PER_JOB_STEP = 4 * 63 + 80
# the experiments phase: the paper's §5 evaluation and the rest of the
# experiments layer as a user runs them, on the host.  PAPER_REPORT is what
# `python -m repro_torch.experiments paper` prints at its twelve seeds into a
# fresh cache: the JAX package's report, byte for byte (tests/test_torch_paper.py
# holds it to the original on the CPU; the card machine has no JAX)
PAPER_REPORT = (
    '== paper reproduction (proposed vs fair, 12 paired seeds; 24 simulated, 0 cached) ==\n'
    '  throughput_jobs_per_hour: fair 53.7 vs proposed 67.2  gain +27.5% [+11.9%, +41.7%] (95% CI, n=12, win rate 83%)   (paper claims ~12%)\n'
    '  deadlines met/run: fair 5.0 -> proposed 5.0\n'
    '  Fig.3 per-workload completion-time gain:\n'
    '    sort              +31.7% [ +25.8%,  +38.3%]\n'
    '    grep              +20.6% [ +15.0%,  +27.2%]\n'
    '    wordcount         +19.9% [ +10.7%,  +29.2%]\n'
    '    inverted_index    +14.2% [  -0.9%,  +26.5%]\n'
    '    permutation       -19.9% [ -42.5%,   +1.5%]\n'
    '  weakest-gain workload: permutation (paper: permutation)\n'
    '  claims: REPRODUCED')
EXP_TIMEOUT_S = 600
# the atlas's --quick sub-grid (5 presets x {20x2, 50x2} x 2 seeds x 6 policy
# columns = 120 cells; the full atlas has 2,928) with one serving
# profile, so that the serve report and its markdown section are written too
# (2 shapes x 2 seeds x harvest / adaptive = 8 cells)
ATLAS_SERVE = "svc_heavy_loose"
ATLAS_CELLS = 120
ATLAS_SERVE_CELLS = 8
EXPLAIN_CELL = ("heavy_tail", "20x2")
LOG = ROOT / "chiprun_out" / "chip_smoke.log"


# The parallel phase (M12): a one-rank NCCL group and a (data=1, model=1)
# mesh.  PARALLEL_ARCH trains at full width and depth, bf16, batch 8 x 1024,
# through the launcher's `train` on the mesh path (DTensor params,
# redistributed grads) and on the plain one-device path, in turns: a warm-up
# step and PARALLEL_STEPS - 1 timed ones each.  llama3.2-3b's attention runs
# through attn_sm's row layout (8 x 24 rows, KV repeated) against K1 on the
# heads layout; the pipeline runs one stage over PARALLEL_ARCH's 22 layers,
# PARALLEL_MICRO microbatches of 1 x 1024; the int8 compression runs over
# PARALLEL_ARCH's full fp32 gradient tree
PARALLEL_ARCH = "tinyllama-1.1b"
PARALLEL_STEPS = 3
PARALLEL_TURNS = 2
PARALLEL_LR = 1e-5
PARALLEL_STEP1_TOL = 1e-6
PARALLEL_STEP2_TOL = 5e-3
PARALLEL_ATTN_SHAPE = (8, 24, 8, 1024, 1024, 128)
PARALLEL_MICRO = 8
# The fleet phase (M13): the paper's Algorithm 1 and Eq. 10 moving chips
# between three training jobs (examples/deadline_fleet_torch.py's job factory
# and failure hook) on eight logical chips of cuda:0, two hosts of four.
# Each job is FLEET_ARCH at full width cut to FLEET_LAYERS of its 22 layers
# (its state, bf16 params and fp32 moments, is 2.2 GB: a resize saves and
# restores it), bf16, batch 8 x 1024.  Deadlines are FLEET_DEADLINE_X times
# the job's steps at a measured width-1 step: the urgent job's is half what
# it needs alone on one chip, so while it shares the card its Eq.-10 demand
# exceeds one chip whatever the noise in that measurement.  The fleet's clock counts training steps only: it leaves
# out checkpoint saves, rebuilds and restores (seconds each, printed), which
# would otherwise blow every deadline set from step times at the first
# resize.  Host 1 fails at the first rebalance after the urgent job is done
# (its chips are free then, so the failed jobs can recover).  The jobs take
# the train phases' AdamW (TRAIN_OPT: at full width the demo's lr 1e-3 raises
# the first steps' losses), a checkpoint every FLEET_CKPT_EVERY steps.
# FLEET_WIDTHS: one step at each width of one job against the width-1 step.
FLEET_ARCH = "tinyllama-1.1b"
FLEET_LAYERS = 2
FLEET_STEPS = {"job-urgent": 8, "job-mid": 16, "job-lazy": 4}
FLEET_HOSTS = {"job-urgent": 0, "job-mid": 1, "job-lazy": 1}
FLEET_DEADLINE_X = {"job-urgent": 0.5, "job-mid": 25, "job-lazy": 100}
FLEET_WIDTHS = (2, 4)
FLEET_FAIL_HOST = 1
FLEET_CKPT_EVERY = 8
# examples/train_100m_torch.py as a user runs it on the card
TRAIN_100M_ARGS = ("--preset", "100m")
# K4 (AdamW's norm and update) at the training cell's optimizer: the leaf set
# of deepseek-v2-lite-16b's first 6 layers (83 leaves, 3.42 B parameters; bf16
# params and fp32 routers, fp32 grads and moments: about 48 GB, and the state
# before the checked step, 34 GB, on the host)
ADAMW_ARCH = "deepseek-v2-lite-16b"
ADAMW_LAYERS = 6

def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def release() -> None:
    """Give the memory of the phase before back to the card, so that each
    phase's peak is its own and the large ones fit one after another."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def cuda_kernel_counts() -> dict:
    """Launches of every CUDA kernel of the port since its libraries were
    loaded, as the C functions count them (the SSD scan's: forward and
    backward)."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.fluid_scan import kernel as fluid
    from repro_torch.kernels.ssd_scan import kernel as kssd
    return {**fa.launch_counts(), **kssd.launch_counts(), **fluid.launch_counts()}


def cuda_kernels_since(before: dict) -> dict:
    return {k: n - before[k] for k, n in cuda_kernel_counts().items() if n != before[k]}


def op_calls(cfg) -> dict:
    """Calls of each kernel-backed op in one forward of `cfg` (a prefill, or
    the forward of a loss), as (calls inside a layer that remat recomputes,
    calls outside one): attention in every dense and Qwen2-VL layer, in
    every Whisper encoder layer and twice in every decoder layer (its own and
    the cross-attention); the scan in every Mamba layer; Zamba2's shared
    block, outside the checkpoint, once each application; Mixtral's
    attention and DeepSeek's MLA in every layer (DeepSeek's dense first
    layer outside the checkpoint)."""
    L = cfg.num_layers
    attn, scan = (0, 0), (0, 0)
    if cfg.family in ("dense", "vlm"):
        attn = (L, 0)
    elif cfg.family == "moe":
        attn = (L - cfg.n_dense_layers, cfg.n_dense_layers)
    elif cfg.family == "ssm":
        scan = (L, 0)
    elif cfg.family == "hybrid":
        attn, scan = (0, -(-L // cfg.shared_attn_period)), (L, 0)
    elif cfg.family == "encdec":
        attn = (cfg.enc_layers + 2 * cfg.dec_layers, 0)
    return {"attention": attn, "scan": scan}


def attention_head_dims(cfg) -> tuple:
    """(q·k head dim, v head dim) of `cfg`'s attention: MLA's nope + rope and
    v, the head dim twice elsewhere."""
    if cfg.kv_lora_rank:
        return cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim
    return cfg.resolved_head_dim, cfg.resolved_head_dim


def variant_kernels(cfg, op: str) -> tuple:
    """The CUDA kernels of the rule's forward and backward variants of `op`
    ("flash_attention" or "ssd_scan") for `cfg`'s type and shapes."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.ssd_scan import kernel as kssd
    dt = cfg.compute_dtype
    if op == "flash_attention":
        dims = attention_head_dims(cfg)
        return (fa.VARIANT_KERNELS[fa.variant(dt, *dims)],
                fa.VARIANT_KERNELS_BWD[fa.variant_bwd(dt, *dims)])
    shape = (cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_chunk)
    return (kssd.VARIANT_KERNELS[kssd.variant(dt, *shape)],
            kssd.VARIANT_KERNELS_BWD[kssd.variant_bwd(dt, *shape)])


def expected_launches(cfg, train_steps: int = 0) -> tuple:
    """The launches of each op (`flash_attention_fwd` ...) and of each CUDA
    kernel that one prefill of `cfg` (train_steps 0) or `train_steps` train
    steps under remat "full" or "comm" make: in a step each forward call
    inside a checkpointed layer (or attention half) runs twice (the forward,
    and the recompute), each backward once.  The CUDA kernels are those of
    the rule's variants."""
    ops, kernels = {}, {}
    calls = op_calls(cfg)
    for op, (inner, outer) in (("flash_attention", calls["attention"]),
                               ("ssd_scan", calls["scan"])):
        fwd = (2 * inner + outer) * train_steps if train_steps else inner + outer
        bwd = (inner + outer) * train_steps
        ops[op + "_fwd"], ops[op + "_bwd"] = fwd, bwd
        if not fwd:
            continue
        fwd_kernels, bwd_kernels = variant_kernels(cfg, op)
        for names, n in ((fwd_kernels, fwd), (bwd_kernels, bwd)):
            for name in names if n else ():
                kernels[name] = kernels.get(name, 0) + n
    return ops, kernels


@contextlib.contextmanager
def counting_dense_attention():
    """Counts, in `calls["dense"]`, the calls of the port's dense attention
    core (`layers.attention_dense`) made inside the block."""
    from repro_torch.models import layers
    fn, calls = layers.attention_dense, {"dense": 0}

    def counted(*args, **kwargs):
        calls["dense"] += 1
        return fn(*args, **kwargs)
    layers.attention_dense = counted
    try:
        yield calls
    finally:
        layers.attention_dense = fn


@contextlib.contextmanager
def recording_routes():
    """The experts that each MoE layer chose inside the block, in call order:
    one [G, T, k] tensor a call of `moe.route`."""
    from repro_torch.models import moe
    fn, chosen = moe.route, []

    def recorded(*args, **kwargs):
        probs, idx, gate = fn(*args, **kwargs)
        chosen.append(idx.detach().clone())
        return probs, idx, gate
    moe.route = recorded
    try:
        yield chosen
    finally:
        moe.route = fn


def routing_flips(a: list, b: list) -> dict:
    """Tokens whose chosen experts differ between two recordings of the same
    calls, and the tokens routed."""
    if len(a) != len(b):
        raise AssertionError(f"{len(a)} routing calls against {len(b)}")
    return {"routing_flips": sum(int((x != y).any(-1).sum()) for x, y in zip(a, b)),
            "routed_tokens": sum(x.shape[0] * x.shape[1] for x in a)}


@contextlib.contextmanager
def recording_probs():
    """The router's fp32 probabilities of each call of `moe.route` inside the
    block, in call order: one [G, T, E] tensor a call."""
    from repro_torch.models import moe
    fn, probs = moe.route, []

    def recorded(*args, **kwargs):
        out = fn(*args, **kwargs)
        probs.append(out[0].detach().float().clone())
        return out
    moe.route = recorded
    try:
        yield probs
    finally:
        moe.route = fn


def routing_ties(routes_a: list, probs_a: list, routes_b: list, probs_b: list) -> dict:
    """Two recordings of the same calls on two paths: the flips
    (`routing_flips`), the router's probabilities' largest rel err, and at
    every top-k slot where the paths chose other experts the fp32 gap
    between the two experts' probabilities, on each path, in bf16 steps
    (2^-7 of the larger one's power of two): under about one step the pair
    rounds to one bf16 value or to neighbours, a tie the router breaks by
    rounding, not a different model."""
    from repro_torch.testing import rel_err
    worst = 0.0
    for ia, pa, ib, pb in zip(routes_a, probs_a, routes_b, probs_b):
        ia, ib = ia.reshape(-1, ia.shape[-1]), ib.reshape(-1, ib.shape[-1])
        pa, pb = pa.reshape(-1, pa.shape[-1]), pb.reshape(-1, pb.shape[-1])
        tok, slot = torch.nonzero(ia != ib, as_tuple=True)
        x, y = ia[tok, slot], ib[tok, slot]
        for p in (pa, pb):
            px, py = p[tok, x], p[tok, y]
            step = torch.exp2(torch.floor(torch.log2(torch.maximum(px, py))) - 7)
            if tok.numel():
                worst = max(worst, float(((px - py).abs() / step).max()))
    return {**routing_flips(routes_a, routes_b),
            "router_probs_rel_err": max(rel_err(a, b) for a, b in zip(probs_a, probs_b)),
            "flip_gap_bf16_steps": worst, "tie_bf16_steps": TIE_BF16_STEPS}


def routing_agrees(arch: str, ties: dict) -> bool:
    """The paths routed some tokens and chose the same experts for every
    one, or, for an arch of ROUTING_TIE_ARCHS, other experts only at bf16
    ties (`routing_ties`) from router probabilities that agree."""
    if not ties["routed_tokens"]:
        return False
    if not ties["routing_flips"]:
        return True
    return bool(arch in ROUTING_TIE_ARCHS and ties["router_probs_rel_err"] < PARITY_TOL
                and ties["flip_gap_bf16_steps"] < TIE_BF16_STEPS)


def on_both_paths(arch: str, run_k, run_d):
    """`run_k` on the kernel path and `run_d` on the dense path, each with
    its own experts, and for a MoE arch what they chose (`routing_ties`).
    Where the experts differ and `routing_agrees` lets them, `run_d` runs
    again on the kernel path's experts, so that the values compared are
    those of one model.  -> (out_k, out_d, ties ({} but for a MoE arch),
    whether the dense path took the kernel path's experts)."""
    from repro_torch.configs import get_config
    if get_config(arch).family != "moe":
        return run_k(), run_d(), {}, False
    with recording_routes() as routes_k, recording_probs() as probs_k:
        out_k = run_k()
    with recording_routes() as routes_d, recording_probs() as probs_d:
        out_d = run_d()
    ties = routing_ties(routes_k, probs_k, routes_d, probs_d)
    replayed = bool(ties["routing_flips"]) and routing_agrees(arch, ties)
    if replayed:
        out_d = None
        with replaying_routes(routes_k):
            out_d = run_d()
    return out_k, out_d, ties, replayed


def last_tokens(routes: list, batch: int) -> list:
    """The experts that each batch row's last token chose, a [batch, k]
    tensor for each call of a recording (`recording_routes`)."""
    return [idx.reshape(batch, -1, idx.shape[-1])[:, -1] for idx in routes]


@contextlib.contextmanager
def replaying_routes(chosen: list):
    """Each call of `moe.route` inside the block takes the experts of the
    matching entry of `chosen` (in call order, one row a token the call
    routes) in place of its own, with gates from its own probabilities; the
    block must make as many calls as `chosen` holds.  `flips` counts, in
    "routing_flips", the tokens whose own choice was other, and in
    "routed_tokens" the tokens routed."""
    from repro_torch.models import moe
    fn, calls = moe.route, iter(chosen)
    flips = {"routing_flips": 0, "routed_tokens": 0}

    def replayed(*args, **kwargs):
        probs, idx, _ = fn(*args, **kwargs)
        want = next(calls, None)
        if want is None:
            raise AssertionError("more routing calls than were recorded")
        want = want.reshape(idx.shape)
        flips["routing_flips"] += int((idx != want).any(-1).sum())
        flips["routed_tokens"] += idx.shape[0] * idx.shape[1]
        return probs, want, moe.gates(probs, want)
    moe.route = replayed
    try:
        yield flips
    finally:
        moe.route = fn
    if next(calls, None) is not None:
        raise AssertionError("fewer routing calls than were recorded")


def no_drops(cfg):
    """`cfg` at a capacity factor (MOE_NO_DROPS, or experts / top-k where
    that is more) at which each expert has a slot for every token of a
    dispatch group, so that no token drops."""
    return cfg.replace(capacity_factor=max(MOE_NO_DROPS, cfg.n_experts / cfg.top_k))


def dropped_choices(cfg, routes: list) -> int:
    """(token, expert) choices that capacity dropped in the calls of a
    recording (`recording_routes`) made at `cfg`."""
    from repro_torch.models import moe
    dropped = 0
    for idx in routes:
        G, T, _ = idx.shape
        per_expert = F.one_hot(idx.reshape(G, -1), cfg.n_experts).sum(1)   # [G, E]
        dropped += int((per_expert - moe.capacity(cfg, T)).clamp_min(0).sum())
    return dropped


def cache_tensors(cache: dict, prefix: str = ""):
    """(path, tensor) of every tensor of a cache, nested dicts included."""
    for key, val in cache.items():
        if isinstance(val, dict):
            yield from cache_tensors(val, f"{prefix}{key}/")
        elif isinstance(val, torch.Tensor):
            yield prefix + key, val


def served_config(arch: str):
    """`arch`'s full config at the depth it serves at (SERVE_LAYERS)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return cfg.replace(num_layers=SERVE_LAYERS[arch]) if arch in SERVE_LAYERS else cfg


# the wrappers' calls that went to their CUDA kernels: counters of
# repro_torch.spans, read as differences from reset_op_counts()
OP_COUNTERS = {"flash_attention_fwd": "kernel.fa_fwd", "flash_attention_bwd": "kernel.fa_bwd",
               "ssd_scan_fwd": "kernel.ssd_fwd", "ssd_scan_bwd": "kernel.ssd_bwd"}
_op_base: dict = {}


def op_counts() -> dict:
    from repro_torch import spans
    now = spans.counters()
    return {op: now[c] - _op_base.get(c, 0) for op, c in OP_COUNTERS.items()}


def reset_op_counts() -> None:
    from repro_torch import spans
    now = spans.counters()
    _op_base.update({c: now[c] for c in OP_COUNTERS.values()})


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
    over the visible pairs, Q K^T at q's head dim and P V at v's) over the
    peak rate for the type."""
    B, Hq, Sq, D = q.shape
    Dv = v.shape[-1]
    n_bytes = (q.numel() + k.numel() + v.numel() + B * Hq * Sq * Dv) * q.element_size()
    flops = 2 * B * Hq * (D + Dv) * visible_pairs(Sq, k.shape[2], causal, window)
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


def ssd_bwd_bound_ms(x, dt, A, B_, C, chunk, init_state=None, d_final_state=None):
    """Least time the card could take for the SSD scan's backward: the larger
    of bytes moved (x, dt, A, B, C, dy and, where given, init_state and the
    final state's gradient read once; dx, ddt, dA, dB, dC and, where
    init_state is given, its gradient written once) over the memory rate and
    operations over the peak rate for x's type.  Operations are the least
    that the algebra needs for these inputs, once each: over the pairs j <= i
    of each chunk, C.B^T and dC = G B and dB = G^T C once per group (B and C
    serve every head of a group, so dC and dB need only the sum over its
    heads of G = L o (dy.u^T)), and per head dy.u^T and du = M^T dy; per row
    and head the chunk's two state terms and the terms from the states at
    the chunk's ends, 2 P N each, five of them.  (Counting dC and dB per
    head, as both kernels do, adds 2 B H pairs 2 N: 94.9 GFLOP in all at
    mamba2-1.3b's training shape, against the 61.0 counted here.)"""
    Bsz, S, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    states = 0 if init_state is None else 2 * init_state.numel()
    states += 0 if d_final_state is None else d_final_state.numel()
    n_bytes = (3 * x.numel() + 2 * (B_.numel() + C.numel())) * x.element_size() \
        + (2 * dt.numel() + 2 * A.numel() + states) * 4
    rows = [min(chunk, S - c0) for c0 in range(0, S, chunk)]
    pairs = sum(q * (q + 1) // 2 for q in rows)
    flops = 2 * Bsz * (3 * G * N * pairs + 2 * H * P * pairs + 5 * H * P * N * S)
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


def in_turns(turns, iters: int):
    """Each (name, fn) of `turns` timed in turns, then again in reverse order
    (a, b, c, c, b, a): each name's readings, and the readings in order."""
    ms, order = {name: [] for name, _ in turns}, []
    for name, fn in turns + turns[::-1]:
        ms[name].append(time_ms(fn, iters))
        order.append([name, ms[name][-1]])
    return ms, order


def ssd_wgmma_domain(dtype, P: int, N: int, chunk: int) -> bool:
    """Where the SSD scan's rule must name the wgmma variants, forward and
    backward: bf16 at P 64, N 64 or 128, chunk 64 and up."""
    return dtype == torch.bfloat16 and P == 64 and N in (64, 128) and chunk >= 64


def library_attention(q, k, v, causal, window=None):
    """One PyTorch call for the same function: the yardstick, used nowhere in
    the port.  A window goes in as a boolean mask (no fused backend takes a
    sliding window by itself)."""
    if window is None:
        return lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True)
    qpos = torch.arange(q.shape[2], device=q.device)[:, None]
    kpos = torch.arange(k.shape[2], device=q.device)[None, :]
    mask = qpos - kpos < window
    if causal:
        mask &= qpos >= kpos
    return lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True)


def sdpa_forward(q, k, v, causal, backend: str):
    """`F.scaled_dot_product_attention` under one backend alone: a call, or
    None where the backend refuses the inputs.  The yardstick, used nowhere
    in the port."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    gqa = q.shape[1] != k.shape[1]

    def call():
        with sdpa_kernel(getattr(SDPBackend, backend)):
            return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                  enable_gqa=gqa)
    try:
        call()
        torch.cuda.synchronize()
    except RuntimeError:
        return None
    return call


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
    from repro_torch.kernels.adamw import kernel as k4
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.fluid_scan import kernel as fluid
    from repro_torch.kernels.ssd_scan import kernel as ssd
    sources = (fa.SOURCE, fa.SOURCE_BWD, ssd.SOURCE, ssd.SOURCE_BWD, fluid.SOURCE, k4.SOURCE)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        libs = list(pool.map(lambda src: _build.build(src, verbose), sources))
    fa.load(), fa.load_bwd(), ssd.load(), ssd.load_bwd(), fluid.load(), k4.load()
    emit("build", kernels=["flash_attention_fwd", "flash_attention_bwd",
                           "ssd_scan_fwd", "ssd_scan_bwd", "fluid_scan", "adamw"],
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
                if (ran == "fa_fwd_wgmma") != (dtype == torch.bfloat16):
                    raise AssertionError(f"{dtype} at head dim {D} ran {ran}")
                ref = attention_ref(q, k, v, causal=causal, window=window)
                err = rel_err(out, ref)
                cases.append({"shape": [B, Hq, Hkv, Sq, Skv, D],
                              "dtype": str(dtype).split(".")[1],
                              "variant": ran,
                              "causal": causal, "window": window,
                              "rel_err": err, "tol": TOL[dtype]})
                if not (err < TOL[dtype]) or not torch.isfinite(out).all():
                    raise AssertionError(f"flash_attention disagrees: {cases[-1]}")
        # MLA's head dims: q and k at 192, v and the output at 128
        for (B, Hq, Hkv, Sq, Skv, D, Dv) in MLA_SWEEP_SHAPES:
            for causal, window in SWEEP_MASKS:
                if causal and Sq != Skv:
                    continue
                q, k = make((B, Hq, Sq, D), dtype), make((B, Hkv, Skv, D), dtype)
                v = make((B, Hkv, Skv, Dv), dtype)
                out, ran, _ = launched_variant(
                    lambda: flash_attention(q, k, v, causal=causal, window=window),
                    fa, fa.variant(dtype, D, Dv))
                ref = attention_ref(q, k, v, causal=causal, window=window)
                err = rel_err(out, ref)
                cases.append({"shape": [B, Hq, Hkv, Sq, Skv, D, Dv],
                              "dtype": str(dtype).split(".")[1], "variant": ran,
                              "causal": causal, "window": window,
                              "rel_err": err, "tol": TOL[dtype]})
                if not (err < TOL[dtype] and out.shape == ref.shape
                        and bool(torch.isfinite(out).all())
                        and (ran == "fa_fwd_wgmma") == (dtype == torch.bfloat16)):
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

    def measure(shape, must_beat_earlier=False, causal=True, window=None):
        """bf16 at a full-width shape (causal unless told otherwise; a
        window if given; (B, Hq, Hkv, Sq, Skv, D) or, at MLA's head dims,
        (..., D, Dv)): error, and the kernel's time in turns with its
        earlier variant (mma.sync, by `variant=`, where q, k and v share a
        head dim) and the library call (SDPA; at MLA's head dims the fastest
        fused backend that takes v's head dim, and SDPA over v zero-padded
        to q's, its output cut back, as a second reading), each the better
        of two readings, beside the plain version's time and the bound."""
        B, Hq, Hkv, Sq, Skv, D = shape[:6]
        Dv = shape[6] if len(shape) > 6 else D
        q = make((B, Hq, Sq, D), torch.bfloat16)
        k = make((B, Hkv, Skv, D), torch.bfloat16)
        v = make((B, Hkv, Skv, Dv), torch.bfloat16)
        out, ran, n_kernels = launched_variant(
            lambda: flash_attention(q, k, v, causal=causal, window=window), fa,
            fa.variant(torch.bfloat16, D, Dv))
        ref = attention_ref(q, k, v, causal=causal, window=window)
        err = rel_err(out, ref)
        abs_err = float((out.float() - ref.float()).abs().max())
        if not err < TOL[torch.bfloat16] or ran != "fa_fwd_wgmma":
            raise AssertionError(f"shape {shape} disagrees: rel_err {err}, {ran}")
        kernel = lambda: flash_attention(q, k, v, causal=causal, window=window)  # noqa: E731
        turns = [("kernel", kernel)]
        earlier = "fa_fwd_bf16_mma" if D == Dv else None
        if earlier:
            mma = lambda: fa.flash_attention_fwd(  # noqa: E731
                q, k, v, causal=causal, window=window, variant=earlier)
            earlier_err = rel_err(mma(), ref)
            turns.append(("earlier", mma))
        lib = {}
        if D == Dv:
            library = library_attention(q, k, v, causal, window)
        else:
            # each fused backend alone on v as it is (MLA has no window)
            calls = {n: sdpa_forward(q, k, v, causal, n) for n in SDPA_BACKENDS}
            alone = {n: time_ms(c, 20) for n, c in calls.items() if c is not None}
            best = min(alone, key=alone.get) if alone else None
            library = calls[best] if best else None
            lib = {"library_backend": best,
                   "library_backends": {n: alone.get(n) for n in SDPA_BACKENDS}}
        if library is not None:
            lib_err = rel_err(library(), ref)
            turns.append(("library", library))
        if D != Dv:
            padded = library_attention(q, k, F.pad(v, (0, D - Dv)), causal, window)
            lib["library_padded_rel_err"] = rel_err(padded()[..., :Dv], ref)
            turns.append(("library_padded", padded))
        plain_ms = time_ms(lambda: attention_ref(q, k, v, causal=causal, window=window),
                           5, 1)
        ms, order = in_turns(turns, 50)
        kernel_ms = min(ms["kernel"])
        if must_beat_earlier and not kernel_ms < min(ms["earlier"]):
            raise AssertionError(f"{ran} is not faster than {earlier}: {order}")
        bound_ms, bound_by = attention_bound_ms(q, k, v, causal, window)
        result = {"shape": list(shape), "dtype": "bfloat16", "causal": causal,
                  "window": window,
                  "variant": ran, "cuda_kernels_per_call": n_kernels,
                  "max_rel_err": err, "max_abs_err": abs_err,
                  "tol": TOL[torch.bfloat16], "kernel_ms": kernel_ms,
                  "ms_in_turns": order,
                  "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                  **lib}
        if library is not None:
            result.update({"library_ms": min(ms["library"]), "library_rel_err": lib_err})
        if earlier:
            result.update({"earlier_variant": earlier, "earlier_ms": min(ms["earlier"]),
                           "earlier_rel_err": earlier_err,
                           "speedup_over_earlier": min(ms["earlier"]) / kernel_ms})
        else:
            # the library call on v as it is where a backend takes it, else
            # over v padded
            result.update({"library_padded_ms": min(ms["library_padded"]),
                           "library_v_padded_to": None if library is not None else D})
            result.setdefault("library_ms", result["library_padded_ms"])
        return result

    # the main path's shape (tinyllama-1.1b), stablelm-3b's (head dim 80),
    # llama3.2-3b's head dim 128, and head dim 32, which no config has at
    # full width, at stablelm-3b's heads
    main = measure((BATCH, 32, 4, PROMPT_LEN, PROMPT_LEN, 64))
    d80 = measure(STABLELM_ATTN_SHAPE, must_beat_earlier=True)
    d128 = {"llama3.2-3b": measure(K1_D128_SHAPE),
            "nemotron-4-15b": measure(NEMOTRON_ATTN_SHAPE)}
    d32 = measure(D32_SHAPE)
    # Qwen2-VL's (a group of 6) and Whisper's cross-attention (non-causal)
    later = {"qwen2-vl-2b": measure(QWEN2_VL_ATTN_SHAPE),
             "whisper-large-v3 cross": measure(WHISPER_CROSS_SHAPE, causal=False),
             "whisper-large-v3 encoder": measure(WHISPER_ENCODER_SHAPE, causal=False),
             "whisper-large-v3 decoder": measure(WHISPER_DECODER_SHAPE),
             # past mixtral-8x22b's window: 4608 rows, 4096 keys at most
             "mixtral-8x22b window": measure(MIXTRAL_WINDOW_SHAPE,
                                             window=MIXTRAL_WINDOW)}
    # deepseek-v2-lite-16b's MLA: q·k 192, v 128
    mla = measure(MLA_ATTN_SHAPE)
    emit("kernels", name="flash_attention_fwd", sweep=cases,
         max_rel_err_fp32=max(c["rel_err"] for c in cases if c["dtype"] == "float32"),
         max_rel_err_bf16=max(c["rel_err"] for c in cases if c["dtype"] == "bfloat16"),
         main_path_shape=main, head_dim_80=d80, head_dim_128=d128,
         head_dim_32_no_config_at_full_width=d32, later_families=later,
         mla_192_128=mla)
    return main, d80, later, d128, mla


def attention_bwd_bound_ms(q, k, v, causal, window):
    """Least time the card could take for the backward: the larger of bytes
    moved (q, k, v, o, dO and lse read once, dq, dk, dv written once) over
    the memory rate and operations (five products over the visible pairs,
    2.5 times the forward's two: S, dQ and dK at q's head dim, dP and dV at
    v's) over the peak rate for the type."""
    B, Hq, Sq, D = q.shape
    Dv = v.shape[-1]
    n_bytes = (2 * q.numel() + 2 * B * Hq * Sq * Dv
               + 2 * (k.numel() + v.numel())) * q.element_size() + B * Hq * Sq * 4
    flops = 2 * B * Hq * (3 * D + 2 * Dv) * visible_pairs(Sq, k.shape[2], causal, window)
    peak = PEAK_BF16_FLOPS if q.dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def attention_bwd_seven_products_ms(q, k, v, causal, window):
    """The operations of the two-kernel design over the peak rate: S and dP
    are computed in both the dQ and the dK/dV kernel, seven products over the
    visible pairs for the five of `attention_bwd_bound_ms`."""
    B, Hq, Sq, D = q.shape
    Dv = v.shape[-1]
    flops = 2 * B * Hq * (4 * D + 3 * Dv) * visible_pairs(Sq, k.shape[2], causal, window)
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
                B, Hq, S = dk.shape[:3]
                dk = dk.view(B, Hq // group, group, S, -1).sum(2)
                dv = dv.view(B, Hq // group, group, S, -1).sum(2)
            return dq, dk, dv
        return call, gqa
    return None, None


def device_split(fn, calls: int = 10, burn: int = 1000, tries: int = 5) -> dict:
    """Device time of each CUDA kernel that `calls` runs of `fn` launch, by
    torch.profiler: ms a call, the launches recorded, and share of the
    total.  The profiler loses kernel records at the start of a session
    once the process has run a while (on an H100 with torch 2.11: none in a
    fresh process, a few after some phases, now and then every one), so
    `burn` small throwaway kernels open the session, only the
    kernels that start after their synchronize are read, and the session
    is run again, up to `tries` times, while it read no kernel or a count
    of launches that is not a multiple of `calls`."""
    fn()
    torch.cuda.synchronize()
    x = torch.zeros(1, device="cuda")
    for _ in range(tries):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(burn):
                x.add_(1)
            torch.cuda.synchronize()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = prof.events()
        syncs = sorted(e.time_range.end for e in events
                       if e.name == "cudaDeviceSynchronize")
        opened = syncs[0] if syncs else float("-inf")
        us, launches = {}, {}
        for evt in events:
            if (evt.device_type != torch.autograd.DeviceType.CUDA
                    or evt.time_range.start < opened):
                continue
            name = evt.name.replace("void ", "").replace("(anonymous namespace)::", "")
            name = name.split("(")[0]
            us[name] = us.get(name, 0.0) + evt.time_range.elapsed_us()
            launches[name] = launches.get(name, 0) + 1
        if us and all(n % calls == 0 for n in launches.values()):
            break
    total = sum(us.values())
    return {name: {"ms": t / 1e3 / calls, "launches": launches[name],
                   "share": t / total if total else None}
            for name, t in us.items()}


def adamw_bound_ms(params, grads) -> float:
    """Least time the card could take for one optimizer step: the norm reads
    each gradient once; the update reads g, p, m and v and writes p, m and v
    once."""
    n_bytes = sum(g.numel() * (2 * g.element_size() + 2 * p.element_size() + 16)
                  for p, g in zip(params, grads))
    return n_bytes / PEAK_BYTES_PER_S * 1e3


def fused_adamw_ms(params, grads, ms, vs):
    """`torch._fused_adamw_` over the same leaves, bf16 params with fp32
    grads and moments: the yardstick, called nowhere in the port; (None, the
    reason) where it does not take them."""
    steps = [torch.ones((), device="cuda") for _ in params]

    def call():
        torch._fused_adamw_(params, grads, ms, vs, [], steps, amsgrad=False, lr=1e-5,
                            beta1=0.9, beta2=0.95, weight_decay=0.1, eps=1e-8,
                            maximize=False)
    try:
        call()
        torch.cuda.synchronize()
    except RuntimeError as e:
        return None, str(e).splitlines()[0][:200]
    return time_ms(call, 5), None


def phase_adamw() -> dict:
    """K4 at the training cell's optimizer (ADAMW_ARCH at ADAMW_LAYERS): one
    optimizer step (`optim.adamw_update`: the schedule's scalars, then K4's
    norm and update) launches each CUDA kernel once and counts one
    `kernel.adamw` call; every leaf's params and moments after it are
    bit-equal to the plain version's from the same state and scalars (the
    state before the step kept on the host, the plain version run a leaf at
    a time); the norm within 1e-6 of a float64 sum.  Then the whole step and
    the plain version's norm and update timed in turns, K4's kernels by the
    profiler's split, beside the bound of moving each byte once and
    `torch._fused_adamw_`'s time where it takes bf16 params with fp32
    moments."""
    from repro_torch import spans
    from repro_torch.configs import get_config
    from repro_torch.kernels.adamw import kernel as k4
    from repro_torch.kernels.adamw import ops as k4_ops
    from repro_torch.kernels.adamw.ref import adamw_update_ref, sum_of_squares_ref
    from repro_torch.models.common import get_model, tree_leaves
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, cosine_lr

    cfg = get_config(ADAMW_ARCH).replace(num_layers=ADAMW_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = get_model(cfg).init(cfg, gen, "cuda")
    leaves = tree_leaves(params)
    grads = [torch.randn(p.shape, generator=gen, device="cuda").mul_(1e-4) for p in leaves]
    opt_cfg = AdamWConfig(**TRAIN_OPT)
    opt = adamw_init(params)
    params, opt = adamw_update(opt_cfg, params, grads, opt)   # moments not zero
    ms, vs = tree_leaves(opt["m"]), tree_leaves(opt["v"])
    torch.cuda.synchronize()
    host = [[x.to("cpu") for x in xs] for xs in (leaves, ms, vs)]
    step = opt["step"] + 1
    before, calls = k4.launch_counts(), spans.counters()["kernel.adamw"]
    params, opt = adamw_update(opt_cfg, params, grads, opt)
    torch.cuda.synchronize()
    launches = {k: n - before[k] for k, n in k4.launch_counts().items()}
    counted = spans.counters()["kernel.adamw"] - calls
    # the step's scalars, by its expressions (K4's norm is the same run to run)
    t = step.float()
    total, gnorm = k4_ops.sum_of_squares(grads)
    sc = dict(scale=torch.clamp_max(opt_cfg.clip_norm / torch.clamp_min(gnorm, 1e-9), 1.0),
              lr=cosine_lr(opt_cfg, t), b1t=1.0 - opt_cfg.b1 ** t, b2t=1.0 - opt_cfg.b2 ** t,
              b1=opt_cfg.b1, b2=opt_cfg.b2, eps=opt_cfg.eps,
              weight_decay=opt_cfg.weight_decay)
    unequal = []
    for i, (p, g, m, v) in enumerate(zip(leaves, grads, ms, vs)):
        mine = [x.to("cuda") for x in (host[0][i], host[1][i], host[2][i])]
        adamw_update_ref(*[[x] for x in (mine[0], g, mine[1], mine[2])], **sc)
        if not all(same_bits(a, b) for a, b in zip(mine, (p, m, v))):
            unequal.append(i)
        del mine
    del host
    exact = sum(float(torch.sum(g.double() ** 2)) for g in grads)
    norm_rel_err = abs(float(total) - exact) / exact

    def k4_step():
        adamw_update(opt_cfg, params, grads, opt)

    def plain_step():
        sum_of_squares_ref(grads)
        adamw_update_ref(leaves, grads, ms, vs, **sc)

    timed, order = in_turns([("k4", k4_step), ("plain", plain_step)], iters=5)
    split = device_split(k4_step, calls=3)
    kernels_ms = {name: x["ms"] for name, x in split.items() if "adamw" in name}
    library_ms, library_refused = fused_adamw_ms(leaves, grads, ms, vs)
    result = {
        "arch": ADAMW_ARCH, "layers": ADAMW_LAYERS, "leaves": len(leaves),
        "params": sum(p.numel() for p in leaves),
        "param_dtypes": sorted({str(p.dtype) for p in leaves}),
        "launches": launches, "kernel_adamw_calls": counted,
        "bit_equal_leaves": len(leaves) - len(unequal), "unequal_leaves": unequal,
        "norm_rel_err": norm_rel_err,
        "ms": sum(kernels_ms.values()), "kernels_ms": kernels_ms,
        "step_ms": min(timed["k4"]), "device_ops_a_step": sum(
            x["launches"] for x in split.values()) // 3,
        "bound_ms": adamw_bound_ms(leaves, grads), "bound_by": "bytes",
        "plain_ms": min(timed["plain"]), "in_turns": order,
        "library_ms": library_ms, "library_refused": library_refused}
    emit("kernels_adamw", **result)
    del params, opt, leaves, grads, ms, vs
    if unequal or launches != {"adamw_sumsq": 1, "adamw_update": 1} or counted != 1 \
            or norm_rel_err > 1e-6:
        raise AssertionError(f"K4 at {ADAMW_ARCH}: {result}")
    return result


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
        """q, k, v, the plain forward's output and lse, and dO; `shape` is
        (B, Hq, Hkv, Sq, Skv, D) or, at MLA's head dims, (..., D, Dv)."""
        B, Hq, Hkv, Sq, Skv, D = shape[:6]
        Dv = shape[6] if len(shape) > 6 else D
        q, k, v = make((B, Hq, Sq, D), dtype), make((B, Hkv, Skv, D), dtype), \
            make((B, Hkv, Skv, Dv), dtype)
        out, lse = attention_ref(q, k, v, causal=causal, window=window,
                                 return_lse=True)
        return q, k, v, out, lse, make((B, Hq, Sq, Dv), dtype)

    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for shape in BWD_SHAPES + MLA_SWEEP_SHAPES:
            dims = shape[5:]   # D, or MLA's (D, Dv)
            for causal, window in BWD_MASKS:
                q, k, v, out, lse, do = inputs(shape, dtype, causal, window)
                (_, lse_k), _, _ = launched_variant(
                    lambda: fa.flash_attention_fwd(q, k, v, causal=causal,
                                                   window=window, return_lse=True),
                    fa, fa.variant(dtype, *dims))
                bwd = lambda: fa.flash_attention_bwd(  # noqa: E731
                    q, k, v, out, lse, do, causal=causal, window=window)
                grads, ran, _ = launched_variant(
                    bwd, fa, fa.variant_bwd(dtype, *dims), fa.VARIANT_KERNELS_BWD)
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
                if not (max(errs) < BWD_TOL[dtype] and case["lse_rel_err"] < TOL[dtype]
                        and all(bool(torch.isfinite(g).all()) for g in grads)
                        and float(grads[0][blind].abs().sum()) == 0.0
                        and case["equal_run_to_run"]
                        and (ran == "fa_bwd_wgmma") == (dtype == torch.bfloat16)):
                    raise AssertionError(f"flash_attention_bwd disagrees: {case}")

    def measure(shape, must_beat_earlier=False, causal=True) -> dict:
        """bf16 at a full-width training shape (causal unless told
        otherwise; MLA's (..., D, Dv) too): error, the kernel (variant_bwd's)
        timed in turns with the mma.sync variant (where q, k and v share a
        head dim) and with the fastest SDPA backend, each backend alone (at
        MLA's head dims on v and dO as they are, and again over v and dO
        zero-padded to q's, dV cut back, the fastest of those a second
        reading), the split between the CUDA kernels, and the bounds."""
        dims = shape[5:]
        D, Dv = dims[0], dims[-1]
        q, k, v, out, lse, do = inputs(shape, torch.bfloat16, causal, None)
        grads, ran, n_kernels = launched_variant(
            lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal), fa,
            fa.variant_bwd(torch.bfloat16, *dims), fa.VARIANT_KERNELS_BWD)
        ref = attention_bwd_ref(q, k, v, out, lse, do, causal=causal)
        errs = [rel_err(g, r) for g, r in zip(grads, ref)]
        abs_err = max(float((g.float() - r.float()).abs().max())
                      for g, r in zip(grads, ref))
        again = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
        equal = all(torch.equal(a, b) for a, b in zip(grads, again))
        _, lse_k = fa.flash_attention_fwd(q, k, v, causal=causal, return_lse=True)
        main_lse_err = lse_err(lse_k, lse)
        if not (max(errs) < BWD_TOL[torch.bfloat16]
                and main_lse_err < TOL[torch.bfloat16] and equal
                and ran == "fa_bwd_wgmma" and n_kernels == 2):
            raise AssertionError(f"training shape {shape} disagrees: {errs}, "
                                 f"lse {main_lse_err}, equal {equal}, {ran} "
                                 f"with {n_kernels} CUDA kernels")
        # the mma.sync design, at every bf16 head dim that q, k and v share
        earlier = "fa_bwd_bf16_mma" if D == Dv else None
        kernel = lambda: fa.flash_attention_bwd(  # noqa: E731
            q, k, v, out, lse, do, causal=causal)
        turns = [("kernel", kernel)]
        if earlier:
            mma = lambda: fa.flash_attention_bwd(  # noqa: E731
                q, k, v, out, lse, do, causal=causal, variant=earlier)
            mma_err = max(rel_err(g, r) for g, r in zip(mma(), ref))
            turns.append(("earlier", mma))
        # every SDPA backend that takes the inputs, alone, then the fastest
        # in turns with the kernels: new, earlier, library, library,
        # earlier, new
        def library_backends(vv, dd):
            """Each SDPA backend alone on q, k, `vv` and `dd` (dV cut back to
            v's head dim): its ms, error and call, and the fastest."""
            backends, errs, calls = {}, {}, {}
            for name in SDPA_BACKENDS:
                call, gqa = sdpa_backward(q, k, vv, dd, causal, name)
                if call is None:
                    backends[name] = None
                    continue
                calls[name] = call
                dq_l, dk_l, dv_l = call()
                errs[name] = max(rel_err(g, r) for g, r in
                                 zip((dq_l, dk_l, dv_l[..., :Dv]), ref))
                backends[name] = {"ms": time_ms(call, 20), "enable_gqa": gqa}
            timed = [n for n in SDPA_BACKENDS if backends[n] is not None]
            best = min(timed, key=lambda n: backends[n]["ms"]) if timed else None
            return backends, errs, calls, best

        backends, library_errs, calls, best = library_backends(v, do)
        if best is not None:
            turns.append(("library", calls[best]))
        if D != Dv:
            pad_backends, pad_errs, pad_calls, pad_best = library_backends(
                F.pad(v, (0, D - Dv)), F.pad(do, (0, D - Dv)))
            if pad_best is not None:
                turns.append(("library_padded", pad_calls[pad_best]))
        ms, order = in_turns(turns, 20)
        plain_ms = time_ms(lambda: attention_bwd_ref(q, k, v, out, lse, do,
                                                     causal=causal), 3, 1)
        bound_ms, bound_by = attention_bwd_bound_ms(q, k, v, causal, None)
        seven_ms = attention_bwd_seven_products_ms(q, k, v, causal, None)
        split = device_split(kernel)
        kernel_ms = min(ms["kernel"])
        if must_beat_earlier and not kernel_ms < min(ms["earlier"]):
            raise AssertionError(f"{ran} is not faster than {earlier}: {order}")
        result = {"shape": list(shape), "dtype": "bfloat16", "causal": causal,
                  "variant": ran, "cuda_kernels_per_call": n_kernels,
                  "dq_rel_err": errs[0], "dk_rel_err": errs[1], "dv_rel_err": errs[2],
                  "max_abs_err": abs_err, "lse_rel_err": main_lse_err,
                  "equal_run_to_run": equal,
                  "tol": BWD_TOL[torch.bfloat16], "kernel_ms": kernel_ms,
                  "cuda_kernels": split}
        if earlier:
            result.update({"earlier_variant": earlier, "earlier_ms": min(ms["earlier"]),
                           "earlier_rel_err": mma_err,
                           "speedup_over_earlier": min(ms["earlier"]) / kernel_ms})
        else:
            # the library call on v and dO as they are where a backend takes
            # them, else over v and dO padded
            padded_ms = min(ms["library_padded"]) if pad_best else None
            result.update({"library_padded_ms": padded_ms,
                           "library_padded_backend": pad_best,
                           "library_padded_backends": pad_backends,
                           "library_padded_rel_err": pad_errs,
                           "library_v_padded_to": None if best else D})
        library_ms = min(ms["library"]) if best else result.get("library_padded_ms")
        return {**result,
                "ms_in_turns": order,
                "plain_ms": plain_ms,
                "library_ms": library_ms,
                "library_backend": best, "library_backends": backends,
                "library_rel_err": library_errs,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "bound_ms_seven_products": seven_ms,
                "goal_ms": 0.50 if shape == TRAIN_ATTN_SHAPE else None}

    main = measure(TRAIN_ATTN_SHAPE, must_beat_earlier=True)
    mla = measure(MLA_ATTN_SHAPE)   # deepseek-v2-lite-16b's MLA
    d80 = measure(STABLELM_ATTN_SHAPE, must_beat_earlier=True)
    d128 = {"llama3.2-3b": measure(BWD_D128_SHAPE),
            "mixtral-8x22b": measure(NEMOTRON_ATTN_SHAPE)}
    d32 = measure(D32_SHAPE)
    # the later families' training shapes: Qwen2-VL's group of 6, Whisper's
    # cross-attention and encoder (non-causal) and decoder
    main["later_families"] = {
        "qwen2-vl-2b": measure(QWEN2_VL_ATTN_SHAPE),
        "whisper-large-v3 cross": measure(WHISPER_CROSS_SHAPE, causal=False),
        "whisper-large-v3 encoder": measure(WHISPER_ENCODER_SHAPE, causal=False),
        "whisper-large-v3 decoder": measure(WHISPER_DECODER_SHAPE)}
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
         main_path_shape=main, head_dim_80=d80, head_dim_128=d128,
         head_dim_32_no_config_at_full_width=d32, mla_192_128=mla)
    return main, d80, d128, mla


def ssd_inputs(gen, B, S, H, P, G, N, dtype, with_init=False):
    """x, dt, A, B, C of the SSD scan on the card, with the distributions of
    the JAX package's kernel tests, and a random initial state or None."""
    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    x = randn(B, S, H, P, scale=0.5).to(dtype)
    dt = F.softplus(randn(B, S, H))
    A = -torch.exp(randn(H, scale=0.3))
    B_ = randn(B, S, G, N, scale=0.3).to(dtype)
    C = randn(B, S, G, N, scale=0.3).to(dtype)
    h0 = randn(B, H, P, N) if with_init else None
    return (x, dt, A, B_, C), h0


def phase_ssd_kernels() -> dict:
    from repro_torch.kernels.ssd_scan import kernel as kssd
    from repro_torch.kernels.ssd_scan.ops import ssd
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref
    from repro_torch.testing import rel_err

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def make(*shape, with_init=False):
        return ssd_inputs(gen, *shape, with_init)

    def call(args, chunk, h0=None, name=None):
        """One call of the scan forward: through the op (the rule's variant)
        where `name` is None, else the named variant through the wrapper."""
        if name is None:
            return lambda: ssd(*args, chunk=chunk, init_state=h0, return_state=True)
        return lambda: kssd.ssd_scan_fwd(*args, chunk=chunk, init_state=h0,
                                         variant=name)

    # every case through variant()'s variant; where that is the wgmma one
    # (bf16 at P 64, N 64 or 128, chunk >= 64), through the fp32-pipe one as
    # well (named); y and the final state against the plain version, and two
    # calls bitwise equal
    earlier = "ssd_fwd_kernel"
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for idx, (B, S, H, P, G, N, chunk) in enumerate(SSD_SHAPES):
            rule = kssd.variant(dtype, P, N, chunk)
            if (rule == "ssd_wgmma") != ssd_wgmma_domain(dtype, P, N, chunk):
                raise AssertionError(f"variant() names {rule} for {dtype} at "
                                     f"(P={P}, N={N}, chunk={chunk})")
            for with_init in sorted({False, idx in SSD_INIT_STATE}):
                args, h0 = make(B, S, H, P, G, N, dtype, with_init=with_init)
                ry, rh = ssd_chunked_ref(*args, chunk=chunk, init_state=h0)
                for name in [None] + ([earlier] if rule != earlier else []):
                    fn = call(args, chunk, h0, name)
                    (y, hT), ran, _ = launched_variant(fn, kssd, name or rule)
                    y2, hT2 = fn()
                    err_y, err_h = rel_err(y, ry), rel_err(hT, rh)
                    cases.append({"shape": [B, S, H, P, G, N], "chunk": chunk,
                                  "dtype": str(dtype).split(".")[1],
                                  "variant": ran, "named": name is not None,
                                  "init_state": with_init, "y_rel_err": err_y,
                                  "state_rel_err": err_h, "tol": TOL[dtype],
                                  "equal_run_to_run": bool(torch.equal(y, y2)
                                                           and torch.equal(hT, hT2))})
                    if not (err_y < TOL[dtype] and err_h < TOL[dtype]
                            and torch.isfinite(y).all() and torch.isfinite(hT).all()
                            and cases[-1]["equal_run_to_run"]):
                        raise AssertionError(f"ssd disagrees: {cases[-1]}")

    def measure(shape, chunk):
        """bf16 at a full-width shape: error against the plain version, the
        rule's variant (which must be ssd_wgmma) timed in turns with the
        fp32-pipe variant and the plain version, each the better of two
        readings, and faster than the fp32-pipe one; each variant's split
        by CUDA kernel; the bound."""
        B, S, H, P, G, N = shape
        args, _ = make(B, S, H, P, G, N, torch.bfloat16)
        kernel, pipes = call(args, chunk), call(args, chunk, name=earlier)
        plain = lambda: ssd_chunked_ref(*args, chunk=chunk)  # noqa: E731
        (y, hT), ran, n_kernels = launched_variant(
            kernel, kssd, kssd.variant(torch.bfloat16, P, N, chunk))
        (ye, he), _, _ = launched_variant(pipes, kssd, earlier)
        ry, rh = plain()
        err, err_h = rel_err(y, ry), rel_err(hT, rh)
        if not (err < TOL[torch.bfloat16] and err_h < TOL[torch.bfloat16]
                and ran == "ssd_wgmma"):
            raise AssertionError(f"shape {shape} disagrees: y {err}, state {err_h}, {ran}")
        ms, order = in_turns([("kernel", kernel), ("earlier", pipes), ("plain", plain)], 10)
        kernel_ms, earlier_ms = min(ms["kernel"]), min(ms["earlier"])
        if not kernel_ms < earlier_ms:
            raise AssertionError(f"{ran} is not faster than {earlier}: {order}")
        bound_ms, bound_by = ssd_bound_ms(*args, chunk)
        return {"shape": [B, S, H, P, G, N], "chunk": chunk, "dtype": "bfloat16",
                "variant": ran, "cuda_kernels_per_call": n_kernels,
                "max_rel_err": err, "state_rel_err": err_h,
                "max_abs_err": float((y.float() - ry.float()).abs().max()),
                "tol": TOL[torch.bfloat16], "kernel_ms": kernel_ms,
                "plain_ms": min(ms["plain"]), "ms_in_turns": order, "library_ms": None,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "cuda_kernels": device_split(kernel),
                "earlier_variant": earlier, "earlier_ms": earlier_ms,
                "earlier_max_rel_err": max(rel_err(ye, ry), rel_err(he, rh)),
                "earlier_cuda_kernels": device_split(pipes, 3),
                "speedup_over_earlier": earlier_ms / kernel_ms}

    # the main path's shape: one mamba2-1.3b layer's scan at batch 8 x 1024
    # (N 128); Zamba2's layer at the same batch (N 64)
    main = measure((BATCH, PROMPT_LEN, 64, 64, 1, 128), 256)
    main["later_families"] = {"zamba2-1.2b": measure(ZAMBA2_SSD_SHAPE, 256)}
    emit("kernels", name="ssd_scan_fwd", sweep=cases,
         max_rel_err_fp32=max(c["y_rel_err"] for c in cases if c["dtype"] == "float32"),
         max_rel_err_bf16=max(c["y_rel_err"] for c in cases if c["dtype"] == "bfloat16"),
         max_state_rel_err_fp32=max(c["state_rel_err"] for c in cases
                                    if c["dtype"] == "float32"),
         max_state_rel_err_bf16=max(c["state_rel_err"] for c in cases
                                    if c["dtype"] == "bfloat16"),
         main_path_shape=main)
    return main


SSD_GRADS = ("dx", "ddt", "dA", "dB", "dC", "d_init_state")


def phase_ssd_bwd_kernels() -> dict:
    """K2b: the backward kernel against its plain version over the forward's
    sweep in both types (every gradient; an initial state and a final-state
    gradient where SSD_INIT_STATE says), two calls bitwise equal, the CUDA
    kernels of variant_bwd's variant, and where that is the wgmma variant
    the fp32-pipe one too (named); then at mamba2-1.3b's training shape the
    two variants and the plain version timed in turns beside the bound, with
    each variant's split by CUDA kernel."""
    from repro_torch.kernels.ssd_scan import kernel as kssd
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_bwd_ref
    from repro_torch.testing import rel_err

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)

    def inputs(B, S, H, P, G, N, dtype, with_init):
        args, h0 = ssd_inputs(gen, B, S, H, P, G, N, dtype, with_init)
        dy = torch.randn((B, S, H, P), generator=gen, device="cuda").to(dtype)
        d_final = (torch.randn((B, H, P, N), generator=gen, device="cuda")
                   if with_init else None)
        return args, h0, dy, d_final

    def check(shape, chunk, dtype, with_init, variant=None):
        """One case: errors against the plain version, the variant whose
        CUDA kernels ran (`variant`, or variant_bwd's), and two calls'
        equality.  Returns the case, the inputs x, dt, A, B, C, the kernel's
        and the plain version's calls, both results and the CUDA kernels one
        call launched."""
        B, S, H, P, G, N = shape
        args, h0, dy, d_final = inputs(B, S, H, P, G, N, dtype, with_init)
        bwd = lambda: kssd.ssd_scan_bwd(  # noqa: E731
            *args, dy, chunk=chunk, init_state=h0, d_final_state=d_final,
            variant=variant)
        plain = lambda: ssd_chunked_bwd_ref(  # noqa: E731
            *args, h0, dy, d_final, chunk=chunk)
        grads, ran, n_kernels = launched_variant(
            bwd, kssd, variant or kssd.variant_bwd(dtype, P, N, chunk),
            kssd.VARIANT_KERNELS_BWD)
        again = bwd()
        ref = plain()
        errs = {name: rel_err(g, r) for name, g, r in zip(SSD_GRADS, grads, ref)}
        if h0 is None:       # the gradient of a zero state nobody passed
            errs.pop("d_init_state")
        case = {"shape": list(shape), "chunk": chunk,
                "dtype": str(dtype).split(".")[1], "variant": ran,
                "init_state_and_final_grad": with_init,
                **{f"{k}_rel_err": v for k, v in errs.items()},
                "tol": BWD_TOL[dtype],
                "equal_run_to_run": all(torch.equal(a, b) for a, b in zip(grads, again))}
        if not (max(errs.values()) < BWD_TOL[dtype] and case["equal_run_to_run"]
                and all(bool(torch.isfinite(g).all()) for g in grads)):
            raise AssertionError(f"ssd_scan_bwd disagrees: {case}")
        return case, args, bwd, plain, grads, ref, n_kernels

    # every case through variant_bwd's variant; where that is the wgmma one
    # (bf16 at P 64, N 64 or 128, chunk >= 64), through the fp32-pipe one as
    # well
    earlier = "ssd_bwd_simt"
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for idx, (B, S, H, P, G, N, chunk) in enumerate(SSD_SHAPES):
            rule = kssd.variant_bwd(dtype, P, N, chunk)
            if (rule == "ssd_bwd_wgmma") != ssd_wgmma_domain(dtype, P, N, chunk):
                raise AssertionError(f"variant_bwd() names {rule} for {dtype} at "
                                     f"(P={P}, N={N}, chunk={chunk})")
            names = [None]
            if rule != earlier:
                names.append(earlier)
            for with_init in sorted({False, idx in SSD_INIT_STATE}):
                for name in names:
                    cases.append(check((B, S, H, P, G, N), chunk, dtype, with_init,
                                       name)[0])

    def measure(shape, chunk):
        """A training shape, bf16, no initial state and no final-state
        gradient: the rule's variant (which must be ssd_bwd_wgmma), the
        fp32-pipe one and the plain version in turns, the wgmma one the
        faster; each variant's split by CUDA kernel; the bound."""
        case, args, bwd, plain, grads, ref, n_kernels = check(
            shape, chunk, torch.bfloat16, False)
        earlier_case, _, simt, _, _, _, _ = check(shape, chunk, torch.bfloat16, False,
                                                  earlier)
        abs_err = max(float((g.float() - r.float()).abs().max())
                      for g, r in zip(grads[:5], ref[:5]))
        ms, order = in_turns([("kernel", bwd), ("earlier", simt), ("plain", plain)], 5)
        kernel_ms, earlier_ms = min(ms["kernel"]), min(ms["earlier"])
        if not (case["variant"] == "ssd_bwd_wgmma" and kernel_ms < earlier_ms):
            raise AssertionError(f"{case['variant']} is not faster than {earlier}: {order}")
        bound_ms, bound_by = ssd_bwd_bound_ms(*args, chunk)
        return {**case, "cuda_kernels_per_call": n_kernels, "max_abs_err": abs_err,
                "kernel_ms": kernel_ms, "plain_ms": min(ms["plain"]),
                "ms_in_turns": order, "library_ms": None,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "cuda_kernels": device_split(bwd, 3),
                "earlier_variant": earlier, "earlier_ms": earlier_ms,
                "earlier_max_rel_err": max(v for k, v in earlier_case.items()
                                           if k.endswith("_rel_err")),
                "earlier_cuda_kernels": device_split(simt, 3),
                "speedup_over_earlier": earlier_ms / kernel_ms}

    # the training shapes: one mamba2-1.3b layer's scan at batch 8 x 1024,
    # chunk 256 (N 128), and Zamba2's (N 64)
    main = measure((BATCH, PROMPT_LEN, 64, 64, 1, 128), 256)
    main["later_families"] = {"zamba2-1.2b": measure(ZAMBA2_SSD_SHAPE, 256)}
    emit("kernels", name="ssd_scan_bwd", sweep=cases,
         max_rel_err_fp32=max(max(v for k, v in c.items() if k.endswith("_rel_err"))
                              for c in cases if c["dtype"] == "float32"),
         max_rel_err_bf16=max(max(v for k, v in c.items() if k.endswith("_rel_err"))
                              for c in cases if c["dtype"] == "bfloat16"),
         main_path_shape=main)
    return main


def serve_inputs(cfg, gen: torch.Generator) -> tuple:
    """Prompts [BATCH, S] for `cfg` on the card, and what else its prefill
    takes: Whisper's 1500 frames of embeddings (random, from the seed; its
    frontend is a stub) and a decoder prompt of 1500 // 4."""
    if cfg.family != "encdec":
        return torch.randint(0, cfg.vocab_size, (BATCH, PROMPT_LEN), generator=gen,
                             device="cuda"), {}
    frames = torch.randn((BATCH, WHISPER_FRAMES, cfg.d_model), generator=gen,
                         device="cuda").to(cfg.compute_dtype)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, WHISPER_FRAMES // 4),
                            generator=gen, device="cuda")
    return prompts, {"enc_embeds": frames}


def phase_serve(arch: str) -> dict:
    from repro_torch.launch.serve import generate, pad_cache_to
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.common import get_model, param_count
    from repro_torch.testing import rel_err

    cfg = served_config(arch)
    model = get_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = model.init(cfg, gen, "cuda")
    prompts, extra = serve_inputs(cfg, gen)
    S = prompts.shape[1]
    generate(cfg, params, prompts, 4, extra=extra)   # warm-up: library handles, caches

    # the main path, with every kernel's count set to 0 just before it: each
    # kernel-backed op once per call in the prefill (`op_calls`), the other
    # ops never; the CUDA kernels of the variant that the rule names, once
    # each a call
    torch.cuda.reset_peak_memory_stats()
    reset_op_counts()
    before = cuda_kernel_counts()
    tokens, t_prefill, t_decode = generate(cfg, params, prompts, GEN, extra=extra)
    counts = op_counts()
    cuda_kernels = cuda_kernels_since(before)
    peak = torch.cuda.max_memory_allocated()
    want_counts, want_kernels = expected_launches(cfg)
    if counts != want_counts or cuda_kernels != want_kernels:
        raise AssertionError(f"kernel launches {counts} ({cuda_kernels}) in one "
                             f"prefill of {arch}, expected {want_counts} "
                             f"({want_kernels})")
    if tokens.shape != (BATCH, GEN) or int(tokens.min()) < 0 \
            or int(tokens.max()) >= cfg.vocab_size:
        raise AssertionError("generated tokens out of range")

    # decode of token S after prefill(S) against the last position of
    # prefill(S + 1) (the MoE archs with no capacity drops, the step taking
    # the experts that the prefill's last tokens chose: a near-tie that
    # rounds the other way in the step's bf16 would make the two sides two
    # routings; the flips are counted, and the prefill's dropped choices,
    # which must be none); in the prefill, each kernel-backed
    # op as often as on the main path, and the dense attention core never
    # (MLA's attention on K1 as every family's)
    check = no_drops(cfg) if cfg.family == "moe" else cfg
    prefill, decode = make_prefill_step(check), make_decode_step(check)
    reset_op_counts()
    with counting_dense_attention() as dense_calls, recording_routes() as full_routes:
        full, _ = prefill(params, {"tokens": prompts, **extra})
    prefill_paths = {"kernel": op_counts()["flash_attention_fwd"], **dense_calls}
    if prefill_paths != {"kernel": want_counts["flash_attention_fwd"], "dense": 0}:
        raise AssertionError(f"{arch}: one prefill took the attention paths "
                             f"{prefill_paths}")
    part, cache = prefill(params, {"tokens": prompts[:, :-1], **extra})
    cache = pad_cache_to(cache, S + 4, cfg.window)
    with replaying_routes(last_tokens(full_routes, BATCH)) as replay:
        step, cache = decode(params, cache, {"tokens": prompts[:, -1:]})
    if not (torch.isfinite(full).all() and torch.isfinite(step).all()):
        raise AssertionError("logits are not finite")
    if full.shape != (BATCH, 1, cfg.vocab_size) or full.dtype != torch.float32:
        raise AssertionError(f"logits {tuple(full.shape)} {full.dtype}")
    decode_err = rel_err(step, full)
    moe_check = {}
    if cfg.family == "moe":
        moe_check = {"decode_routing_flips_replayed": replay["routing_flips"],
                     "decode_routed_tokens": replay["routed_tokens"],
                     "prefill_dropped_choices": dropped_choices(check, full_routes)}
    if cache["len"] != S or not decode_err < DECODE_TOL \
            or moe_check.get("prefill_dropped_choices"):
        raise AssertionError(f"decode after prefill disagrees: {decode_err} {moe_check}")

    steps = GEN - 1
    launched = {k: n for k, n in counts.items() if n}
    result = {"arch": arch, "family": cfg.family, "params": param_count(params),
              "layers": cfg.num_layers, "dtype": "bfloat16", "batch": BATCH,
              "prompt_len": S,
              "gen": GEN, "prefill_ms": t_prefill * 1e3,
              "decode_ms_per_token": t_decode * 1e3 / steps,
              "decode_tokens_per_s": BATCH * steps / t_decode,
              "peak_memory_bytes": peak, "kernels": sorted(launched),
              "kernel_launches": launched, "launches_by_kernel": counts,
              "cuda_kernel_launches": cuda_kernels,
              "prefill_attention_calls": prefill_paths,
              "decode_vs_prefill_rel_err": decode_err, "decode_tol": DECODE_TOL,
              **moe_check}
    if check is not cfg:
        result["decode_check_capacity_factor"] = check.capacity_factor
    if extra:
        result["encoder_frames"] = WHISPER_FRAMES
    emit("serve", **result)
    return result


def phase_parity_on_card(arch: str) -> None:
    """`arch` at full width, 2 layers (Whisper: 2 encoder and 2 decoder
    layers; DeepSeek: its dense layer and one MoE layer), fp32: the kernel
    path against the dense path, prefill logits, hidden states and every
    cache tensor; Qwen2-VL also one loss with vision embeddings prepended,
    Whisper the encoder's output, the MoE archs the aux loss, and the
    experts each path chose, which must be equal (`routing_agrees`: but for
    bf16 ties on DeepSeek, where the dense path's values are then those on
    the kernel path's experts)."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import get_model
    from repro_torch.testing import rel_err

    cfg = get_config(arch).replace(num_layers=2, param_dtype=torch.float32,
                                   compute_dtype=torch.float32)
    if cfg.family == "encdec":
        cfg = cfg.replace(enc_layers=2, dec_layers=2)
    model = get_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    params = model.init(cfg, gen, "cuda")
    tokens, extra = serve_inputs(cfg, gen)
    dense = cfg.replace(attn_impl="dense")
    batch = {"tokens": tokens, **extra}
    (logits_k, cache_k), (logits_d, cache_d), ties, replayed = on_both_paths(
        arch, lambda: model.prefill(cfg, params, batch),
        lambda: model.prefill(dense, params, batch))
    dense_cache = dict(cache_tensors(cache_d))
    errs = {"logits_rel_err": rel_err(logits_k, logits_d),
            "cache_rel_err": max(rel_err(val, dense_cache[key])
                                 for key, val in cache_tensors(cache_k))}
    with torch.no_grad():
        if cfg.family == "encdec":
            from repro_torch.models.whisper import encode
            mem_k = encode(cfg, params, extra["enc_embeds"])
            mem_d = encode(dense, params, extra["enc_embeds"])
            errs["encoder_rel_err"] = rel_err(mem_k, mem_d)
            errs["hidden_rel_err"] = rel_err(model.decode_fwd(cfg, params, tokens, mem_k),
                                             model.decode_fwd(dense, params, tokens, mem_d))
        elif cfg.family == "moe":
            (hidden_k, aux_k), (hidden_d, aux_d), ties_f, replayed_f = on_both_paths(
                arch, lambda: model.forward(cfg, params, tokens),
                lambda: model.forward(dense, params, tokens))
            errs["hidden_rel_err"] = rel_err(hidden_k, hidden_d)
            errs["aux_rel_err"] = abs(float(aux_k) - float(aux_d)) / abs(float(aux_d))
        else:
            errs["hidden_rel_err"] = rel_err(model.forward(cfg, params, tokens),
                                             model.forward(dense, params, tokens))
        if cfg.family == "vlm":
            # 256 vision embeddings before 768 tokens: 1024 positions, the
            # kernel path once a layer
            text = PROMPT_LEN - VISION_TOKENS
            vision = {"tokens": tokens[:, :text], "labels": tokens[:, 1:text + 1],
                      "vision_embeds": 0.02 * torch.randn(
                          (BATCH, VISION_TOKENS, cfg.d_model), generator=gen,
                          device="cuda")}
            reset_op_counts()
            loss_k, _ = model.loss(cfg, params, vision)
            vision_launches = op_counts()["flash_attention_fwd"]
            loss_d, _ = model.loss(dense, params, vision)
            errs["vision_loss_rel_err"] = abs(float(loss_k) - float(loss_d)) / abs(float(loss_d))
            if vision_launches != cfg.num_layers:
                raise AssertionError(f"the vision loss launched K1 {vision_launches} times")
    head_dim = (cfg.ssm_headdim if cfg.family == "ssm" else
                list(attention_head_dims(cfg)) if cfg.kv_lora_rank else
                cfg.resolved_head_dim)
    moe = ({**ties, "replayed_kernel_experts": replayed,
            "forward": {**ties_f, "replayed_kernel_experts": replayed_f}}
           if ties else {})
    emit("parity_on_card", arch=arch, head_dim=head_dim, layers=2,
         dtype="float32", **errs, **moe, tol=PARITY_TOL)
    if moe and not (routing_agrees(arch, ties) and routing_agrees(arch, ties_f)):
        raise AssertionError(f"{arch}: the paths chose other experts: {moe}")
    if not max(errs.values()) < PARITY_TOL:
        raise AssertionError(f"{arch}: kernel path and dense path disagree "
                             f"on the card: {errs}")


def phase_mixtral_window() -> dict:
    """mixtral-8x22b at full width and its served depth past its window:
    one prompt of 4096 + 512 (the window masks every row past 4096, and
    each layer's prefill cache is a ring of the last 4096 positions, slot =
    position % 4096), then MIXTRAL_WINDOW_DECODE decode steps on the ring,
    each against the last position of a prefill one token longer, at
    DECODE_TOL, each step taking the experts that the prefill's last token
    chose (`replaying_routes`); at capacity factor 8.0 (`no_drops`),
    where no token drops.  The prefill launches K1 once a layer, at the windowed shape timed in the kernels
    phase."""
    from repro_torch.launch.serve import pad_cache_to
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.common import get_model
    from repro_torch.testing import rel_err

    cfg = no_drops(served_config("mixtral-8x22b"))
    if cfg.window != MIXTRAL_WINDOW:
        raise AssertionError(f"mixtral-8x22b's window is {cfg.window}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    params = get_model(cfg).init(cfg, gen, "cuda")
    S, n = MIXTRAL_WINDOW_PROMPT, MIXTRAL_WINDOW_DECODE
    tokens = torch.randint(0, cfg.vocab_size, (1, S + n), generator=gen, device="cuda")
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    prefill(params, {"tokens": tokens[:, :S]})              # warm-up
    torch.cuda.synchronize()
    reset_op_counts()
    before = cuda_kernel_counts()
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": tokens[:, :S]})
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    counts, cuda_kernels = op_counts(), cuda_kernels_since(before)
    want_counts, want_kernels = expected_launches(cfg)
    if counts != want_counts or cuda_kernels != want_kernels:
        raise AssertionError(f"a windowed prefill launched {counts} ({cuda_kernels}), "
                             f"expected {want_counts} ({want_kernels})")
    ring = cache["scan"]["k"].shape[3]
    cache = pad_cache_to(cache, S + n, cfg.window)
    if ring != MIXTRAL_WINDOW or cache["scan"]["k"].shape[3] != MIXTRAL_WINDOW:
        raise AssertionError(f"the prefill cache holds {ring} positions, not a ring "
                             f"of {MIXTRAL_WINDOW}")
    errs, flips = [], []
    for i in range(n):
        with recording_routes() as by_prefill:
            whole, _ = prefill(params, {"tokens": tokens[:, :S + i + 1]})
        with replaying_routes(last_tokens(by_prefill, 1)) as replay:
            step, cache = decode(params, cache, {"tokens": tokens[:, S + i:S + i + 1]})
        if not (torch.isfinite(step).all() and torch.isfinite(whole).all()):
            raise AssertionError("logits are not finite")
        errs.append(rel_err(step, whole))
        flips.append(replay["routing_flips"])
    result = {"arch": "mixtral-8x22b", "layers": cfg.num_layers, "dtype": "bfloat16",
              "batch": 1, "prompt_len": S, "window": cfg.window,
              "capacity_factor": cfg.capacity_factor, "prefill_ms": t_prefill * 1e3,
              "prefill_logits_finite": bool(torch.isfinite(logits).all()),
              "ring_positions": ring, "launches_by_kernel": counts,
              "cuda_kernel_launches": cuda_kernels, "decode_steps": n,
              "decode_vs_prefill_rel_err": errs,
              "decode_routing_flips_replayed": flips,
              "decode_tol": DECODE_TOL}
    emit("mixtral_window", **result)
    if not (max(errs) < DECODE_TOL and result["prefill_logits_finite"]):
        raise AssertionError(f"decode on the ring disagrees with prefill: {result}")
    return result


def _train_batch(cfg) -> dict:
    """The first batch of the port's synthetic pipeline, on the card;
    Whisper's at 1500 // 4 tokens, with 1500 frames of random embeddings."""
    from repro_torch.data import DataConfig, ShardedDataset, make_batch_iter
    seq = WHISPER_FRAMES // 4 if cfg.family == "encdec" else PROMPT_LEN
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=BATCH, num_shards=64)
    batch = next(make_batch_iter(ShardedDataset(data, num_hosts=1), hosts=[0]))
    batch = {k: torch.from_numpy(v).long().cuda() for k, v in batch.items()}
    if cfg.family == "encdec":
        gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
        batch["enc_embeds"] = torch.randn((BATCH, WHISPER_FRAMES, cfg.d_model),
                                          generator=gen, device="cuda").to(cfg.compute_dtype)
    return batch


def phase_train(arch: str) -> dict:
    """`arch` trains at full width and depth (the MoE archs at the depth of
    TRAIN_LAYERS): a warm-up step, then
    TRAIN_STEPS timed steps of the port's train step, with every kernel's
    count set to 0 just before them.  Each forward kernel inside a
    checkpointed layer or half runs twice a step (the forward, and again
    under the remat's recompute), one outside (Zamba2's shared block) once, each
    backward once (`expected_launches`); the ops the arch does not have
    never; each through the CUDA kernels of the variant that the rule
    names."""
    from repro_torch import spans
    from repro_torch.configs import get_config
    from repro_torch.kernels.adamw import kernel as k4
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.common import get_model, param_count, tree_leaves
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = get_config(arch)
    if arch in TRAIN_LAYERS:
        cfg = cfg.replace(num_layers=TRAIN_LAYERS[arch])
    if cfg.remat not in ("full", "comm") or cfg.param_dtype != torch.bfloat16:
        raise AssertionError(f"{arch}: remat {cfg.remat}, {cfg.param_dtype}")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = get_model(cfg).init(cfg, gen, "cuda")
    opt = adamw_init(params)
    batch = _train_batch(cfg)
    opt_cfg = AdamWConfig(**{**TRAIN_OPT, "lr": TRAIN_LR.get(arch, TRAIN_OPT["lr"]),
                             "warmup_steps": TRAIN_WARMUP.get(arch, 0)})
    step = make_train_step(cfg, opt_cfg)
    t0 = time.perf_counter()
    params, opt, metrics = step(params, opt, batch)          # warm-up
    losses = [float(metrics["loss"])]
    warmup_s = time.perf_counter() - t0

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_op_counts()
    fa.flash_attention_bwd.copies = 0
    before = cuda_kernel_counts()
    k4_before, k4_calls = k4.launch_counts(), spans.counters()["kernel.adamw"]
    times = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, batch)
        losses.append(float(metrics["loss"]))               # waits for the step
        times.append(time.perf_counter() - t0)
    counts = op_counts()
    cuda_kernels = cuda_kernels_since(before)
    bwd_copies = fa.flash_attention_bwd.copies
    peak = torch.cuda.max_memory_allocated()
    expected, want = expected_launches(cfg, TRAIN_STEPS)
    if counts != expected or cuda_kernels != want:
        raise AssertionError(f"kernel launches {counts} ({cuda_kernels}) in "
                             f"{TRAIN_STEPS} train steps of {arch}, expected "
                             f"{expected} and {want}")
    # K4: the norm and the update of every leaf, a launch each a plan's launch
    adamw = {k: n - k4_before[k] for k, n in k4.launch_counts().items()}
    adamw_calls = spans.counters()["kernel.adamw"] - k4_calls
    per_step = len(k4.plan([x.numel() for x in tree_leaves(params)]))
    if adamw != {k: TRAIN_STEPS * per_step for k in k4.KERNELS} or adamw_calls != TRAIN_STEPS:
        raise AssertionError(f"K4 launches {adamw} ({adamw_calls} calls) in "
                             f"{TRAIN_STEPS} train steps of {arch}")
    timed = losses[1:]
    if not all(math.isfinite(x) for x in losses) or timed[-1] >= losses[0] or \
            any(b >= a for a, b in zip(timed, timed[1:])):
        raise AssertionError(f"train losses (warm-up, then timed) not finite "
                             f"and falling: {losses}")
    n_params = param_count(params)
    ms = sum(times) / len(times) * 1e3
    seq = batch["tokens"].shape[1]
    result = {"arch": arch, "family": cfg.family, "params": n_params,
              "layers": cfg.num_layers,
              "dtype": "bfloat16", "remat": cfg.remat, "batch": BATCH, "seq": seq,
              "steps_timed": TRAIN_STEPS, "lr": opt_cfg.lr,
              "lr_warmup_steps": opt_cfg.warmup_steps, "warmup_step_s": warmup_s,
              "ms_per_step": ms, "ms_per_step_each": [t * 1e3 for t in times],
              "tokens_per_s": BATCH * seq / (ms / 1e3),
              "warmup_loss": losses[0], "losses": timed,
              "peak_memory_bytes": peak,
              "param_bytes": sum(x.numel() * x.element_size() for x in tree_leaves(params)),
              "moment_bytes": 2 * 4 * n_params, "fp32_grad_bytes": 4 * n_params,
              "launches_by_kernel": counts, "cuda_kernel_launches": cuda_kernels,
              "adamw_launches": adamw, "leaves": len(tree_leaves(params)),
              "bwd_calls_that_copied_out_or_do": bwd_copies}
    if "enc_embeds" in batch:
        result["encoder_frames"] = WHISPER_FRAMES
    emit("train", **result)
    return result


def phase_train_parity_bf16(arch: str) -> None:
    """The gradients of `arch` at full width, 2 layers (Whisper: 2 and 2),
    in bf16 (the config's types), kernel path against dense path: the path
    the fp32 run cannot reach (K1b's wgmma variant; the scan's bf16
    variants under K2b).  Each gradient leaf within BF16_GRAD_TOL, relative
    to its dense max; each backward CUDA kernel once a backward call."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models.common import get_model
    from repro_torch.testing import rel_err

    cfg = get_config(arch).replace(num_layers=2)
    if cfg.family == "encdec":
        cfg = cfg.replace(enc_layers=2, dec_layers=2)
    if cfg.compute_dtype != torch.bfloat16:
        raise AssertionError(f"{arch} computes in {cfg.compute_dtype}")
    dense = cfg.replace(attn_impl="dense")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    params = get_model(cfg).init(cfg, gen, "cuda")
    batch = _train_batch(cfg)
    expected = {}
    for op, (inner, outer) in op_calls(cfg).items():
        if inner + outer:
            op_name = "flash_attention" if op == "attention" else "ssd_scan"
            for name in variant_kernels(cfg, op_name)[1]:
                expected[name] = expected.get(name, 0) + inner + outer
    before = cuda_kernel_counts()
    loss_k, grads_k = loss_and_grads(cfg, params, batch)
    torch.cuda.synchronize()
    ran = cuda_kernels_since(before)
    loss_d, grads_d = loss_and_grads(dense, params, batch)
    grad_errs = [rel_err(a, b) for a, b in zip(grads_k, grads_d)]
    loss_err = abs(float(loss_k) - float(loss_d)) / abs(float(loss_d))
    result = {"arch": arch, "layers": 2, "dtype": "bfloat16",
              "loss_rel_err": loss_err, "max_grad_rel_err": max(grad_errs),
              "median_grad_rel_err": sorted(grad_errs)[len(grad_errs) // 2],
              "leaves": len(grad_errs), "cuda_kernels": ran,
              "tol": BF16_GRAD_TOL}
    emit("train_parity_on_card", **result)
    if not (max(grad_errs) < BF16_GRAD_TOL and loss_err < BF16_GRAD_TOL
            and all(ran.get(k) == n for k, n in expected.items())):
        raise AssertionError(f"bf16 training: kernel path and dense path "
                             f"disagree: {result}, expected {expected}")


def phase_train_parity_on_card(arch: str) -> None:
    """One train step of `arch` at full width, 2 layers (Whisper: 2 and 2;
    mixtral-8x22b: 1, PARITY_TRAIN_LAYERS), fp32, with the kernels against
    the dense path: loss, every gradient and the updated params (the
    ill-conditioned elements counted, the rest) at PARITY_TOL; the MoE
    archs' chosen experts equal on both paths (`routing_agrees`: but for
    bf16 ties on DeepSeek, the dense path then taking the kernel path's
    experts in the gradients and the step).  Each path's gradients are
    dropped once read, and the paths step the params in turn, in place on
    the card, from a copy on the host (the kernel path's result waits
    there), so that the card holds one path's training state at a time."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.models.common import get_model, tree_leaves, tree_map
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.testing import rel_err

    layers = PARITY_TRAIN_LAYERS.get(arch, 2)
    cfg = get_config(arch).replace(num_layers=layers, param_dtype=torch.float32,
                                   compute_dtype=torch.float32)
    if cfg.family == "encdec":
        cfg = cfg.replace(enc_layers=2, dec_layers=2)
    dense = cfg.replace(attn_impl="dense")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    params = get_model(cfg).init(cfg, gen, "cuda")
    n_params = sum(x.numel() for x in tree_leaves(params))
    batch = _train_batch(cfg)
    (loss_k, grads_k), (loss_d, grads_d), ties, replayed = on_both_paths(
        arch, lambda: loss_and_grads(cfg, params, batch),
        lambda: loss_and_grads(dense, params, batch))
    grad_errs = [rel_err(a, b) for a, b in zip(grads_k, grads_d)]
    del grads_k
    # the gradient Adam sees on the dense path: after the global-norm clip;
    # where it is near zero the update is ill-conditioned
    norm = float(torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads_d)))
    clip = min(1.0, AdamWConfig().clip_norm / max(norm, 1e-9))
    ill = [(g.float() * clip).abs() < NEAR_ZERO_GRAD for g in grads_d]
    del grads_d
    host = tree_map(lambda t: t.to("cpu"), params)
    stepped = {}
    for name, c in (("kernel", cfg), ("dense", dense)):
        # where the gradients were taken on the kernel path's experts, the
        # step is too
        if not replayed:
            experts = contextlib.nullcontext()
        elif name == "kernel":
            experts = recording_routes()
        else:
            experts = replaying_routes(routes_step)
        with experts as routes:
            p, opt, m = make_train_step(c, AdamWConfig(**TRAIN_OPT))(
                params, adamw_init(params), batch)
        if name == "kernel":
            routes_step = routes
        stepped[name] = (p if name == "dense" else tree_map(lambda t: t.to("cpu"), p),
                         float(m["loss"]))
        del p, opt, m
        if name == "kernel":
            params = tree_map(lambda t: t.to("cuda"), host)
        release()
    n_ill, ill_max_abs, param_err = 0, 0.0, 0.0
    for a, b, mask in zip(tree_leaves(stepped["kernel"][0]),
                          tree_leaves(stepped["dense"][0]), ill):
        diff = (a.to("cuda") - b).abs()
        scale = float(b.abs().max()) + 1e-9
        if bool((~mask).any()):
            param_err = max(param_err, float(diff[~mask].max()) / scale)
        off = mask & (diff > PARITY_TOL * scale)
        n_ill += int(off.sum())
        if bool(off.any()):
            ill_max_abs = max(ill_max_abs, float(diff[off].max()))
    loss_err = abs(float(loss_k) - float(loss_d)) / abs(float(loss_d))
    step_loss_err = abs(stepped["kernel"][1] - stepped["dense"][1]) / abs(stepped["dense"][1])
    result = {"arch": arch, "layers": layers, "dtype": "float32",
              "loss_rel_err": loss_err, "step_loss_rel_err": step_loss_err,
              "max_grad_rel_err": max(grad_errs), "params_rel_err": param_err,
              "grad_norm": norm, "ill_conditioned_elements_off": n_ill,
              "ill_conditioned_max_abs_diff": ill_max_abs,
              "params": n_params, "tol": PARITY_TOL}
    if ties:
        result.update(ties, replayed_kernel_experts=replayed)
    emit("train_parity_on_card", **result)
    if not (max(loss_err, step_loss_err, max(grad_errs), param_err) < PARITY_TOL
            and n_ill <= 1e-4 * n_params
            and ill_max_abs <= 2 * TRAIN_OPT["lr"] * 1.01
            and (not ties or routing_agrees(arch, ties))):
        raise AssertionError(f"training: kernel path and dense path disagree: {result}")


def mapreduce_oracle(blocks, n_red: int) -> dict:
    """The five workloads' results by plain numpy on the host, block by block
    over every block (blocks spread over threads): wordcount and sort the
    token histogram, inverted_index the number of blocks holding each token,
    permutation the histogram of (t * 31 + t rolled by s within its block)
    mod VOCAB for s in 0..3, grep the needle's count at [needle % n_red, 0];
    each histogram split into n_red slices of VOCAB // n_red."""
    def one(b):
        hist = np.bincount(b, minlength=MR_VOCAB)
        perm = sum(np.bincount((b * 31 + np.roll(b, s)) % MR_VOCAB, minlength=MR_VOCAB)
                   for s in range(4))
        return hist, perm, int(np.count_nonzero(b == MR_NEEDLE))

    with ThreadPoolExecutor(max_workers=os.cpu_count()) as pool:
        parts = list(pool.map(one, blocks))
    hist = sum(h for h, _, _ in parts)
    grep = np.zeros((n_red, 1), np.int64)
    grep[MR_NEEDLE % n_red, 0] = sum(g for _, _, g in parts)
    return {"wordcount": hist.reshape(n_red, -1), "grep": grep,
            "sort": hist.reshape(n_red, -1),
            "permutation": sum(p for _, p, _ in parts).reshape(n_red, -1),
            "inverted_index": sum((h > 0).astype(np.int64)
                                  for h, _, _ in parts).reshape(n_red, -1)}


def phase_mapreduce() -> dict:
    """The paper's MapReduce data plane on the card: each of its five
    workloads over one job of 2^30 tokens (4 GiB of int32 blocks on the
    card) through `repro_torch.mapreduce.run_mapreduce`, element-equal to the
    numpy oracle; each timed by CUDA events, the best of 3 after a warm-up,
    beside the bound of reading its input once at the memory rate."""
    from repro_torch.mapreduce import VOCAB, WORKLOAD_FNS, MRJob, make_blocks, run_mapreduce
    from repro_torch.mapreduce.engine import MAP_BUDGET_BYTES, chunk_blocks

    t_phase = time.perf_counter()
    if VOCAB != MR_VOCAB:
        raise AssertionError(f"the engine's VOCAB is {VOCAB}, the oracle's {MR_VOCAB}")
    t0 = time.perf_counter()
    host = make_blocks(MRJob("wordcount", **MR_JOB))
    make_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    blocks = torch.from_numpy(host).cuda()
    torch.cuda.synchronize()
    h2d_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    oracle = mapreduce_oracle(host, MR_JOB["n_reducers"])
    oracle_s = time.perf_counter() - t0
    del host
    n_bytes = blocks.numel() * blocks.element_size()
    bound_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    torch.cuda.reset_peak_memory_stats()
    results = {}
    for workload in WORKLOAD_FNS:
        job = MRJob(workload, **MR_JOB)
        out = run_mapreduce(job, blocks)                     # warm-up, and checked
        want = oracle[workload]
        if not (out.dtype == torch.int32 and tuple(out.shape) == want.shape
                and np.array_equal(out.cpu().numpy(), want)):
            raise AssertionError(f"mapreduce {workload} differs from the numpy oracle")
        runs = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run_mapreduce(job, blocks)
            end.record()
            torch.cuda.synchronize()
            runs.append(start.elapsed_time(end))
        ms = min(runs)
        results[workload] = {"ms": ms, "ms_each": runs,
                             "input_gb_per_s": n_bytes / (ms / 1e3) / 1e9,
                             "bound_ms": bound_ms, "bound_by": "bytes",
                             "equal_to_oracle": True, "total": int(want.sum())}
    result = {"job": MR_JOB, "tokens": blocks.numel(), "input_bytes": n_bytes,
              "chunk_blocks": chunk_blocks(MR_JOB["block_tokens"]),
              "map_budget_bytes": MAP_BUDGET_BYTES, "make_blocks_s": make_s,
              "host_to_device_s": h2d_s, "oracle_s": oracle_s,
              "workloads": results,
              "peak_memory_bytes": torch.cuda.max_memory_allocated(),
              "seconds": time.perf_counter() - t_phase}
    emit("mapreduce", **result)
    return result


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal type, shape and bits (floats compared as integers of their
    width)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        width = {2: torch.int16, 4: torch.int32}[a.element_size()]
        a, b = a.view(width), b.view(width)
    return bool(torch.equal(a, b))


def phase_checkpoint() -> dict:
    """CKPT_ARCH at full width and depth, bf16, after one train step (so the
    moments are not zero): params and AdamW state in the JAX package's
    layout, saved by `AsyncCheckpointer` into a temporary directory (removed
    afterwards), then restored by `restore_checkpoint` into a fresh template
    on the card.  Every restored leaf must equal the saved one bit for bit;
    then one train step from the restored state and one from the live state,
    on the same batch, must give the same loss, params and moments, bit for
    bit."""
    from repro_torch.checkpoint import (AsyncCheckpointer, from_jax_train_state,
                                        restore_checkpoint, to_jax_train_state)
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.common import get_model, tree_leaves, tree_map
    from repro_torch.optim import AdamWConfig, adamw_init

    t_phase = time.perf_counter()
    cfg = get_config(CKPT_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = get_model(cfg).init(cfg, gen, "cuda")
    opt = adamw_init(params)
    batch = _train_batch(cfg)
    step = make_train_step(cfg, AdamWConfig(**TRAIN_OPT))
    params, opt, _ = step(params, opt, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    state = to_jax_train_state(cfg, params, opt)
    n_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(state))
    n_leaves = len(tree_leaves(state))
    with tempfile.TemporaryDirectory(prefix="ckpt-", dir=ROOT / "build") as d:
        ck = AsyncCheckpointer(d)
        t0 = time.perf_counter()
        ck.save(1, state)                   # device -> host on this thread
        copy_s = time.perf_counter() - t0
        del state
        ck.wait()                           # the worker's write
        save_s = time.perf_counter() - t0
        file_bytes = (Path(d) / "step_1" / "arrays.npz").stat().st_size
        meta = tree_map(lambda t: t.to("meta"), {"params": params, "opt": opt})
        template = to_jax_train_state(cfg, meta["params"], meta["opt"])
        t0 = time.perf_counter()
        restored = restore_checkpoint(d, 1, template)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    params_r, opt_r = from_jax_train_state(cfg, restored)
    del restored
    live_leaves = tree_leaves({"params": params, "opt": opt})
    back_leaves = tree_leaves({"params": params_r, "opt": opt_r})
    differ = sum(not same_bits(a, b) for a, b in zip(live_leaves, back_leaves))
    if differ or len(live_leaves) != len(back_leaves):
        raise AssertionError(f"{differ} of {len(live_leaves)} leaves differ after "
                             f"the restore ({len(back_leaves)} restored)")
    # one more step from each, on the same batch: the restored state is the
    # live one as far as training can tell
    params_r, opt_r, m_r = step(params_r, opt_r, batch)
    params, opt, m_l = step(params, opt, batch)
    live_leaves = tree_leaves({"params": params, "opt": opt})
    back_leaves = tree_leaves({"params": params_r, "opt": opt_r})
    step_differ = sum(not same_bits(a, b) for a, b in zip(live_leaves, back_leaves))
    loss_equal = same_bits(m_r["loss"], m_l["loss"])
    result = {"arch": CKPT_ARCH, "dtype": "bfloat16", "leaves": n_leaves,
              "state_bytes": n_bytes, "file_bytes": file_bytes,
              "copy_to_host_s": copy_s, "save_s": save_s,
              "save_gb_per_s": n_bytes / save_s / 1e9,
              "restore_s": restore_s, "restore_gb_per_s": n_bytes / restore_s / 1e9,
              "restored_bit_for_bit": True,
              "step_after_restore": {"loss_restored": float(m_r["loss"]),
                                     "loss_live": float(m_l["loss"]),
                                     "loss_equal": loss_equal,
                                     "leaves_that_differ": step_differ},
              "peak_memory_bytes": torch.cuda.max_memory_allocated(),
              "seconds": time.perf_counter() - t_phase}
    emit("checkpoint", **result)
    if step_differ or not loss_equal:
        raise AssertionError(f"the step after the restore differs from the live "
                             f"one: {result['step_after_restore']}")
    return result


def sur_fingerprint(res) -> tuple:
    """Every number of a surrogate result that a run record keeps, exact."""
    return (res.makespan, res.jobs_total, res.jobs_finished, res.deadlines_met,
            res.locality_rate, res.latched_steps, res.steps_integrated,
            tuple((j.job_id, j.finish_time, j.local_map_launches,
                   j.remote_map_launches) for j in res.jobs))


def plain_fluid_scan(jobs, order, scalars, phys, *, n_steps, diag=False):
    """The fluid scan's plain version, on whatever device its inputs are."""
    from repro_torch.kernels.fluid_scan.ref import fluid_scan_ref
    return fluid_scan_ref(jobs, order, scalars, phys, n_steps=n_steps, diag=diag)


@contextlib.contextmanager
def patched(module, name: str, fn):
    """`module.name` is `fn` inside the block."""
    saved = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, saved)


def forced_fluid_scan(name: str):
    """The fluid scan as `fluid_ops.fluid_scan` is called, on the CUDA
    variant `name` whatever the rule picks (raises where it does not take
    the bucket)."""
    from repro_torch.kernels.fluid_scan import kernel as fluid

    def scan(jobs, order, scalars, phys, *, n_steps, diag=False):
        return fluid.fluid_scan_cuda(jobs, order, scalars, phys, n_steps=n_steps,
                                     diag=diag, variant=name)
    return scan


def sur_bit_equal(name: str, compared: dict) -> dict:
    """`compared` (sur_compare's) when every cell is bit-equal; raises
    otherwise."""
    if compared["cells_bit_equal"] != compared["cells"]:
        raise AssertionError(f"{name}: {compared['cells_bit_equal']} of "
                             f"{compared['cells']} cells bit-equal to the plain version")
    return compared


def sur_compare(k3_results, plain_results) -> dict:
    """K3 against the plain version, cell by cell: every finish time equal,
    the locality rate within SUR_LOCALITY_TOL; the largest difference of a
    finish time, a job's launch mass or a locality rate."""
    err = 0.0
    for a, b in zip(k3_results, plain_results):
        fa_, fb = [j.finish_time for j in a.jobs], [j.finish_time for j in b.jobs]
        if fa_ != fb:
            raise AssertionError(f"fluid_scan moved a finish time: {len(fa_)} jobs, "
                                 f"{sum(x != y for x, y in zip(fa_, fb))} differ")
        if abs(a.locality_rate - b.locality_rate) > SUR_LOCALITY_TOL:
            raise AssertionError(f"fluid_scan locality {a.locality_rate} vs plain "
                                 f"{b.locality_rate}")
        err = max([err, abs(a.locality_rate - b.locality_rate)]
                  + [abs(x.local_map_launches - y.local_map_launches)
                     + abs(x.remote_map_launches - y.remote_map_launches)
                     for x, y in zip(a.jobs, b.jobs)])
    bitwise = sum(sur_fingerprint(a) == sur_fingerprint(b)
                  for a, b in zip(k3_results, plain_results))
    return {"cells": len(k3_results), "max_abs_err": err, "cells_bit_equal": bitwise}


def fluid_bound_ms(cells: int, jp: int, steps: int) -> tuple:
    """The least time for `cells` cells of `jp` padded jobs that integrate
    `steps` steps between them a cell on average: the larger of the inputs
    read once and the outputs written once at the memory rate, and
    FLUID_OPS_PER_JOB_STEP fp32 operations a job and step at the fp32 peak."""
    n_bytes = cells * (jp * (10 + 1 + 5) * 4 + 11 * 4 + 8)
    ops = cells * jp * steps * FLUID_OPS_PER_JOB_STEP
    by_bytes, by_ops = n_bytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_FLOPS
    return max(by_bytes, by_ops) * 1e3, ("bytes" if by_bytes > by_ops else "operations")


def calibration_spec(preset: str, shape: str, allow: tuple):
    """The calibration cells of one `CALIBRATED` pair, as the port's
    `calibrate` builds them: `regime_spec`'s trace and fleet, the allowlisted
    policies and fair, the calibration seeds."""
    from repro_torch.experiments import surrogate as texp
    from repro_torch.experiments.regimes import regime_spec
    from repro_torch.experiments.runner import ExperimentSpec
    base = regime_spec(preset, shape, seeds=texp.CALIBRATION_SEEDS)
    return ExperimentSpec(name=f"cal-{preset}-{shape}", traces=base.traces,
                          clusters=base.clusters, schedulers=allow + ("fair",),
                          seeds=texp.CALIBRATION_SEEDS)


def phase_surrogate() -> dict:
    """The paper's batched fluid surrogate on the card (K3): the bench grid of
    1000 cells through `experiments.surrogate.run_surrogate` into a temporary
    cache, timed by parts (the host's trace and cell build, the integration,
    K3 by CUDA events), on the rule's variant `fluid_scan_warp` by the C
    count; both CUDA variants bit-equal to the plain version on the card over
    one 64-cell sub-batch of the grid, the calibration cells (each preset's
    allowlisted policies and fair, seeds 0-3, the gains over fair printed)
    and one cell's diagnostics, and `fluid_scan_block` over the oversized
    bucket, which the rule gives it; the determinism contract on
    `fluid_scan_warp` (a second run byte-equal, the reversed batch and
    max_batch 1 equal cell by cell); both variants timed in turns at the
    grid's launch, the sub-batch and a calibration bucket of 64 jobs, each
    beside its bound and the plain version's time."""
    import dataclasses

    from repro_torch import spans
    from repro_torch.core.types import ClusterSpec
    from repro_torch.experiments import surrogate as texp
    from repro_torch.experiments.runner import ExperimentSpec, TraceRef
    from repro_torch.experiments.stats import compare_throughput
    from repro_torch.kernels.fluid_scan import kernel as fluid
    from repro_torch.kernels.fluid_scan import ops as fluid_ops
    from repro_torch.simcluster import surrogate as tsur
    from repro_torch.simcluster.traces import PRESETS, _dumps

    t_phase = time.perf_counter()
    grid = ExperimentSpec(
        name="bench-surrogate-fleet", traces=(TraceRef(preset="heavy_tail"),),
        clusters=(ClusterSpec(num_machines=200, vms_per_machine=2, replication=2),),
        schedulers=SUR_POLICIES, seeds=tuple(range(SUR_GRID_SEEDS)))
    first = next(iter(grid.cells()))
    warm = tsur.build_cell(first.trace.resolve(0), first.cluster, first.scheduler, 0)
    tsur.run_batch([warm], device="cuda")          # loads the kernel: not counted
    torch.cuda.synchronize()

    # -- 1. the grid through the entry point, timed by parts
    host = {"build_s": 0.0, "integrate_s": 0.0}
    events, batches = [], []
    build_cell, run_batch, scan = texp.build_cell, texp.run_batch, fluid_ops.fluid_scan

    def timed_build(*args, **kwargs):
        t0 = time.perf_counter()
        out = build_cell(*args, **kwargs)
        host["build_s"] += time.perf_counter() - t0
        return out

    def timed_run_batch(cells, **kwargs):
        t0 = time.perf_counter()
        out = run_batch(cells, **kwargs)
        torch.cuda.synchronize()
        host["integrate_s"] += time.perf_counter() - t0
        batches.append((list(cells), out))
        return out

    def timed_scan(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = scan(*args, **kwargs)
        end.record()
        events.append((start, end))
        return out

    with tempfile.TemporaryDirectory(prefix="surrogate-", dir=ROOT / "build") as d:
        with patched(texp, "build_cell", timed_build), \
                patched(texp, "run_batch", timed_run_batch), \
                patched(fluid_ops, "fluid_scan", timed_scan):
            scans_before = spans.counters()["kernel.fluid_scan"]
            before = fluid.launch_counts()
            t0 = time.perf_counter()
            # the grid's one bucket is the first cell's: the rule's variant
            report, grid_variant, _ = launched_variant(
                lambda: texp.run_surrogate(grid, Path(d) / "grid", device="cuda"),
                fluid, fluid.variant(warm.padded_jobs()))
            total_s = time.perf_counter() - t0
            launches = spans.counters()["kernel.fluid_scan"] - scans_before
            c_launches = {k: n - before[k] for k, n in fluid.launch_counts().items()}
    torch.cuda.synchronize()
    kernel_ms = [s.elapsed_time(e) for s, e in events]
    (cells, results), = batches
    records = report.records
    if report.simulated != grid.n_cells() or len(records) != grid.n_cells():
        raise AssertionError(f"run_surrogate integrated {report.simulated} of "
                             f"{grid.n_cells()} cells")
    for r in records:
        if not (r.jobs_total == r.jobs_finished == 80 and math.isfinite(r.makespan)
                and r.makespan > 0 and 0.0 <= r.locality_rate <= 1.0
                and all(math.isfinite(j.local_map_launches + j.remote_map_launches)
                        for j in r.jobs)):
            raise AssertionError(f"a grid cell is wrong: {r.scheduler} seed {r.seed}: "
                                 f"{r.jobs_finished}/{r.jobs_total} jobs, makespan "
                                 f"{r.makespan}, locality {r.locality_rate}")
    buckets = sorted({(c.padded_jobs(), c.n_steps()) for c in cells})
    steps = [r.steps_integrated for r in results]
    (jp, n_steps), = buckets
    if grid_variant != "fluid_scan_warp" or launches != 1 \
            or c_launches.get("fluid_scan_warp") != launches:
        raise AssertionError(f"the grid ran K3 {launches} times on {grid_variant} "
                             f"(C counted {c_launches})")
    grid_bound, grid_bound_by = fluid_bound_ms(len(cells), jp, sum(steps) / len(steps))
    grid_out = {
        "cells": len(cells), "buckets": buckets, "launches": launches,
        "cuda_kernel_launches": c_launches, "variant": grid_variant,
        "host_build_s": host["build_s"], "integrate_s": host["integrate_s"],
        "run_surrogate_s": total_s,
        "cells_per_s": len(cells) / total_s,
        "cells_per_s_build_and_integrate": len(cells) / (host["build_s"] + host["integrate_s"]),
        "kernel_ms_each": kernel_ms, "kernel_ms": sum(kernel_ms) / len(kernel_ms),
        "steps_integrated_max": max(steps), "steps_integrated_min": min(steps),
        "horizon_steps": n_steps,
        "us_per_integrated_step": sum(kernel_ms) * 1e3 / max(steps),
        "bound_ms": grid_bound, "bound_by": grid_bound_by,
        "jobs_finished": sum(r.jobs_finished for r in records)}

    # -- 2. both variants against the plain version, cell by cell, bit for
    # bit: one 64-cell sub-batch of the grid; the calibration cells through
    # run_surrogate; one diagnostics run; then the oversized bucket, the
    # block variant's by the rule
    dev = torch.device("cuda")
    block_scan = forced_fluid_scan("fluid_scan_block")
    sub = cells[:SUR_SUBBATCH]
    with patched(fluid_ops, "fluid_scan", plain_fluid_scan):
        plain_sub = tsur.run_batch(sub, device="cuda")
    with patched(fluid_ops, "fluid_scan", block_scan):
        block_sub = tsur.run_batch(sub, device="cuda")
    checks = {"grid_subbatch": {
        "fluid_scan_warp": sur_bit_equal("the grid's sub-batch on fluid_scan_warp",
                                         sur_compare(results[:SUR_SUBBATCH], plain_sub)),
        "fluid_scan_block": sur_bit_equal("the grid's sub-batch on fluid_scan_block",
                                          sur_compare(block_sub, plain_sub))}}

    gains, cal_k3 = {}, []
    with tempfile.TemporaryDirectory(prefix="surrogate-", dir=ROOT / "build") as d:
        for (preset, shape), allow in sorted(texp.CALIBRATED.items()):
            spec = calibration_spec(preset, shape, allow)
            k3_rep = texp.run_surrogate(spec, Path(d) / "k3", device="cuda")
            again = texp.run_surrogate(spec, Path(d) / "again", device="cuda")

            def dumped(rep):
                return [_dumps({k: v for k, v in r.to_dict().items() if k != "wall_time_s"})
                        for r in rep.records]

            if dumped(k3_rep) != dumped(again):
                raise AssertionError(f"{preset}: a second run differs")
            by = k3_rep.by_scheduler()
            gains[f"{preset}/{shape}"] = {
                pol: compare_throughput(by["fair"], by[pol]).mean_gain_pct for pol in allow}
            for rec in k3_rep.records:
                trace = spec.traces[0].resolve(rec.seed)
                cal_k3.append(tsur.build_cell(trace, spec.clusters[0], rec.policy, rec.seed))
    # both variants against the plain version over the calibration cells, and
    # the contract there on the rule's variant: the batch reversed, one cell
    # a launch, equal cell by cell
    before = fluid.launch_counts()
    base = tsur.run_batch(cal_k3, device="cuda")
    reversed_ = tsur.run_batch(cal_k3[::-1], device="cuda")[::-1]
    one_by_one = tsur.run_batch(cal_k3, device="cuda", max_batch=1)
    grid_again = tsur.run_batch(cells, device="cuda")
    contract_kernels = {k: n - before[k] for k, n in fluid.launch_counts().items()
                        if n != before[k]}
    with patched(fluid_ops, "fluid_scan", plain_fluid_scan):
        cal_plain = tsur.run_batch(cal_k3, device="cuda")
    with patched(fluid_ops, "fluid_scan", block_scan):
        cal_block = tsur.run_batch(cal_k3, device="cuda")
    checks["calibration"] = {
        "fluid_scan_warp": sur_bit_equal("the calibration cells on fluid_scan_warp",
                                         sur_compare(base, cal_plain)),
        "fluid_scan_block": sur_bit_equal("the calibration cells on fluid_scan_block",
                                          sur_compare(cal_block, cal_plain))}
    contract = {
        "reversed_equal": [sur_fingerprint(r) for r in reversed_] == [sur_fingerprint(r) for r in base],
        "max_batch_1_equal": [sur_fingerprint(r) for r in one_by_one] == [sur_fingerprint(r) for r in base],
        "grid_second_run_equal": [sur_fingerprint(r) for r in grid_again] == [sur_fingerprint(r) for r in results],
        "calibration_second_run_byte_equal": True,
        "on_fluid_scan_warp_alone": set(contract_kernels) == {"fluid_scan_warp"}}
    if not all(contract.values()):
        raise AssertionError(f"the determinism contract fails on the card: {contract} "
                             f"(CUDA kernels {contract_kernels})")
    contract["cuda_kernel_launches"] = contract_kernels
    # one cell's diagnostics over the whole horizon, every aggregate equal
    cell = cal_k3[0]
    with patched(fluid_ops, "fluid_scan", plain_fluid_scan):
        dp = tsur.run_cell(cell, diag=True, device="cuda")
    checks["diag"] = {}
    for name, runner in (("fluid_scan_warp", fluid_ops.fluid_scan), ("fluid_scan_block", block_scan)):
        with patched(fluid_ops, "fluid_scan", runner):
            dk = tsur.run_cell(cell, diag=True, device="cuda")
        differ = [k for k in dk.diag if not np.array_equal(dk.diag[k], dp.diag[k])]
        if differ:
            raise AssertionError(f"diag on {name}: {differ} differ from the plain version")
        checks["diag"][name] = {"steps": dk.steps_integrated, "aggregates_bit_equal": len(dk.diag),
                                **sur_bit_equal(f"the diag cell on {name}", sur_compare([dk], [dp]))}
    # the oversized bucket: more padded jobs than the warp variant takes
    cfg = PRESETS["mix"]
    big_cfg = dataclasses.replace(cfg, name="mix_big", num_jobs=SUR_BIG["num_jobs"],
                                  arrival=dataclasses.replace(
                                      cfg.arrival, rate_per_hour=SUR_BIG["rate_per_hour"]))
    big_trace = TraceRef(config=big_cfg).resolve(0)
    big_cluster = ClusterSpec(num_machines=200, vms_per_machine=2, replication=2)
    big = [tsur.build_cell(big_trace, big_cluster, pol, 0) for pol in ("proposed", "fair")]
    if big[0].padded_jobs() <= 256:
        raise AssertionError(f"the oversized bucket has {big[0].padded_jobs()} jobs")
    big_k3, big_variant, _ = launched_variant(lambda: tsur.run_batch(big, device="cuda"),
                                              fluid, fluid.variant(big[0].padded_jobs()))
    if big_variant != "fluid_scan_block":
        raise AssertionError(f"the oversized bucket ran {big_variant}")
    with patched(fluid_ops, "fluid_scan", plain_fluid_scan):
        big_plain = tsur.run_batch(big, device="cuda")
    checks["oversized"] = {
        "fluid_scan_block": {"bucket": [big[0].padded_jobs(), big[0].n_steps()],
                             "jobs": big[0].n_jobs,
                             "steps": [r.steps_integrated for r in big_k3],
                             **sur_bit_equal("the oversized bucket on fluid_scan_block",
                                             sur_compare(big_k3, big_plain))}}
    max_err = max(c["max_abs_err"] for place in checks.values() for c in place.values())

    # -- 3. both variants timed in turns, each beside its bound and the plain
    # version's time: the grid's launch, the sub-batch, and the first
    # calibration bucket of 64 jobs; the rule's variant must be the faster
    cal_64 = sorted({(c.padded_jobs(), c.n_steps()) for c in cal_k3 if c.padded_jobs() == 64})[0]
    timings = {}
    for place, (cs, ns) in (("grid", (cells, n_steps)), ("subbatch", (sub, n_steps)),
                            ("calibration_64", ([c for c in cal_k3 if (c.padded_jobs(),
                                                 c.n_steps()) == cal_64], cal_64[1]))):
        args = tsur._stack(cs, dev)
        cjp = cs[0].padded_jobs()
        st = fluid.fluid_scan_cuda(*args, tsur.PHYSICS, n_steps=ns)["steps"]
        ms, in_order = in_turns(
            [(v, lambda v=v: fluid.fluid_scan_cuda(*args, tsur.PHYSICS, n_steps=ns, variant=v))
             for v in ("fluid_scan_warp", "fluid_scan_block")], SUR_TIMING_ITERS)
        bound, bound_by = fluid_bound_ms(len(cs), cjp, float(st.float().mean()))
        rule = fluid.variant(cjp)
        timings[place] = {
            "cells": len(cs), "bucket": [cjp, ns], "variant": rule,
            "steps_integrated": [int(st.min()), int(st.max())],
            "ms": {v: min(x) for v, x in ms.items()}, "ms_in_turns": in_order,
            "plain_ms": time_ms(lambda: plain_fluid_scan(*args, tsur.PHYSICS, n_steps=ns), 1,
                                warmup=0),
            "bound_ms": bound, "bound_by": bound_by}
        if min(ms[rule]) > min(min(x) for x in ms.values()):
            raise AssertionError(f"{place}: the rule's {rule} is not the faster: {ms}")
    result = {"grid": grid_out, "gains_over_fair_pct": gains, "k3_vs_plain": checks,
              "contract": contract, "timings": timings,
              "max_abs_err": max_err,
              "seconds": time.perf_counter() - t_phase}
    emit("surrogate", **result)
    return result


def phase_calibration() -> dict:
    """The surrogate's calibration wall on the port alone: for every
    `CALIBRATED` pair, `experiments.surrogate.calibrate(..., device="cuda")`
    runs the port's event engine on the host as the oracle (inline, no
    worker pool) and the fluid surrogate with K3 on the card; every pair
    must be `wall_green`.  K3's launches are counted from 0 over the
    calibrations (the buckets of 64 and 128 padded jobs, on
    `fluid_scan_warp` by the C count).  A second run into the same cache
    simulates and integrates nothing and gives the same records, byte for
    byte.  Then the `surrogate` verb as a user runs it, in a subprocess
    (it must exit 0; its output is printed), and what the surrogate buys:
    one heavy_tail cell at 20x2 and at 100x2, seed 0, under proposed and
    fair, through the event engine on the host and `run_surrogate` on the
    card, each timed (printed, not gated: 100x2 is not calibrated)."""
    import dataclasses

    from repro_torch import spans
    from repro_torch.experiments import surrogate as texp
    from repro_torch.experiments.regimes import regime_spec
    from repro_torch.experiments.runner import ExperimentSpec, run_experiment
    from repro_torch.kernels.fluid_scan import kernel as fluid
    from repro_torch.kernels.fluid_scan import ops as fluid_ops
    from repro_torch.simcluster.traces import _dumps

    t_phase = time.perf_counter()
    spent = {"oracle": 0.0, "surrogate": 0.0}
    reports, buckets = [], set()
    oracle_fn, surrogate_fn, run_batch = texp.run_experiment, texp.run_surrogate, texp.run_batch

    def timed(engine, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent[engine] += time.perf_counter() - t0
            reports.append((engine, out))
            return out
        return run

    def bucketed(cells, **kwargs):
        buckets.update((c.padded_jobs(), c.n_steps()) for c in cells)
        return run_batch(cells, **kwargs)

    def dumped(rep):
        return [_dumps({k: v for k, v in r.to_dict().items() if k != "wall_time_s"})
                for r in rep.records]

    pairs = {}
    with tempfile.TemporaryDirectory(prefix="calibration-", dir=ROOT / "build") as d, \
            patched(texp, "run_experiment", timed("oracle", oracle_fn)), \
            patched(texp, "run_surrogate", timed("surrogate", surrogate_fn)), \
            patched(texp, "run_batch", bucketed):
        scans_before = spans.counters()["kernel.fluid_scan"]
        before = fluid.launch_counts()
        for (preset, shape), allow in sorted(texp.CALIBRATED.items()):
            n_cells = calibration_spec(preset, shape, allow).n_cells()
            runs = []
            for _ in range(2):
                reports.clear()
                spent.update(oracle=0.0, surrogate=0.0)
                report = texp.calibrate(preset, shape, Path(d), device="cuda")
                runs.append((report, dict(reports), dict(spent)))
            (cal, first, s1), (again, second, s2) = runs
            if not cal.wall_green:
                raise AssertionError(f"{preset}/{shape}: calibration drift: " + ", ".join(
                    f"{p.policy} {p.surrogate_gain_pct:+.2f}% vs "
                    f"[{p.oracle.ci_lo_pct:+.2f}, {p.oracle.ci_hi_pct:+.2f}]"
                    for p in cal.policies if not p.inside))
            fresh = {e: (r.simulated, r.cached) for e, r in first.items()}
            served = {e: (r.simulated, r.cached) for e, r in second.items()}
            if fresh != {"oracle": (n_cells, 0), "surrogate": (n_cells, 0)} or \
                    served != {"oracle": (0, n_cells), "surrogate": (0, n_cells)}:
                raise AssertionError(f"{preset}/{shape}: {n_cells} cells, first run "
                                     f"(simulated, cached) {fresh}, second {served}")
            if any(dumped(first[e]) != dumped(second[e]) for e in first) or \
                    [dataclasses.asdict(p) for p in cal.policies] != \
                    [dataclasses.asdict(p) for p in again.policies]:
                raise AssertionError(f"{preset}/{shape}: the second run from the cache "
                                     "differs from the first")
            pairs[f"{preset}/{shape}"] = {
                "wall_green": cal.wall_green, "cells_per_engine": n_cells,
                "oracle_s": s1["oracle"], "surrogate_s": s1["surrogate"],
                "second_run_s": s2["oracle"] + s2["surrogate"],
                "policies": {p.policy: {
                    "surrogate_gain_pct": p.surrogate_gain_pct,
                    "oracle_gain_pct": p.oracle.mean_gain_pct,
                    "oracle_ci_pct": [p.oracle.ci_lo_pct, p.oracle.ci_hi_pct],
                    "inside": p.inside} for p in cal.policies}}
        torch.cuda.synchronize()
        launches = spans.counters()["kernel.fluid_scan"] - scans_before
        c_launches = {k: n - before[k] for k, n in fluid.launch_counts().items()
                      if n != before[k]}
    variants = sorted({fluid.variant(jp) for jp, _ in buckets})
    if launches == 0 or variants != ["fluid_scan_warp"] or \
            c_launches != {"fluid_scan_warp": launches}:
        raise AssertionError(f"the calibration ran K3 {launches} times on {variants} "
                             f"(C counted {c_launches})")
    print("calibration: the port's event engine (host) as the oracle, K3 on the card")
    for key, p in pairs.items():
        print(f"  {key}: oracle {p['oracle_s']:.3f} s for {p['cells_per_engine']} cells, "
              f"surrogate {p['surrogate_s']:.3f} s, second run {p['second_run_s']:.3f} s")
        for pol, x in p["policies"].items():
            print(f"    {pol:11s} surrogate {x['surrogate_gain_pct']:+7.3f}% vs oracle CI "
                  f"[{x['oracle_ci_pct'][0]:+7.3f}%, {x['oracle_ci_pct'][1]:+7.3f}%] "
                  f"{'IN' if x['inside'] else 'OUT'}")

    # the verb, as a user runs it
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    with tempfile.TemporaryDirectory(prefix="calibration-verb-", dir=ROOT / "build") as d:
        argv = [sys.executable, "-m", "repro_torch.experiments", *CAL_VERB, "--cache", d]
        t0 = time.perf_counter()
        proc = subprocess.run(argv, capture_output=True, text=True, env=env, cwd=ROOT,
                              timeout=CAL_VERB_TIMEOUT_S)
        verb_s = time.perf_counter() - t0
    print(f"$ python -m repro_torch.experiments {' '.join(CAL_VERB)} --cache <tmp>")
    print(proc.stdout, end="", flush=True)
    if proc.returncode != 0:
        print(proc.stderr, file=sys.stderr, flush=True)
        raise AssertionError(f"the surrogate verb exited with {proc.returncode}")
    if proc.stdout.count(" IN") == 0 or " OUT" in proc.stdout:
        raise AssertionError("the surrogate verb printed no calibration, or a drift")

    # what the surrogate buys: the event engine's seconds a cell beside
    # run_surrogate's, on the same cells
    buys = {}
    for shape in CAL_HOST_SHAPES:
        base = regime_spec("heavy_tail", shape, seeds=(0,))
        spec = ExperimentSpec(name=f"host-heavy_tail-{shape}", traces=base.traces,
                              clusters=base.clusters, schedulers=("proposed", "fair"),
                              seeds=(0,))
        with tempfile.TemporaryDirectory(prefix="calibration-host-", dir=ROOT / "build") as d:
            t0 = time.perf_counter()
            event = run_experiment(spec, Path(d) / "event", workers=0)
            event_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            fluid_rep = texp.run_surrogate(spec, Path(d) / "fluid", device="cuda")
            torch.cuda.synchronize()
            fluid_s = time.perf_counter() - t0
        ev, fl = event.by_scheduler(), fluid_rep.by_scheduler()
        buys[shape] = {
            "jobs": event.records[0].jobs_total,
            "event_s_per_cell": {p: ev[p][0].wall_time_s for p in ev},
            "event_events": {p: ev[p][0].events_processed for p in ev},
            "event_s": event_s, "run_surrogate_s": fluid_s,
            "run_surrogate_s_per_cell": fluid_s / len(fluid_rep.records),
            "throughput_jph": {p: {"event": ev[p][0].throughput_jph,
                                   "surrogate": fl[p][0].throughput_jph} for p in ev},
            "jobs_finished": {p: [ev[p][0].jobs_finished, fl[p][0].jobs_finished]
                              for p in ev}}
        print(f"  heavy_tail/{shape} seed 0: event engine "
              + ", ".join(f"{p} {s:.3f} s" for p, s in buys[shape]["event_s_per_cell"].items())
              + f"; run_surrogate {fluid_s:.3f} s for both cells")
    result = {"pairs": pairs, "all_wall_green": all(p["wall_green"] for p in pairs.values()),
              "launches": launches, "cuda_kernel_launches": c_launches,
              "buckets": sorted(buckets), "variant": variants[0],
              "oracle_s": sum(p["oracle_s"] for p in pairs.values()),
              "surrogate_s": sum(p["surrogate_s"] for p in pairs.values()),
              "oracle_cells": sum(p["cells_per_engine"] for p in pairs.values()),
              "verb": {"argv": CAL_VERB, "rc": proc.returncode, "seconds": verb_s},
              "what_the_surrogate_buys": buys,
              "seconds": time.perf_counter() - t_phase}
    emit("calibration", **result)
    return result


def run_verb(argv, env, timeout=EXP_TIMEOUT_S):
    """One `python -m repro_torch.experiments` verb in a subprocess, as a user
    runs it: (stdout, seconds).  A non-zero exit fails the phase."""
    cmd = [sys.executable, "-m", "repro_torch.experiments", *argv]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=timeout)
    seconds = time.perf_counter() - t0
    shown = " ".join(str(a).replace(str(ROOT) + os.sep, "") for a in argv)
    print(f"$ python -m repro_torch.experiments {shown}  ({seconds:.3f} s)", flush=True)
    if proc.returncode != 0:
        print(proc.stdout, end="", flush=True)
        print(proc.stderr, file=sys.stderr, flush=True)
        raise AssertionError(f"`{shown}` exited with {proc.returncode}")
    return proc.stdout, seconds


def phase_experiments(smi_line: str) -> dict:
    """The paper's §5 evaluation and the rest of the experiments layer on the
    port alone, on the host, each verb in a subprocess into a directory under
    `build/`: `paper` at its twelve seeds (exit 0, so `claims: REPRODUCED`,
    and its report the one the CPU test pins, line for line); `regimes
    --quick` (the atlas's 120-cell sub-grid, plus one serving profile so the
    serve report is written) with min(8, cores) workers, its reports and
    markdown under `build/`, then again into the same cache, which must
    simulate nothing; `explain heavy_tail 20x2 --export` against the atlas's
    cache, both Chrome traces loading as JSON; `faults --list` and `serve
    --list`; and the two event engines side by side
    (`scripts/bench_torch_sim.py --quick`), which fails unless every
    scenario both engines ran has parity.  The repo's EXPERIMENTS.md must be
    untouched."""
    import importlib.util
    import shutil

    t_phase = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    d = ROOT / "build" / "experiments"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    experiments_md = (ROOT / "EXPERIMENTS.md").read_bytes() \
        if (ROOT / "EXPERIMENTS.md").exists() else None
    seconds = {}

    out, seconds["paper"] = run_verb(["paper", "--cache", d / "paper-cache"], env)
    print(out, end="", flush=True)
    if out != PAPER_REPORT + "\n":
        got, want = out.splitlines(), PAPER_REPORT.splitlines()
        diff = [(i, w, g) for i, (w, g) in enumerate(zip(want, got)) if w != g]
        raise AssertionError(f"the paper report differs from the pinned one: "
                             f"{len(got)} lines vs {len(want)}, first differences {diff[:3]}")

    workers = min(8, os.cpu_count() or 1)
    atlas = ["regimes", "--quick", "--workers", str(workers), "--serve", ATLAS_SERVE,
             "--cache", d / "atlas-cache", "--out", d / "regimes.json",
             "--serve-out", d / "serve_regimes.json", "--markdown", d / "atlas.md"]
    out, seconds["regimes_quick"] = run_verb(atlas, env)
    print(out, end="", flush=True)
    fresh = (f"2 paired seeds/cell; {ATLAS_CELLS} simulated, 0 cached",
             f"2 paired seeds/cell; {ATLAS_SERVE_CELLS} simulated, 0 cached")
    if not all(x in out for x in fresh):
        raise AssertionError(f"the quick atlas did not simulate {ATLAS_CELLS} + "
                             f"{ATLAS_SERVE_CELLS} fresh cells")
    report = json.loads((d / "regimes.json").read_text())
    serve_report = json.loads((d / "serve_regimes.json").read_text())
    md = (d / "atlas.md").read_text()
    if len(report["cells"]) != 10 or len(serve_report["cells"]) != 2 or \
            "| regime |" not in md or "serve:table:start" not in md:
        raise AssertionError("the atlas's reports or markdown are not what the verb writes")
    out, seconds["regimes_quick_cached"] = run_verb(atlas, env)
    cached = (f"0 simulated, {ATLAS_CELLS} cached", f"0 simulated, {ATLAS_SERVE_CELLS} cached")
    if not all(x in out for x in cached):
        print(out, end="", flush=True)
        raise AssertionError("the second atlas run into the same cache simulated cells")
    print(out.splitlines()[0], flush=True)

    out, seconds["explain"] = run_verb(["explain", *EXPLAIN_CELL, "--cache", d / "atlas-cache",
                                        "--export", d / "explain"], env)
    print(out, end="", flush=True)
    traces = sorted((d / "explain").glob("*.chrome.json"))
    if len(traces) != 2 or not all(json.loads(p.read_text())["traceEvents"] for p in traces):
        raise AssertionError(f"explain exported {len(traces)} Chrome traces")
    stored = sorted((d / "atlas-cache").rglob("*.trace.json"))
    if not stored:
        raise AssertionError("explain stored no summary beside the atlas's records")

    for verb in (["faults", "--list"], ["serve", "--list"]):
        out, seconds[verb[0] + "_list"] = run_verb(verb, env)
        if out.count("\n") < 5:
            raise AssertionError(f"`{' '.join(verb)}` printed {out!r}")

    spec = importlib.util.spec_from_file_location(
        "bench_torch_sim", ROOT / "scripts" / "bench_torch_sim.py")
    bench_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench_mod)
    t0 = time.perf_counter()
    engines = bench_mod.bench(quick=True)
    seconds["bench_torch_sim"] = time.perf_counter() - t0
    (d / "bench_torch_sim.json").write_text(json.dumps(engines, indent=2) + "\n")
    print(bench_mod.format_report(engines), flush=True)
    both = {n: r["parity"] for n, r in engines["scenarios"].items() if r["parity"] is not None}
    if not both or not all(both.values()):
        raise AssertionError(f"the two event engines disagree: {both}")

    if experiments_md is not None and (ROOT / "EXPERIMENTS.md").read_bytes() != experiments_md:
        raise AssertionError("the experiments phase changed the repo's EXPERIMENTS.md")
    seconds["phase"] = time.perf_counter() - t_phase
    for key, s in seconds.items():
        print(f"experiments: {key} {s:.3f} s on the host ({smi_line})", flush=True)
    result = {
        "seconds": seconds, "workers": workers, "cpu_count": os.cpu_count(),
        "paper": {"seeds": 12, "claims": "REPRODUCED", "rc": 0},
        "atlas": {"cells": ATLAS_CELLS, "serve_cells": ATLAS_SERVE_CELLS,
                  "verdicts": {f"{c['preset']}/{c['shape']}": [c["verdict"], c["adaptive_verdict"]]
                               for c in report["cells"]}},
        "explain": {"cell": EXPLAIN_CELL, "chrome_traces": len(traces)},
        "engines": {n: {"indexed_events_per_sec": r["indexed"]["events_per_sec"],
                        "legacy_events_per_sec": r["legacy"]["events_per_sec"]
                        if "legacy" in r else None,
                        "events": r["indexed"]["events"], "parity": r["parity"]}
                    for n, r in engines["scenarios"].items()},
        "nvidia_smi": smi_line}
    emit("experiments", **result)
    return result


def phase_parallel() -> dict:
    """The multi-rank layer on one rank of NCCL (see PARALLEL_ARCH): (a) the
    mesh train step against the plain one, in turns, counting the kernels of
    the mesh runs (K1 and K1b must launch, each as `expected_launches`
    says); (b) attn_sm's row layout against K1 on the heads layout; (c)
    `pipeline_apply` with one stage against `reference_apply`; (d)
    `compressed_psum` over a full fp32 gradient tree, every element within
    half its block's scale."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.launch.train import train
    from repro_torch.models import attn_sm, transformer
    from repro_torch.models.common import get_model, tree_leaves
    from repro_torch.models.layers import attention
    from repro_torch.checkpoint.layout import stack_layers
    from repro_torch.parallel import activations as A
    from repro_torch.parallel.compression import (_blockify, compressed_psum,
                                                  quantize_int8, wire_bytes_ratio)
    from repro_torch.parallel.pipeline import pipeline_apply, reference_apply
    from repro_torch.parallel.sharding import PartitionSpec as P, shard_batch

    t_phase = time.perf_counter()
    store = tempfile.mkdtemp(prefix="pg-", dir=ROOT / "build")
    dist.init_process_group("nccl", init_method=f"file://{store}/store",
                            rank=0, world_size=1)
    result = {"world_size": 1, "backend": "nccl", "mesh": {"data": 1, "model": 1}}
    try:
        # (a) the launcher's train, mesh and plain, in turns
        cfg = get_config(PARALLEL_ARCH)
        runs = {"mesh": [], "plain": []}
        counts = cuda_kernels = None
        for _ in range(PARALLEL_TURNS):
            for path in ("plain", "mesh"):
                release()
                reset_op_counts()
                before = cuda_kernel_counts()
                out = train(cfg, steps=PARALLEL_STEPS, seq=PROMPT_LEN, batch=BATCH,
                            lr=PARALLEL_LR, device="cuda",
                            data_axis=1 if path == "mesh" else None)
                if path == "mesh":
                    counts, cuda_kernels = op_counts(), cuda_kernels_since(before)
                    on_mesh = type(tree_leaves(out["params"])[0]).__name__
                runs[path].append({"losses": out["losses"],
                                   "step_ms": [t * 1e3 for t in out["step_s"][1:]],
                                   "peak_memory_bytes": torch.cuda.max_memory_allocated()})
                del out
        expected, want = expected_launches(cfg, PARALLEL_STEPS)
        if counts != expected or cuda_kernels != want or on_mesh != "DTensor":
            raise AssertionError(f"the mesh run launched {counts} ({cuda_kernels}), "
                                 f"expected {expected} and {want}; params {on_mesh}")
        plain, mesh = runs["plain"][0]["losses"], runs["mesh"][0]["losses"]
        rel = [abs(a - b) / abs(b) for a, b in zip(mesh, plain)]
        ms = {k: float(np.median([t for r in v for t in r["step_ms"]]))
              for k, v in runs.items()}
        result["train"] = {
            "arch": PARALLEL_ARCH, "layers": cfg.num_layers, "dtype": "bfloat16",
            "batch": BATCH, "seq": PROMPT_LEN, "steps": PARALLEL_STEPS,
            "turns": PARALLEL_TURNS, "lr": PARALLEL_LR,
            "losses_mesh": mesh, "losses_plain": plain,
            "step1_rel": rel[0], "step2_rel": rel[1],
            "ms_per_step_mesh": ms["mesh"], "ms_per_step_plain": ms["plain"],
            "mesh_over_plain": ms["mesh"] / ms["plain"],
            "step_ms_mesh": [r["step_ms"] for r in runs["mesh"]],
            "step_ms_plain": [r["step_ms"] for r in runs["plain"]],
            "peak_memory_bytes_mesh": max(r["peak_memory_bytes"] for r in runs["mesh"]),
            "peak_memory_bytes_plain": max(r["peak_memory_bytes"] for r in runs["plain"]),
            "launches_by_kernel": counts, "cuda_kernel_launches": cuda_kernels}
        emit("parallel_train", **result["train"])
        if rel[0] >= PARALLEL_STEP1_TOL or rel[1] >= PARALLEL_STEP2_TOL or \
                any(not math.isfinite(x) for x in mesh + plain):
            raise AssertionError(f"mesh losses {mesh} against plain {plain}")

        # (b) attn_sm's row layout on K1 against K1 on the heads layout
        release()
        mesh11 = make_test_mesh(1, 1)
        A.set_activation_sharding(dp="data", dp_size=1, tp="model", tp_size=1,
                                  mesh=mesh11)
        B, Hq, Hkv, S, _, D = PARALLEL_ATTN_SHAPE
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        q, k, v = (torch.randn((B, h, S, D), generator=gen, device="cuda",
                               dtype=torch.bfloat16) for h in (Hq, Hkv, Hkv))
        dq, dk, dv = (shard_batch(x, P("data"), mesh11) for x in (q, k, v))
        reset_op_counts()
        rows = attn_sm.flash_attention_shard_map(dq, dk, dv, True, None).to_local()
        launches = op_counts()["flash_attention_fwd"]
        heads = attention(get_config("llama3.2-3b"), q, k, v, causal=True)
        err = (rows.float() - heads.float()).abs().max().item()
        scale = heads.float().abs().max().item()
        rows_ms = time_ms(lambda: attn_sm.flash_attention_shard_map(
            dq, dk, dv, True, None), 10)
        heads_ms = time_ms(lambda: attention(get_config("llama3.2-3b"), q, k, v,
                                             causal=True), 10)
        result["attn_sm"] = {"shape": list(PARALLEL_ATTN_SHAPE), "rows": B * Hq,
                             "max_abs_err": err, "rel_err": err / scale,
                             "bitwise_equal": bool(torch.equal(rows, heads)),
                             "k1_launches": launches, "rows_ms": rows_ms,
                             "heads_ms": heads_ms}
        emit("parallel_attn_sm", **result["attn_sm"])
        A.clear()
        if err / scale >= TOL[torch.bfloat16] or launches != 1:
            raise AssertionError(f"attn_sm rows against heads: {result['attn_sm']}")
        del q, k, v, dq, dk, dv, rows, heads

        # (c) one pipeline stage over every layer of PARALLEL_ARCH
        release()
        params = get_model(cfg).init(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                                     "cuda")
        stacked = stack_layers(cfg, params)["layers"]
        del params
        x = torch.randn((PARALLEL_MICRO, 1, PROMPT_LEN, cfg.d_model), generator=gen,
                        device="cuda").to(cfg.compute_dtype)

        def layer_fn(lp, h):
            return transformer.layer_fwd(cfg, lp, h, None)[0]

        with torch.no_grad():
            reset_op_counts()
            t0 = time.perf_counter()
            piped = pipeline_apply(layer_fn, stacked, x, group=dist.group.WORLD)
            torch.cuda.synchronize()
            pipe_s = time.perf_counter() - t0
            launches = op_counts()["flash_attention_fwd"]
            t0 = time.perf_counter()
            ref = reference_apply(layer_fn, stacked, x)
            torch.cuda.synchronize()
            ref_s = time.perf_counter() - t0
        err = (piped.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        result["pipeline"] = {"stages": 1, "layers": cfg.num_layers,
                              "microbatches": PARALLEL_MICRO, "microbatch": [1, PROMPT_LEN],
                              "max_abs_err": err, "rel_err": err / scale,
                              "k1_launches": launches, "pipeline_s": pipe_s,
                              "reference_s": ref_s}
        emit("parallel_pipeline", **result["pipeline"])
        if err / scale >= TOL[torch.bfloat16] or \
                launches != cfg.num_layers * PARALLEL_MICRO:
            raise AssertionError(f"pipeline against reference: {result['pipeline']}")
        del stacked, x, piped, ref

        # (d) int8 compression of a full fp32 gradient tree
        release()
        params = get_model(cfg).init(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                                     "cuda")
        _, grads = loss_and_grads(cfg, params, _train_batch(cfg))
        del params
        grads = [g.float() for g in grads]
        n_bytes = sum(g.numel() * 4 for g in grads)
        worst = 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for g in grads:
            summed, residual = compressed_psum(g, dist.group.WORLD,
                                               torch.zeros_like(g))
            blocks, _, pad = _blockify(g)
            _, scale = quantize_int8(g)
            err = _blockify(summed - g)[0].abs()
            worst = max(worst, (err / (0.5 * scale[:, None])).max().item())
            del summed, residual, blocks, err
        torch.cuda.synchronize()
        comp_s = time.perf_counter() - t0
        result["compression"] = {"leaves": len(grads), "fp32_bytes": n_bytes,
                                 "wire_bytes_ratio": wire_bytes_ratio(),
                                 "worst_err_over_half_scale": worst,
                                 "seconds": comp_s}
        emit("parallel_compression", **result["compression"])
        if worst > 1.0 + 1e-5:
            raise AssertionError(f"an element off by more than half its block's "
                                 f"scale: {worst}")
        del grads
    finally:
        A.clear()
        dist.destroy_process_group()
    result["seconds"] = time.perf_counter() - t_phase
    emit("parallel", seconds=result["seconds"])
    return result


class FleetClock:
    """``time.perf_counter`` less the seconds ``exclude`` was told of: the
    fleet's clock of training steps alone."""

    def __init__(self):
        self.excluded = 0.0

    def __call__(self) -> float:
        return time.perf_counter() - self.excluded

    def exclude(self, seconds: float) -> None:
        self.excluded += seconds


def _seen_grads(opt) -> list:
    """The gradient Adam saw at the first step, read back from the first
    moments: m = (1 - b1) g."""
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim import AdamWConfig
    return [m / (1 - AdamWConfig().b1) for m in tree_leaves(opt["m"])]


def phase_fleet() -> dict:
    """The elastic fleet on the card (see FLEET_ARCH): (a) one job's
    data-parallel step at widths 1, 2 and 4 from one state and batch: the
    loss and every leaf of the gradient Adam saw within bf16 2e-2 of width
    1's (relative to its max); (b) three jobs through FleetScheduler with
    host 1 failed mid-run, every save kept (a copy on the card) and every
    restore compared with it bit for bit, K1 and K1b counted over the fleet's steps
    (each step's microbatches: the width when it divides the batch, else 1;
    2 L forwards a microbatch under remat "full", L backwards); (c)
    examples/train_100m_torch.py --preset 100m on the card."""
    sys.path.insert(0, str(ROOT / "examples"))
    import deadline_fleet_torch as ex
    import train_100m_torch
    from repro_torch.checkpoint.ckpt import _leaves
    from repro_torch.configs import get_config
    from repro_torch.elastic import ChipPool, FleetJob, FleetScheduler
    from repro_torch.elastic import fleet as fleet_mod
    from repro_torch.launch.mesh import ChipMesh

    from repro_torch.optim import AdamWConfig

    def fleet_opt(steps):
        return AdamWConfig(**TRAIN_OPT, total_steps=steps)

    t_phase = time.perf_counter()
    cfg = get_config(FLEET_ARCH).replace(num_layers=FLEET_LAYERS)
    devices = ex.chip_devices("cuda")
    if any(d.type != "cuda" for d in devices):
        raise AssertionError(f"the fleet's chips are not on the card: {devices}")
    result = {"arch": FLEET_ARCH, "layers": FLEET_LAYERS,
              "cut": f"depth {FLEET_LAYERS} of {get_config(FLEET_ARCH).num_layers} layers",
              "dtype": "bfloat16", "batch": BATCH, "seq": PROMPT_LEN,
              "chips": [str(d) for d in devices], "chips_per_host": 4}

    # (a) one step at each width from the same params and batch
    release()
    widths, base = {}, None
    for width in (1,) + FLEET_WIDTHS:
        make_step = ex.make_job_factory(1, 8, cfg, seq=PROMPT_LEN, batch=BATCH,
                                        opt_cfg=fleet_opt(8))
        step, state, place = make_step(ChipMesh(devices[:width]))
        state = step(state)
        loss = float(make_step.losses[-1])
        seen = _seen_grads(state["opt"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = step(state)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        if base is None:
            base = (loss, seen)
            rel = {"loss": 0.0, "grads": 0.0}
        else:
            rel = {"loss": abs(loss - base[0]) / abs(base[0]),
                   "grads": max(((a.float() - b.float()).abs().max()
                                 / b.float().abs().max().clamp_min(1e-30)).item()
                                for a, b in zip(seen, base[1]))}
        widths[width] = {"loss": loss, "rel_err": rel, "second_step_s": step_s}
        del step, state, seen, make_step
        release()
    base = None
    result["widths"] = widths
    emit("fleet_widths", **{f"width_{w}": v for w, v in widths.items()})
    for width, w in widths.items():
        if not (w["rel_err"]["loss"] < TOL[torch.bfloat16]
                and w["rel_err"]["grads"] < TOL[torch.bfloat16]):
            raise AssertionError(f"width {width} against width 1: {w}")
    t1 = widths[1]["second_step_s"]

    # (b) the fleet
    clock = FleetClock()
    pool = ChipPool(devices, chips_per_host=4)
    root = tempfile.mkdtemp(prefix="fleet-", dir=ROOT / "build")
    fleet = FleetScheduler(pool, root, clock=clock)
    split = {"save": [], "rebuild": [], "restore": []}
    kept, restores, grants, resizes, step_widths = {}, [], [], [], []
    orig_save, orig_restore = fleet_mod.save_checkpoint, fleet_mod.restore_checkpoint
    orig_match, orig_resize = pool.match, fleet._resize
    orig_failure = fleet.handle_host_failure

    def timed_save(ck, step, tree):
        t_keep = time.perf_counter()
        # what a restore must give back: a copy on the card, compared there
        kept[str(ck)] = (step, {k: v.detach().clone() for k, v in _leaves(tree)})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig_save(ck, step, tree)
        dt = time.perf_counter() - t0
        split["save"].append(dt)
        clock.exclude(time.perf_counter() - t_keep)
        return out

    def checked_restore(ck, step, template, device):
        t0 = time.perf_counter()
        out = orig_restore(ck, step, template, device)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        split["restore"].append(dt)
        saved_step, saved = kept[str(ck)]
        leaves = dict(_leaves(out))
        equal = (saved_step == step and leaves.keys() == saved.keys()
                 and all(same_bits(leaves[k], saved[k]) for k in saved))
        restores.append({"job": Path(ck).name, "step": step, "leaves": len(saved),
                         "bit_equal": equal, "seconds": dt})
        clock.exclude(time.perf_counter() - t0)
        if not equal:
            raise AssertionError(f"the restore of {ck} step {step} is not what was saved")
        return out

    def counted_match():
        got = orig_match()
        grants.extend(got)
        return got

    def recorded_resize(job, new_chips):
        resizes.append({"job": job.job_id, "from": len(job.chips), "to": len(new_chips)})
        return orig_resize(job, new_chips)

    def timed_factory(make_step):
        def build(mesh):
            t0 = time.perf_counter()
            step, state, place = make_step(mesh)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            split["rebuild"].append(dt)
            clock.exclude(dt)
            width = len(mesh.devices)

            def counted_step(st):
                step_widths.append(width)
                return step(st)
            return counted_step, state, place
        build.losses = make_step.losses
        return build

    recovery = []

    def timed_failure(host):
        t0 = time.perf_counter()
        orig_failure(host)
        recovery.append(time.perf_counter() - t0)

    fleet_mod.save_checkpoint, fleet_mod.restore_checkpoint = timed_save, checked_restore
    pool.match, fleet._resize = counted_match, recorded_resize
    fleet.handle_host_failure = timed_failure
    try:
        release()
        reset_op_counts()
        before = cuda_kernel_counts()
        t_run = time.perf_counter()
        for seed, (name, steps) in enumerate(FLEET_STEPS.items(), start=1):
            fleet.submit(FleetJob(
                name, deadline=FLEET_DEADLINE_X[name] * steps * t1, total_steps=steps,
                make_step=timed_factory(ex.make_job_factory(
                    seed, steps, cfg, seq=PROMPT_LEN, batch=BATCH,
                    opt_cfg=fleet_opt(steps))),
                preferred_hosts=(FLEET_HOSTS[name],), min_chips=1))
        ex.run_with_failure(fleet, FLEET_FAIL_HOST, lambda: fleet.jobs["job-urgent"].done,
                            rebalance_every=3, ckpt_every=FLEET_CKPT_EVERY,
                            max_ticks=600)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t_run
        counts, cuda_kernels = op_counts(), cuda_kernels_since(before)
    finally:
        fleet_mod.save_checkpoint, fleet_mod.restore_checkpoint = orig_save, orig_restore
        shutil.rmtree(root, ignore_errors=True)
    micro = sum(w if BATCH % w == 0 else 1 for w in step_widths)
    expected = {"flash_attention_fwd": 2 * FLEET_LAYERS * micro,
                "flash_attention_bwd": FLEET_LAYERS * micro}
    jobs = {}
    for j in fleet.jobs.values():
        losses = [float(x) for x in j.make_step.losses]
        took = j.finished_at - j.submitted_at
        jobs[j.job_id] = {"steps": j.step, "total_steps": j.total_steps,
                          "deadline_s": j.deadline, "took_s": took,
                          "met": took <= j.deadline, "resizes": j.resizes,
                          "losses": losses}
    n_resize = len(resizes)
    result["fleet"] = {
        "steps_run": len(step_widths), "step_widths": step_widths,
        "warm_step_s": t1, "events": fleet.events, "resizes": resizes,
        "grants": [list(g) for g in grants],
        "reconfigurations": pool.reconfigurations, "dead_hosts": sorted(pool.dead_hosts),
        "jobs": jobs,
        "seconds_a_resize": {k: sum(v) / len(v) if v else None for k, v in split.items()},
        "seconds_save": split["save"], "seconds_rebuild": split["rebuild"],
        "seconds_restore": split["restore"], "restores": restores,
        "recovery_s": recovery, "run_s": run_s, "clock_excluded_s": clock.excluded,
        "launches_by_kernel": {k: counts[k] for k in expected},
        "expected_launches": expected, "cuda_kernel_launches": cuda_kernels}
    emit("fleet_run", **result["fleet"])
    problems = []
    if not any(r["to"] > r["from"] for r in resizes):
        problems.append("no job grew")
    if not grants:
        problems.append("no grant through ChipPool.match")
    if not any("FAILED; affected=" in e for e in fleet.events) or \
            not any(e.startswith("recovered") for e in fleet.events):
        problems.append("no host failure and recovery")
    if not restores or not all(r["bit_equal"] for r in restores):
        problems.append("no restore, or one not bit-equal")
    for name, j in jobs.items():
        if j["steps"] != j["total_steps"] or \
                not all(math.isfinite(x) for x in j["losses"]) or \
                not j["losses"][-1] < j["losses"][0]:
            problems.append(f"{name}: steps or losses {j['steps']} {j['losses']}")
    if {k: counts[k] for k in expected} != expected or \
            not cuda_kernels.get("fa_fwd_wgmma") or not cuda_kernels.get("fa_bwd_dq_wgmma"):
        problems.append(f"launches {counts} ({cuda_kernels}), expected {expected}")
    if problems:
        raise AssertionError(f"the fleet phase: {problems} (resizes: {n_resize})")
    del fleet, pool, kept
    release()

    # (c) examples/train_100m_torch.py on the card
    ckpt = tempfile.mkdtemp(prefix="train100m-", dir=ROOT / "build")
    try:
        out = train_100m_torch.main([*TRAIN_100M_ARGS, "--ckpt-dir", ckpt])
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    result["train_100m"] = {k: out[k] for k in ("params", "steps", "start",
                                                "tokens_per_s", "seconds", "eq10")}
    result["train_100m"]["first_loss"], result["train_100m"]["last_loss"] = \
        out["losses"][0], out["losses"][-1]
    emit("fleet_train_100m", **result["train_100m"])
    if not all(math.isfinite(x) for x in out["losses"]) or \
            not out["losses"][-1] < out["losses"][0]:
        raise AssertionError(f"train_100m losses {out['losses'][:3]} ... {out['losses'][-3:]}")
    result["seconds"] = time.perf_counter() - t_phase
    emit("fleet", seconds=result["seconds"])
    return result


class Tee:
    """A stream that also writes everything to the log."""

    def __init__(self, stream, log):
        self.stream, self.log = stream, log

    def write(self, text):
        self.log.write(text)
        self.log.flush()
        return self.stream.write(text)

    def flush(self):
        self.log.flush()
        self.stream.flush()

    def __getattr__(self, name):
        return getattr(self.stream, name)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (without the package: fail before any output)
    # the whole log, for runs whose output is read only to its end
    LOG.parent.mkdir(parents=True, exist_ok=True)
    log = open(LOG, "w")
    sys.stdout, sys.stderr = Tee(sys.stdout, log), Tee(sys.stderr, log)
    from repro_torch.configs import get_config
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products in full fp32
    smi_line = phase_env()
    phase_build(verbose="--verbose-build" in sys.argv[1:])
    k1, k1_d80, k1_later, k1_d128, k1_mla = phase_kernels()
    k2 = phase_ssd_kernels()
    k2b = phase_ssd_bwd_kernels()
    release()
    k4 = phase_adamw()
    release()
    phase_mapreduce()
    release()
    sur = phase_surrogate()
    cal = phase_calibration()
    phase_experiments(smi_line)
    serves = {}
    for arch in SERVE_ARCHS:
        release()
        serves[arch] = phase_serve(arch)
    release()
    window = phase_mixtral_window()
    for arch in PARITY_ARCHS:
        release()
        phase_parity_on_card(arch)
    k1b, k1b_d80, k1b_d128, k1b_mla = phase_attention_bwd()
    trained = {}
    for arch in TRAIN_ARCHS:
        release()
        trained[arch] = phase_train(arch)
        release()
        phase_train_parity_on_card(arch)
        # the MoE archs' bf16 kernel and dense paths may choose other experts
        # for some tokens (the router rounds its probabilities to bf16), and
        # their gradients would then belong to two routings: the fp32 parity
        # holds them, with equal routing
        if get_config(arch).family != "moe":
            release()
            phase_train_parity_bf16(arch)
    release()
    phase_checkpoint()
    release()
    par = phase_parallel()
    release()
    fleet = phase_fleet()

    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.ssd_scan import kernel as ssd
    # one row per TPU kernel, and one for each backward (the JAX package's
    # blocked jnp attention backward, and jax.grad through its chunked scan:
    # hand-written kernels here); `launches` counts calls of the op on the
    # main path (the forwards': in one prefill; the backwards': in the timed
    # train steps); `variant` and `cuda_kernels_per_call` are what the C
    # function counted one call launch at the main path's shape (the SSD
    # scan's wgmma variant: the state pass, then the outputs; the attention
    # backward's: dQ with delta, then dK/dV; the scan's backward: the state
    # recurrences, the column and the row owners, ddt, the sums); K1 and K1b
    # also at stablelm-3b's head dim 80, with the launches of its paths;
    # `launches_later_families` the same counts on the paths of Qwen2-VL,
    # Zamba2, Whisper, DeepSeek-V2-Lite and Mixtral, and `later_families`
    # the timings at their shapes (Mixtral's past its window with the
    # launches of the windowed prefill);
    # `launches_dense_head_dim_128` the counts on llama3.2-3b's and
    # nemotron-4-15b's paths (nemotron-4-15b is not trained; K1b's also on
    # mixtral-8x22b's, whose training shape is nemotron-4-15b's), and K1's
    # and K1b's `dense_head_dim_128` the timings at their shapes; the
    # `_mla` rows are K1 and K1b at DeepSeek's MLA head dims (q·k 192, v
    # 128: other instances of the same CUDA kernels), timed at its shape,
    # their launches those of deepseek-v2-lite-16b's prefill and timed
    # train steps
    def served(arch, op):
        return serves[arch]["launches_by_kernel"][op]

    def train_launches(arch, op):
        return trained[arch]["launches_by_kernel"][op]

    later_archs = ("qwen2-vl-2b", "zamba2-1.2b", "whisper-large-v3",
                   "deepseek-v2-lite-16b", "mixtral-8x22b")
    d128_archs = ("llama3.2-3b", "nemotron-4-15b")
    at_d128 = {"flash_attention_fwd": k1_d128, "flash_attention_bwd": k1b_d128}
    at_d80 = {"flash_attention_fwd": (k1_d80, served("stablelm-3b", "flash_attention_fwd")),
              "flash_attention_bwd": (k1b_d80, train_launches("stablelm-3b",
                                                              "flash_attention_bwd"))}
    rows = []
    for name, source, replaces, numbers, launches, later_launches, d128_launches in (
            ("flash_attention_fwd", fa.SOURCE,
             "src/repro/kernels/flash_attention/kernel.py:32", k1,
             served("tinyllama-1.1b", "flash_attention_fwd"),
             {a: served(a, "flash_attention_fwd") for a in later_archs},
             {a: served(a, "flash_attention_fwd") for a in d128_archs}),
            ("ssd_scan_fwd", ssd.SOURCE, "src/repro/kernels/ssd_scan/kernel.py:27",
             k2, served("mamba2-1.3b", "ssd_scan_fwd"),
             {a: served(a, "ssd_scan_fwd") for a in later_archs},
             {a: served(a, "ssd_scan_fwd") for a in d128_archs}),
            ("flash_attention_bwd", fa.SOURCE_BWD, "src/repro/models/flash.py:197",
             k1b, train_launches("tinyllama-1.1b", "flash_attention_bwd"),
             {a: train_launches(a, "flash_attention_bwd") for a in later_archs},
             {a: train_launches(a, "flash_attention_bwd") for a in k1b_d128}),
            ("ssd_scan_bwd", ssd.SOURCE_BWD, "src/repro/models/mamba2.py:42",
             k2b, train_launches("mamba2-1.3b", "ssd_scan_bwd"),
             {a: train_launches(a, "ssd_scan_bwd") for a in later_archs},
             {a: train_launches(a, "ssd_scan_bwd") for a in d128_archs
              if a in TRAIN_ARCHS})):
        rows.append({
            "name": name,
            "route": "cuda",
            "source": str(source.relative_to(ROOT)),
            "replaces": replaces,
            "launches": launches,
            "max_abs_err": numbers["max_abs_err"],
            "ms": numbers["kernel_ms"],
            "plain_ms": numbers["plain_ms"],
            "bound_ms": numbers["bound_ms"],
            "bound_by": numbers["bound_by"],
            "library_ms": numbers["library_ms"],
            "variant": numbers["variant"],
            "cuda_kernels_per_call": numbers["cuda_kernels_per_call"],
            "launches_later_families": later_launches,
            "launches_dense_head_dim_128": d128_launches,
        })
        if name.startswith("ssd"):   # the fp32-pipe variant, timed in turns
            rows[-1]["earlier_variant"] = numbers["earlier_variant"]
            rows[-1]["earlier_ms"] = numbers["earlier_ms"]
        if name in at_d80:
            d80, launches = at_d80[name]
            rows[-1]["head_dim_80"] = {
                "shape": d80["shape"], "variant": d80["variant"],
                "ms": d80["kernel_ms"], "earlier_ms": d80["earlier_ms"],
                "library_ms": d80["library_ms"], "bound_ms": d80["bound_ms"],
                "launches": launches}
        if name in at_d128:
            rows[-1]["dense_head_dim_128"] = {
                arch: {"shape": t["shape"], "variant": t["variant"], "ms": t["kernel_ms"],
                       "plain_ms": t["plain_ms"], "library_ms": t["library_ms"],
                       "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                       "max_abs_err": t["max_abs_err"], "launches": d128_launches.get(arch)}
                for arch, t in at_d128[name].items()}
        timed_later = k1_later if name == "flash_attention_fwd" else \
            numbers.get("later_families", {})
        if timed_later:
            rows[-1]["later_families"] = {
                key: {"shape": t["shape"], "causal": t.get("causal"),
                      **({"window": t["window"]} if t.get("window") else {}),
                      "variant": t["variant"], "ms": t["kernel_ms"],
                      "plain_ms": t["plain_ms"], "library_ms": t["library_ms"],
                      "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                      "max_abs_err": t["max_abs_err"],
                      **({"earlier_variant": t["earlier_variant"],
                          "earlier_ms": t["earlier_ms"]} if name.startswith("ssd") else {})}
                for key, t in timed_later.items()}
        if name == "flash_attention_fwd":
            rows[-1]["later_families"]["mixtral-8x22b window"]["launches"] = \
                window["launches_by_kernel"]["flash_attention_fwd"]
        if name.startswith("flash_attention"):
            # the parallel phase's mesh train runs (counts set to 0 before
            # each, these from the last)
            rows[-1]["launches_parallel_mesh_train"] = \
                par["train"]["launches_by_kernel"][name]
            # the fleet phase's steps (counts set to 0 before its run)
            rows[-1]["launches_fleet"] = \
                fleet["fleet"]["launches_by_kernel"][name]
    for name, source, replaces, numbers, launches in (
            ("flash_attention_fwd_mla", fa.SOURCE,
             "src/repro/kernels/flash_attention/kernel.py:32", k1_mla,
             served("deepseek-v2-lite-16b", "flash_attention_fwd")),
            ("flash_attention_bwd_mla", fa.SOURCE_BWD, "src/repro/models/flash.py:197",
             k1b_mla, train_launches("deepseek-v2-lite-16b", "flash_attention_bwd"))):
        rows.append({
            "name": name, "route": "cuda",
            "source": str(source.relative_to(ROOT)), "replaces": replaces,
            "launches": launches, "max_abs_err": numbers["max_abs_err"],
            "ms": numbers["kernel_ms"], "plain_ms": numbers["plain_ms"],
            "bound_ms": numbers["bound_ms"], "bound_by": numbers["bound_by"],
            "library_ms": numbers["library_ms"],
            "library_v_padded_to": numbers["library_v_padded_to"],
            "library_padded_ms": numbers["library_padded_ms"],
            "library_backend": numbers.get("library_backend"),
            "variant": numbers["variant"],
            "cuda_kernels_per_call": numbers["cuda_kernels_per_call"],
            "shape": numbers["shape"]})
    # the fluid surrogate's scan (jnp in the JAX package, a kernel here):
    # launches on the bench grid (the rule's variant, fluid_scan_warp, by the
    # C count); ms / plain_ms / bound_ms on one 64-cell sub-batch of it, with
    # fluid_scan_block in turns as the earlier variant; the grid's launch and
    # a calibration bucket of 64 jobs alike
    from repro_torch.kernels.fluid_scan import kernel as fluid
    g, t = sur["grid"], sur["timings"]

    def timed(place):
        x = t[place]
        return {"cells": x["cells"], "bucket": x["bucket"], "variant": x["variant"],
                "ms": x["ms"][x["variant"]], "earlier_variant": "fluid_scan_block",
                "earlier_ms": x["ms"]["fluid_scan_block"], "plain_ms": x["plain_ms"],
                "bound_ms": x["bound_ms"], "bound_by": x["bound_by"]}

    s = timed("subbatch")
    rows.append({
        "name": "fluid_scan", "route": "cuda",
        "source": str(fluid.SOURCE.relative_to(ROOT)),
        "replaces": "src/repro/simcluster/surrogate.py:405",
        "launches": g["launches"], "max_abs_err": sur["max_abs_err"],
        "ms": s["ms"], "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
        "bound_by": s["bound_by"], "library_ms": None,
        "variant": g["variant"],
        "cuda_kernels_per_call": g["cuda_kernel_launches"][g["variant"]] // g["launches"],
        "earlier_variant": s["earlier_variant"], "earlier_ms": s["earlier_ms"],
        "shape": {"cells": s["cells"], "padded_jobs": s["bucket"][0],
                  "horizon_steps": s["bucket"][1]},
        "grid": {**timed("grid"), "ms_in_run_surrogate": g["kernel_ms"],
                 "launches": g["launches"], "steps_integrated": g["steps_integrated_max"],
                 "us_per_integrated_step": g["us_per_integrated_step"]},
        "calibration_64": timed("calibration_64"),
        "launches_calibration": {
            "launches": cal["launches"], "cuda_kernel_launches": cal["cuda_kernel_launches"],
            "buckets": cal["buckets"], "variant": cal["variant"]}})
    # K4 (the JAX package's jnp AdamW; a pair of kernels here): timed at the
    # training cell's leaf set; launches those of the timed train steps,
    # each arch's (the update's; the norm's as many)
    from repro_torch.kernels.adamw import kernel as k4_kernel
    rows.append({
        "name": "adamw", "route": "cuda",
        "source": str(k4_kernel.SOURCE.relative_to(ROOT)),
        "replaces": "src/repro/optim/adamw.py:52",
        "launches": {a: t["adamw_launches"]["adamw_update"] for a, t in trained.items()},
        "leaves": {a: t["leaves"] for a, t in trained.items()},
        "ms": k4["ms"], "kernels_ms": k4["kernels_ms"], "step_ms": k4["step_ms"],
        "plain_ms": k4["plain_ms"], "bound_ms": k4["bound_ms"], "bound_by": k4["bound_by"],
        "library_ms": k4["library_ms"], "library_refused": k4["library_refused"],
        "variant": "adamw_sumsq + adamw_update", "cuda_kernels_per_call": 2,
        "shape": {"arch": k4["arch"], "layers": k4["layers"], "leaves": k4["leaves"],
                  "params": k4["params"]}})
    print(json.dumps({"kernels": rows}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
