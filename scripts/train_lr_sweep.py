#!/usr/bin/env python3
"""How the port's first AdamW steps move the loss of an arch (tinyllama-1.1b
unless ``--arch`` names another that takes token batches).

    PYTHONPATH=src python3 scripts/train_lr_sweep.py [--arch A] [--steps N]

Needs one CUDA card.  Full width and depth, bf16, remat "full", batch 8 x
sequence 1024, random weights from seed 0 and the first batch of the
synthetic pipeline, repeated.  Prints one JSON line each: the bf16 loss and
gradients of the kernel path against the dense path (relative error per
leaf: the largest and the median), then the loss after every step for each
(attention path, lr, warm-up steps of the schedule) and once with fp32
weights.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch

from repro_torch.configs import get_config
from repro_torch.data import DataConfig, ShardedDataset, make_batch_iter
from repro_torch.launch.steps import loss_and_grads, make_train_step
from repro_torch.models.common import get_model, resolve_device, tree_map
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.testing import rel_err

RUNS = [("kernel", 1e-5, 0, "bfloat16"), ("dense", 1e-5, 0, "bfloat16"),
        ("kernel", 3e-6, 0, "bfloat16"), ("kernel", 3e-5, 0, "bfloat16"),
        ("kernel", 1e-4, 0, "bfloat16"), ("kernel", 3e-4, 0, "bfloat16"),
        ("kernel", 3e-4, 4, "bfloat16"), ("kernel", 1e-5, 4, "bfloat16"),
        ("kernel", 1e-5, 0, "float32")]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--steps", type=int, default=6)
    args = ap.parse_args()
    device = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    cfg = get_config(args.arch)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=1024, global_batch=8,
                      num_shards=64)
    batch = {k: torch.from_numpy(v).long().to(device) for k, v in
             next(make_batch_iter(ShardedDataset(data, num_hosts=1), hosts=[0])).items()}
    params0 = get_model(cfg).init(cfg, torch.Generator(device=device).manual_seed(0),
                                  device)
    loss_k, grads_k = loss_and_grads(cfg, params0, batch)
    loss_d, grads_d = loss_and_grads(cfg.replace(attn_impl="dense"), params0, batch)
    errs = sorted(rel_err(a, b) for a, b in zip(grads_k, grads_d))
    print(json.dumps({"phase": "bf16_kernel_vs_dense", "arch": args.arch,
                      "nvidia_smi": smi,
                      "loss_kernel": float(loss_k), "loss_dense": float(loss_d),
                      "max_grad_rel_err": errs[-1],
                      "median_grad_rel_err": errs[len(errs) // 2]}), flush=True)
    del grads_k, grads_d
    for impl, lr, warmup, dtype in RUNS:
        c = cfg.replace(attn_impl=impl, param_dtype=dtype)
        # the leaves kept in fp32 whatever the config's type (a Mamba-2
        # block's dt_bias, A_log and D) stay fp32
        params = tree_map(lambda x: x.to(c.param_dtype if x.dtype == cfg.param_dtype
                                         else x.dtype, copy=True), params0)
        opt = adamw_init(params)
        step = make_train_step(c, AdamWConfig(lr=lr, warmup_steps=warmup))
        losses = []
        for _ in range(args.steps):
            params, opt, metrics = step(params, opt, batch)
            losses.append(float(metrics["loss"]))
        print(json.dumps({"phase": "losses", "attn_impl": impl, "lr": lr,
                          "warmup_steps": warmup, "param_dtype": dtype,
                          "losses": losses}), flush=True)
        del params, opt


if __name__ == "__main__":
    main()
