"""Quickstart of the PyTorch/CUDA port: train a tiny llama-family model for a
few steps.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu] [--steps N]

Runs on the CUDA card unless ``--device cpu`` asks for the CPU.
"""
import argparse
import time

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.data import DataConfig, ShardedDataset, make_batch_iter
from repro_torch.launch.steps import make_train_step
from repro_torch.models.common import get_model, param_count, resolve_device
from repro_torch.optim import AdamWConfig, adamw_init


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    steps = args.steps
    cfg = get_smoke_config("llama3.2-3b").replace(num_layers=4, d_model=256,
                                                  n_heads=8, n_kv_heads=4,
                                                  d_ff=512)
    model = get_model(cfg)
    params = model.init(cfg, torch.Generator(device=device).manual_seed(0), device)
    print(f"model: {param_count(params)/1e6:.1f}M params "
          f"({cfg.num_layers}L d={cfg.d_model}) on {device}")

    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=128, global_batch=8,
                      num_shards=16)
    ds = ShardedDataset(data, num_hosts=1)
    batches = make_batch_iter(ds, hosts=[0])

    opt_cfg = AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=steps)
    opt = adamw_init(params)
    step = make_train_step(cfg, opt_cfg, grad_accum=1)

    t0 = time.time()
    for i in range(steps):
        batch = {k: torch.from_numpy(v).long().to(device)
                 for k, v in next(batches).items()}
        params, opt, metrics = step(params, opt, batch)
        if i % 5 == 0 or i == steps - 1:
            print(f"step {i:3d}  loss {float(metrics['loss']):.4f}")
    dt = time.time() - t0
    toks = steps * data.global_batch * data.seq_len
    print(f"done: {dt:.1f}s  ({toks/dt:.0f} tok/s on {device})")


if __name__ == "__main__":
    main()
