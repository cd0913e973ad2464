"""Training launcher of the port: a dense architecture on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --preset smoke --steps 50 --deadline 1800 [--device cuda|cpu]

Runs on the CUDA card unless ``--device cpu`` asks for the CPU.  Random
weights from a seed, synthetic tokens from ``repro_torch.data``.  Prints what
the JAX package's launcher prints: the loss and ms/step every 10 steps with
the paper's Eq.-10 minimum device count for the deadline (the fleet
controller consumes the same signal), then tokens/s and the data locality.
Checkpoints (``--ckpt-dir``) come with the port's checkpoint module (ROADMAP
M11) and a data-parallel mesh (``--data-axis``) with M12; the Mamba-2 family
trains once the SSD scan has its backward kernel.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import torch

from repro_torch.configs import ALL_ARCHS, get_config, get_smoke_config
from repro_torch.data import DataConfig, ShardedDataset, make_batch_iter
from repro_torch.elastic.fleet import EstimatorBridge
from repro_torch.launch.steps import make_train_step
from repro_torch.models.common import (ModelConfig, get_model, param_count,
                                       resolve_device)
from repro_torch.optim import AdamWConfig, adamw_init


def train(cfg: ModelConfig, *, steps: int, seq: int, batch: int,
          grad_accum: int = 1, lr: float = 1e-3, deadline: float = 3600.0,
          device="cuda") -> Dict:
    """Train ``cfg`` for ``steps`` AdamW steps of ``batch`` x ``seq`` tokens.

    Returns {"losses", "step_s", "tokens_per_s", "locality", "params"}:
    each step's loss and seconds (host clock around a step that ends when its
    loss reaches the host)."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"training family {cfg.family!r} is not ported yet: the port trains "
            "the dense family; Mamba-2 training comes with the SSD scan's "
            "backward kernel")
    device = resolve_device(device)
    model = get_model(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    params = model.init(cfg, gen, device)
    opt = adamw_init(params)
    print(f"[train] {cfg.arch} ({param_count(params)/1e6:.1f}M params) on 1 "
          f"device ({device})")

    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=batch, num_shards=64)
    ds = ShardedDataset(data, num_hosts=1)
    batches = make_batch_iter(ds, hosts=[0])
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=min(20, steps // 5 + 1),
                          total_steps=steps)
    step_fn = make_train_step(cfg, opt_cfg, grad_accum=grad_accum)

    t_run = time.time()
    times, losses = [], []
    for i in range(steps):
        b = {k: torch.from_numpy(v).long().to(device)
             for k, v in next(batches).items()}
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, b)
        losses.append(float(metrics["loss"]))      # waits for the step
        times.append(time.perf_counter() - t0)
        if i % 10 == 0 or i == steps - 1:
            t_step = sum(times[-10:]) / len(times[-10:])
            chips = EstimatorBridge.demand(
                max(steps - i - 1, 1), t_step, 1,
                deadline - (time.time() - t_run), total_chips=256)
            print(f"step {i:4d} loss {losses[-1]:.4f} "
                  f"({t_step*1e3:.0f} ms/step, Eq.10 min-chips={chips})")
    tokens_per_s = steps * batch * seq / (time.time() - t_run)
    print(f"[train] done: {tokens_per_s:.0f} tok/s, "
          f"data locality {ds.locality_rate():.0%}")
    return {"losses": losses, "step_s": times, "tokens_per_s": tokens_per_s,
            "locality": ds.locality_rate(), "params": params}


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=ALL_ARCHS)
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--deadline", type=float, default=3600.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, to run on the CPU on purpose")
    args = ap.parse_args(argv)
    cfg = (get_smoke_config(args.arch) if args.preset == "smoke"
           else get_config(args.arch))
    train(cfg, steps=args.steps, seq=args.seq, batch=args.batch,
          grad_accum=args.grad_accum, lr=args.lr, deadline=args.deadline,
          device=args.device)


if __name__ == "__main__":
    main()
