"""Training launcher of the port: a dense, Qwen2-VL (text-only batches),
Mamba-2 or Zamba2 architecture on one device; Whisper (family ``encdec``),
whose loss needs its frontend's frame embeddings, is refused, as the
reference's launcher refuses it.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --preset smoke --steps 50 --deadline 1800 [--device cuda|cpu] \\
        [--ckpt-dir DIR --ckpt-every 50]

Runs on the CUDA card unless ``--device cpu`` asks for the CPU.  Random
weights from a seed, synthetic tokens from ``repro_torch.data``.  Prints what
the JAX package's launcher prints: the loss and ms/step every 10 steps with
the paper's Eq.-10 minimum device count for the deadline (the fleet
controller consumes the same signal), then tokens/s and the data locality.

With ``--ckpt-dir`` it resumes from the latest checkpoint there, saves
params and AdamW state every ``--ckpt-every`` steps and after the last, in
the JAX package's layout and format (``repro_torch.checkpoint``), so either
package resumes the other's run.  As in the JAX package's launcher, the
data iterator restarts at its first batch on resume.  A data-parallel mesh
(``--data-axis``) comes with ROADMAP M12.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import torch

from repro_torch.checkpoint import (AsyncCheckpointer, from_jax_train_state,
                                   latest_step, restore_checkpoint,
                                   to_jax_train_state)
from repro_torch.configs import ALL_ARCHS, get_config, get_smoke_config
from repro_torch.data import DataConfig, ShardedDataset, make_batch_iter
from repro_torch.elastic.fleet import EstimatorBridge
from repro_torch.launch.steps import make_train_step
from repro_torch.models.common import (ModelConfig, get_model, param_count,
                                       resolve_device, tree_map)
from repro_torch.optim import AdamWConfig, adamw_init


def train(cfg: ModelConfig, *, steps: int, seq: int, batch: int,
          grad_accum: int = 1, lr: float = 1e-3, deadline: float = 3600.0,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
          device="cuda") -> Dict:
    """Train ``cfg`` up to step ``steps`` with AdamW steps of ``batch`` x
    ``seq`` tokens; with ``ckpt_dir``, from its latest checkpoint, saving at
    each step ``i > 0`` that ``ckpt_every`` divides and at ``steps``.

    Returns {"start", "losses", "step_s", "tokens_per_s", "locality",
    "params", "opt"}: the step it started from, each step's loss and seconds
    (host clock around a step that ends when its loss reaches the host).
    Family ``encdec`` is refused."""
    if cfg.family == "encdec":
        raise SystemExit("use a seq2seq driver for whisper (see examples)")
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

    ck = AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    start = (latest_step(ckpt_dir) or 0) if ckpt_dir else 0
    if start:
        meta = tree_map(lambda t: t.to("meta"), {"params": params, "opt": opt})
        template = to_jax_train_state(cfg, meta["params"], meta["opt"])
        params, opt = from_jax_train_state(
            cfg, restore_checkpoint(ckpt_dir, start, template, device))
        print(f"[train] restored step {start}")

    t_run = time.time()
    times, losses = [], []
    for i in range(start, steps):
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
        if ck and i and i % ckpt_every == 0:
            ck.save(i, to_jax_train_state(cfg, params, opt))
    if ck:
        ck.save(steps, to_jax_train_state(cfg, params, opt))
        ck.wait()
    tokens_per_s = (steps - start) * batch * seq / (time.time() - t_run)
    print(f"[train] done: {tokens_per_s:.0f} tok/s, "
          f"data locality {ds.locality_rate():.0%}")
    return {"start": start, "losses": losses, "step_s": times,
            "tokens_per_s": tokens_per_s, "locality": ds.locality_rate(),
            "params": params, "opt": opt}


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
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, to run on the CPU on purpose")
    args = ap.parse_args(argv)
    cfg = (get_smoke_config(args.arch) if args.preset == "smoke"
           else get_config(args.arch))
    train(cfg, steps=args.steps, seq=args.seq, batch=args.batch,
          grad_accum=args.grad_accum, lr=args.lr, deadline=args.deadline,
          ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, device=args.device)


if __name__ == "__main__":
    main()
