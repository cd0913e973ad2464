"""End-to-end training driver on the port: data pipeline -> train loop ->
deadline estimation -> async checkpointing -> restart recovery.

    PYTHONPATH=src python examples/train_100m_torch.py                  # tiny preset
    PYTHONPATH=src python examples/train_100m_torch.py --preset 100m    # ~100M params, 300 steps

The deadline logic is the paper's Eq. 10 applied at the framework layer:
remaining steps x measured step time vs the completion-time goal decides the
minimum chip count (printed each log interval; on one device it reports what
a pod-scale run would allocate).

Runs on the CUDA card unless ``--device cpu`` asks for the CPU.  Checkpoints
are the JAX package's layout and format (``repro_torch.checkpoint``); with
``--ckpt-dir`` a second run resumes from the latest one there.
"""
import argparse
import tempfile
import time

import torch

from repro_torch.checkpoint import (AsyncCheckpointer, from_jax_train_state,
                                   latest_step, restore_checkpoint,
                                   to_jax_train_state)
from repro_torch.configs import get_smoke_config
from repro_torch.data import DataConfig, ShardedDataset, make_batch_iter
from repro_torch.elastic.fleet import EstimatorBridge
from repro_torch.launch.steps import make_train_step
from repro_torch.models.common import get_model, param_count, resolve_device, tree_map
from repro_torch.optim import AdamWConfig, adamw_init

PRESETS = {
    "tiny": dict(layers=4, d_model=256, heads=8, kv=4, d_ff=1024, seq=128,
                 batch=8, steps=60, vocab=2048),
    "100m": dict(layers=12, d_model=768, heads=12, kv=4, d_ff=2048, seq=512,
                 batch=16, steps=300, vocab=32000),
}


def main(argv=None) -> dict:
    """Train the preset (from the latest checkpoint in ``--ckpt-dir``, if
    any); returns {"params", "start", "steps", "losses", "eq10" (step, loss,
    ms a step, Eq.-10 chips at each log line), "tokens_per_s", "seconds",
    "ckpt_dir"}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=PRESETS)
    ap.add_argument("--deadline", type=float, default=3600.0,
                    help="completion-time goal (s) for the Eq.-10 estimator")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, to run on the CPU on purpose")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    p = PRESETS[args.preset]

    cfg = get_smoke_config("llama3.2-3b").replace(
        num_layers=p["layers"], d_model=p["d_model"], n_heads=p["heads"],
        n_kv_heads=p["kv"], d_ff=p["d_ff"], vocab_size=p["vocab"])
    params = get_model(cfg).init(cfg, torch.Generator(device=device).manual_seed(0),
                                 device)
    n = param_count(params)
    print(f"model: {n/1e6:.1f}M params | preset={args.preset} "
          f"steps={p['steps']} seq={p['seq']} batch={p['batch']} on {device}")

    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=p["seq"],
                      global_batch=p["batch"], num_shards=64)
    ds = ShardedDataset(data, num_hosts=1)
    batches = make_batch_iter(ds, hosts=[0])

    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=p["steps"])
    opt = adamw_init(params)
    step_fn = make_train_step(cfg, opt_cfg, grad_accum=2)

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_100m_")
    ck = AsyncCheckpointer(ckpt_dir)
    start = latest_step(ckpt_dir) or 0
    if start:
        meta = tree_map(lambda t: t.to("meta"), params)
        template = to_jax_train_state(cfg, meta, adamw_init(meta))
        params, opt = from_jax_train_state(
            cfg, restore_checkpoint(ckpt_dir, start, template, device))
        print(f"restored from checkpoint step {start}")

    t_start = time.time()
    step_times, losses, eq10 = [], [], []
    for i in range(start, p["steps"]):
        batch = {k: torch.from_numpy(v).long().to(device)
                 for k, v in next(batches).items()}
        t0 = time.time()
        params, opt, metrics = step_fn(params, opt, batch)
        losses.append(float(metrics["loss"]))       # waits for the step
        step_times.append(time.time() - t0)
        if i % 20 == 0 or i == p["steps"] - 1:
            t_step = sum(step_times[-10:]) / len(step_times[-10:])
            remaining = p["steps"] - i - 1
            time_left = args.deadline - (time.time() - t_start)
            chips = EstimatorBridge.demand(max(remaining, 1), t_step, 1,
                                           time_left, total_chips=256)
            eq10.append((i, losses[-1], t_step * 1e3, chips))
            print(f"step {i:4d} loss {losses[-1]:.4f} "
                  f"t_step {t_step*1e3:.0f}ms | Eq.10 min-chips for "
                  f"deadline: {chips}")
        if i and i % 50 == 0:
            ck.save(i, to_jax_train_state(cfg, params, opt))
    ck.save(p["steps"], to_jax_train_state(cfg, params, opt))
    ck.wait()
    toks = (p["steps"] - start) * p["batch"] * p["seq"]
    dt = time.time() - t_start
    print(f"done in {dt:.0f}s ({toks/dt:.0f} tok/s) | data locality "
          f"{ds.locality_rate():.0%} | ckpt -> {ckpt_dir}")
    return {"params": n, "start": start, "steps": p["steps"], "losses": losses,
            "eq10": eq10, "tokens_per_s": toks / dt, "seconds": dt,
            "ckpt_dir": ckpt_dir}


if __name__ == "__main__":
    main()
