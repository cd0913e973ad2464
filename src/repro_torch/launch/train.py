"""Training launcher of the port: a dense, Qwen2-VL (text-only batches),
Mamba-2, Zamba2 or MoE (Mixtral, DeepSeek) architecture on one device or on
a data-parallel mesh of ranks; Whisper (family ``encdec``),
whose loss needs its frontend's frame embeddings, is refused, as the
reference's launcher refuses it.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --preset smoke --steps 50 --deadline 1800 [--device cuda|cpu] \\
        [--ckpt-dir DIR --ckpt-every 50]

    torchrun --nproc-per-node N -m repro_torch.launch.train --data-axis N ...

Runs on the CUDA card unless ``--device cpu`` asks for the CPU.  Random
weights from a seed, synthetic tokens from ``repro_torch.data``.  Prints what
the JAX package's launcher prints: the loss and ms/step every 10 steps with
the paper's Eq.-10 minimum device count for the deadline (the fleet
controller consumes the same signal), then tokens/s and the data locality.

With ``--ckpt-dir`` it resumes from the latest checkpoint there, saves
params and AdamW state every ``--ckpt-every`` steps and after the last, in
the JAX package's layout and format (``repro_torch.checkpoint``), so either
package resumes the other's run.  As in the JAX package's launcher, the
data iterator restarts at its first batch on resume.

``--data-axis N`` trains on a (data=N, model=1) mesh of N ranks, FSDP when
N > 1 (``parallel.sharding``): under ``torchrun`` one rank a card with NCCL,
or gloo ranks with ``--device cpu``; without ``torchrun`` only N = 1, a
one-rank group.  N must be the number of ranks, and on the card at most the
cards there are: anything else raises, nothing falls back to one device.
Every rank draws the same global batch and keeps its rows; rank 0 prints.
A checkpoint is gathered to full tensors and written by rank 0 in the same
format, so a mesh run and a one-device run (of either package) resume each
other; on restore each rank keeps its shards.
"""
from __future__ import annotations

import argparse
import os
import tempfile
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
from repro_torch.parallel.activations import clear, set_activation_sharding
from repro_torch.parallel.sharding import (ShardingPolicy, distribute_params,
                                           gather_params, make_param_specs)


def _init_ranks(device: torch.device, store_dir: str) -> bool:
    """A process group for the mesh: ``torchrun``'s (env://) or, without it,
    one rank of this process, its store a file in ``store_dir``.  True when
    this call created it."""
    import torch.distributed as dist
    if dist.is_initialized():
        return False
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, init_method=f"file://{store_dir}/store",
                                rank=0, world_size=1)
    return True


def _mesh_for(dp: int, device: torch.device):
    """The (data=dp, model=1) mesh over every rank; raises unless there are
    exactly ``dp`` ranks (and, on the card, at least ``dp`` cards)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_test_mesh
    world = dist.get_world_size()
    if dp != world:
        raise ValueError(f"--data-axis {dp} needs {dp} ranks, there are {world} "
                         f"(torchrun --nproc-per-node {dp})")
    if device.type == "cuda" and dp > torch.cuda.device_count():
        raise ValueError(f"--data-axis {dp} needs {dp} cards, there are "
                         f"{torch.cuda.device_count()}")
    return make_test_mesh(dp, 1)


def train(cfg: ModelConfig, *, steps: int, seq: int, batch: int,
          grad_accum: int = 1, lr: float = 1e-3, deadline: float = 3600.0,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
          device="cuda", data_axis: Optional[int] = None) -> Dict:
    """Train ``cfg`` up to step ``steps`` with AdamW steps of ``batch`` x
    ``seq`` tokens; with ``ckpt_dir``, from its latest checkpoint, saving at
    each step ``i > 0`` that ``ckpt_every`` divides and at ``steps``.

    ``data_axis``: the size of the data axis of a (data, 1) mesh, FSDP
    above 1, over the process group the caller initialised, ``torchrun``'s,
    or a one-rank group made here; 0 or None: every rank under ``torchrun``,
    else one device and no mesh.

    Returns {"start", "losses", "step_s", "tokens_per_s", "locality",
    "params", "opt", "dp"}: the step it started from, each step's loss and
    seconds (host clock around a step that ends when its loss reaches the
    host), and the data-parallel width; on a mesh ``params`` and ``opt`` are
    DTensors.  Family ``encdec`` is refused."""
    import torch.distributed as dist
    if cfg.family == "encdec":
        raise SystemExit("use a seq2seq driver for whisper (see examples)")
    device = resolve_device(device)
    on_mesh = bool(data_axis) or "WORLD_SIZE" in os.environ
    if not on_mesh:
        return _train(cfg, steps=steps, seq=seq, batch=batch, grad_accum=grad_accum,
                      lr=lr, deadline=deadline, ckpt_dir=ckpt_dir,
                      ckpt_every=ckpt_every, device=device, mesh=None)
    if device.type == "cuda" and "LOCAL_RANK" in os.environ:
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    with tempfile.TemporaryDirectory(prefix="repro_torch_pg_") as store_dir:
        created = _init_ranks(device, store_dir)
        try:
            mesh = _mesh_for(data_axis or dist.get_world_size(), device)
            return _train(cfg, steps=steps, seq=seq, batch=batch,
                          grad_accum=grad_accum, lr=lr, deadline=deadline,
                          ckpt_dir=ckpt_dir, ckpt_every=ckpt_every, device=device,
                          mesh=mesh)
        finally:
            clear()
            if created:
                dist.destroy_process_group()


def _train(cfg: ModelConfig, *, steps, seq, batch, grad_accum, lr, deadline,
           ckpt_dir, ckpt_every, device, mesh) -> Dict:
    model = get_model(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    params = model.init(cfg, gen, device)
    meta = tree_map(lambda t: t.to("meta"), params)     # a restore's template
    dp, rank0, pspecs = 1, True, None
    if mesh is not None:
        dp = mesh.size(0)
        rank0 = mesh.get_rank() == 0
        pol = ShardingPolicy(fsdp=dp > 1)
        set_activation_sharding(dp="data", dp_size=dp, tp="model", tp_size=1,
                                mesh=mesh, fsdp=pol.fsdp_entry())
        pspecs = make_param_specs(cfg, params, mesh, pol)
        params = distribute_params(params, pspecs, mesh)
    log = print if rank0 else (lambda *a, **k: None)
    opt = adamw_init(params)
    n = param_count(params)
    if mesh is None:
        log(f"[train] {cfg.arch} ({n/1e6:.1f}M params) on 1 device ({device})")
    else:
        log(f"[train] {cfg.arch} ({n/1e6:.1f}M params) on {dp} device(s)")

    hosts = max(dp // 4, 1)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=batch, num_shards=64)
    ds = ShardedDataset(data, num_hosts=hosts)
    batches = make_batch_iter(ds, hosts=list(range(hosts)))
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=min(20, steps // 5 + 1),
                          total_steps=steps)
    step_fn = make_train_step(cfg, opt_cfg, grad_accum=grad_accum,
                              dp_entry=None if mesh is None else "data",
                              grad_specs=pspecs)

    def state_to_save():
        if mesh is None:
            return to_jax_train_state(cfg, params, opt)
        full = gather_params({"params": params, "opt": opt})
        return to_jax_train_state(cfg, full["params"], full["opt"]) if rank0 else None

    ck = AsyncCheckpointer(ckpt_dir) if ckpt_dir and rank0 else None
    start = (latest_step(ckpt_dir) or 0) if ckpt_dir else 0
    if start:
        template = to_jax_train_state(cfg, meta, adamw_init(meta))
        params, opt = from_jax_train_state(
            cfg, restore_checkpoint(ckpt_dir, start, template, device))
        if mesh is not None:            # each rank keeps its shards
            params = distribute_params(params, pspecs, mesh)
            opt = {"m": distribute_params(opt["m"], pspecs, mesh),
                   "v": distribute_params(opt["v"], pspecs, mesh), "step": opt["step"]}
        log(f"[train] restored step {start}")

    t_run = time.time()
    times, losses = [], []
    for i in range(start, steps):
        b = {k: torch.from_numpy(v).long().to(device)
             for k, v in next(batches).items()}
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, b)
        loss = metrics["loss"]
        losses.append(float(loss.full_tensor() if mesh is not None else loss))
        times.append(time.perf_counter() - t0)       # the loss waited for the step
        if i % 10 == 0 or i == steps - 1:
            t_step = sum(times[-10:]) / len(times[-10:])
            chips = EstimatorBridge.demand(
                max(steps - i - 1, 1), t_step, dp,
                deadline - (time.time() - t_run), total_chips=256)
            log(f"step {i:4d} loss {losses[-1]:.4f} "
                f"({t_step*1e3:.0f} ms/step, Eq.10 min-chips={chips})")
        if ckpt_dir and i and i % ckpt_every == 0:
            state = state_to_save()
            if ck:
                ck.save(i, state)
    if ckpt_dir:
        state = state_to_save()
        if ck:
            ck.save(steps, state)
            ck.wait()
    tokens_per_s = (steps - start) * batch * seq / (time.time() - t_run)
    log(f"[train] done: {tokens_per_s:.0f} tok/s, "
        f"data locality {ds.locality_rate():.0%}")
    return {"start": start, "losses": losses, "step_s": times,
            "tokens_per_s": tokens_per_s, "locality": ds.locality_rate(),
            "params": params, "opt": opt, "dp": dp}


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
    ap.add_argument("--data-axis", type=int, default=0,
                    help="data-parallel size (0 = every rank; without "
                         "torchrun, one device and no mesh)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, to run on the CPU on purpose")
    args = ap.parse_args(argv)
    cfg = (get_smoke_config(args.arch) if args.preset == "smoke"
           else get_config(args.arch))
    train(cfg, steps=args.steps, seq=args.seq, batch=args.batch,
          grad_accum=args.grad_accum, lr=args.lr, deadline=args.deadline,
          ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, device=args.device,
          data_axis=args.data_axis)


if __name__ == "__main__":
    main()
