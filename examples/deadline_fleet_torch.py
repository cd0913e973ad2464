"""Deadline-driven elastic fleet demo on the port — the paper's scheduler
running a multi-job "pod" of chips.

Three tiny training jobs with different deadlines share 8 chips (2 hosts x 4):
  * the Eq.-10 estimator sizes each job's chip demand from measured step
    times and the time left to its deadline;
  * chips move between jobs through the per-host Assign/Release queues
    (Algorithm 1), with checkpoint -> rebuild -> restore standing in for
    vCPU hot-plug;
  * after --fail-after seconds a host "dies": its chips vanish and the
    affected jobs recover from their last checkpoint on the remaining chips.

    PYTHONPATH=src python examples/deadline_fleet_torch.py [--device cpu]

The chips are dealt round robin over the visible devices of the chosen type:
on one card all eight are logical chips of ``cuda:0``, and with ``--device
cpu`` all eight are the CPU.  That is the one-card counterpart of the JAX
package's eight fake CPU devices; a job on several chips of one device runs
its batch shards one after another there.  Without a card the default
``--device cuda`` raises: nothing falls back to the CPU unasked.
"""
import argparse
import tempfile
import time
from typing import Callable, Optional, Sequence

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.data import DataConfig, ShardedDataset, make_batch_iter
from repro_torch.elastic import ChipPool, FleetJob, FleetScheduler
from repro_torch.launch.steps import loss_and_grads, make_train_step
from repro_torch.models.common import (ModelConfig, get_model, resolve_device,
                                       tree_map, tree_unflatten)
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

CHIPS, CHIPS_PER_HOST = 8, 4


def tiny_config() -> ModelConfig:
    """The JAX package's demo model: tinyllama's smoke config cut to two
    layers of width 128."""
    return get_smoke_config("tinyllama-1.1b").replace(
        num_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256)


def chip_devices(device: str = "cuda", chips: int = CHIPS) -> list:
    """``chips`` devices of the type of ``device``, dealt round robin over
    the visible ones (every chip the CPU for ``cpu``)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev] * chips
    n = torch.cuda.device_count()
    return [torch.device("cuda", i % n) for i in range(chips)]


def data_parallel_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                       devices: Sequence[torch.device], batch_rows: int):
    """step(params, opt, batch) -> (params, opt, {"loss"}) on a job's chips,
    the JAX package's step with params replicated and the batch over
    ``"data"`` when the width divides it (else whole, as ``P()``): the batch
    splits into one row shard a chip, each shard's loss and gradients run
    on its chip's device, and the fp32 gradients are summed on the first
    chip and divided by the width before one ``adamw_update``.  The params
    and the batch live on the first chip's device.  Where every chip is the
    same device that is ``make_train_step(..., grad_accum=width)``."""
    width = len(devices)
    shards = width if batch_rows % width == 0 else 1
    if len(set(devices)) == 1:
        return make_train_step(cfg, opt_cfg, grad_accum=shards)
    place, devices = devices[0], list(devices)[:shards]

    def step(params, opt, batch):
        rows = batch_rows // shards
        grads, loss = None, torch.zeros((), device=place)
        for i, dev in enumerate(devices):
            local = params if dev == place else tree_map(lambda t: t.to(dev), params)
            lm, gm = loss_and_grads(cfg, local, {k: v[i * rows:(i + 1) * rows].to(dev)
                                                 for k, v in batch.items()})
            gm = [g.float().to(place) for g in gm]
            grads = gm if grads is None else [a + g for a, g in zip(grads, gm)]
            loss = loss + lm.float().to(place)
        grads = tree_unflatten(params, [g / shards for g in grads])
        params, opt = adamw_update(opt_cfg, params, grads, opt)
        return params, opt, {"loss": loss / shards}

    return step


def make_job_factory(seed: int, steps: int, cfg: Optional[ModelConfig] = None, *,
                     seq: int = 64, batch: int = 8,
                     opt_cfg: Optional[AdamWConfig] = None,
                     init: Optional[Callable] = None):
    """The job's ``make_step(mesh) -> (step_fn, state, place)``: params from
    ``seed`` (or ``init(seed, device)``), AdamW (the JAX package's demo
    recipe unless ``opt_cfg``), a data-parallel step over the mesh's chips
    (``data_parallel_step``), and synthetic batches of the shards on host
    ``seed % 2``.  Every step's loss (a device tensor) is appended to
    ``make_step.losses``."""
    cfg = cfg or tiny_config()
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
                      num_shards=16, seed=seed)
    batches = make_batch_iter(ShardedDataset(data, num_hosts=2), hosts=[seed % 2])
    opt_cfg = opt_cfg or AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=steps)

    def make_step(mesh):
        place = mesh.devices[0]
        params = (init(seed, place) if init is not None else get_model(cfg).init(
            cfg, torch.Generator(device=place).manual_seed(seed), place))
        inner = data_parallel_step(cfg, opt_cfg, mesh.devices, batch)

        def step(state):
            b = {k: torch.from_numpy(v).long().to(place)
                 for k, v in next(batches).items()}
            p, o, m = inner(state["params"], state["opt"], b)
            make_step.losses.append(m["loss"].detach())
            return {"params": p, "opt": o}

        return step, {"params": params, "opt": adamw_init(params)}, place

    make_step.losses = []
    return make_step


def submit_demo_jobs(fleet: FleetScheduler, steps: int,
                     deadlines=(150.0, 300.0, 600.0), **factory_kw) -> None:
    """The JAX package's three jobs: urgent (host 0), mid and lazy (host 1,
    half the steps)."""
    for (name, host, n), deadline, seed in zip(
            (("job-urgent", 0, steps), ("job-mid", 1, steps),
             ("job-lazy", 1, steps // 2)), deadlines, (1, 2, 3)):
        fleet.submit(FleetJob(name, deadline=deadline, total_steps=n,
                              make_step=make_job_factory(seed, steps, **factory_kw),
                              preferred_hosts=(host,), min_chips=1))


def run_with_failure(fleet: FleetScheduler, fail_host: int,
                     should_fail: Callable[[], bool], **run_kw) -> None:
    """``fleet.run`` with host ``fail_host`` failed at the first rebalance
    where ``should_fail()`` holds."""
    failed = False
    orig_rebalance = fleet.rebalance

    def rebalance_with_failure():
        nonlocal failed
        if not failed and should_fail():
            failed = True
            fleet.handle_host_failure(fail_host)
        orig_rebalance()

    fleet.rebalance = rebalance_with_failure
    try:
        fleet.run(**run_kw)
    finally:
        fleet.rebalance = orig_rebalance


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--fail-host", type=int, default=1)
    ap.add_argument("--fail-after", type=float, default=6.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, to run on the CPU on purpose")
    args = ap.parse_args(argv)

    pool = ChipPool(chip_devices(args.device), chips_per_host=CHIPS_PER_HOST)
    with tempfile.TemporaryDirectory(prefix="fleet_") as root:
        fleet = FleetScheduler(pool, root)
        submit_demo_jobs(fleet, args.steps)
        t0 = time.monotonic()
        run_with_failure(fleet, args.fail_host,
                         lambda: time.monotonic() - t0 > args.fail_after,
                         rebalance_every=3, ckpt_every=4, max_ticks=600)

    print("\n== fleet events ==")
    for e in fleet.events:
        print("  ", e)
    print("\n== job summary ==")
    ok = True
    for j in fleet.jobs.values():
        took = (j.finished_at or time.monotonic()) - j.submitted_at
        met = took <= j.deadline
        ok &= j.done
        losses = j.make_step.losses
        print(f"  {j.job_id:10s} steps={j.step}/{j.total_steps} "
              f"took={took:5.1f}s deadline={j.deadline:.0f}s "
              f"met={met} resizes={j.resizes} "
              f"loss {float(losses[0]):.4f} -> {float(losses[-1]):.4f}")
    print(f"\nreconfigurations={pool.reconfigurations} dead_hosts={sorted(pool.dead_hosts)}")
    assert ok, "not all jobs finished"
    print("OK")


if __name__ == "__main__":
    main()
