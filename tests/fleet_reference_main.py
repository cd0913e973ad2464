"""Subprocess body for tests/test_torch_fleet.py: the JAX package's elastic
fleet and its data-parallel step on eight fake CPU devices, on parameters the
test wrote, dumped for the port to be held against.  Run with
XLA_FLAGS=--xla_force_host_platform_device_count=8:

    python tests/fleet_reference_main.py IN_DIR OUT_DIR

IN_DIR holds ``config.json`` (steps, deadlines, the rebalance at which host 1
fails, widths) and ``params_<seed>.npz`` for seeds 1, 2 and 3 (the JAX
layout, "/"-joined keys).  OUT_DIR gets ``fleet.json`` (events, each job's
step, resizes and chips, reconfigurations), ``final_<job>.npz`` (each job's
final params) and ``dp_<width>.npz`` (the loss and the gradient Adam saw,
m / (1 - b1), after one step of the job factory's step at that width).

The job factory is ``examples/deadline_fleet.py``'s with the parameters the
test gives it in place of ``model.init`` and fp32 in place of bf16."""
import itertools
import json
import os
import sys
import tempfile
from pathlib import Path

assert "--xla_force_host_platform_device_count=8" in os.environ.get("XLA_FLAGS", "")

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from repro.configs import get_smoke_config
from repro.data import DataConfig, ShardedDataset, make_batch_iter
from repro.elastic import ChipPool, FleetJob, FleetScheduler
from repro.launch.steps import make_train_step
from repro.optim import AdamWConfig, adamw_init


def tiny_config():
    return get_smoke_config("tinyllama-1.1b").replace(
        num_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        param_dtype=jnp.float32, compute_dtype=jnp.float32)


def unflatten(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = value
    return tree


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten(v, key))
        else:
            out[key] = np.asarray(v, np.float32)
    return out


def make_job_factory(seed, steps, cfg, params0):
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=8,
                      num_shards=16, seed=seed)
    ds = ShardedDataset(data, num_hosts=2)
    batches = make_batch_iter(ds, hosts=[seed % 2])
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=steps)

    def make_step(mesh):
        params = jax.tree_util.tree_map(jnp.asarray, params0)
        opt = adamw_init(params)
        inner = make_train_step(cfg, opt_cfg, grad_accum=1)
        sharding = NamedSharding(mesh, P())
        ndev = mesh.devices.size
        bshard = NamedSharding(mesh, P("data") if data.global_batch % ndev == 0
                               else P())

        def step(state):
            batch = next(batches)
            b = {k: jax.device_put(jnp.asarray(v), bshard)
                 for k, v in batch.items()}
            p, o, m = jax.jit(inner)(state["params"], state["opt"], b)
            return {"params": p, "opt": o}

        state = {"params": jax.device_put(params, sharding),
                 "opt": jax.device_put(opt, sharding)}
        shardings = jax.tree_util.tree_map(lambda _: sharding, state)
        return step, state, shardings

    make_step.batches = batches
    make_step.opt_cfg = opt_cfg
    return make_step


def run_fleet(conf, cfg, params, out: Path) -> None:
    clock_ticks = itertools.count()
    pool = ChipPool(jax.devices(), chips_per_host=4)
    with tempfile.TemporaryDirectory(prefix="fleet_ref_") as root:
        fleet = FleetScheduler(pool, root, clock=lambda: next(clock_ticks) * 1.0)
        steps = conf["steps"]
        for (name, host, n), deadline, seed in zip(
                (("job-urgent", 0, steps), ("job-mid", 1, steps),
                 ("job-lazy", 1, steps // 2)), conf["deadlines"], (1, 2, 3)):
            fleet.submit(FleetJob(name, deadline=deadline, total_steps=n,
                                  make_step=make_job_factory(seed, steps, cfg,
                                                             params[seed]),
                                  preferred_hosts=(host,), min_chips=1))
        rebalances = itertools.count(1)
        orig = fleet.rebalance

        def rebalance_with_failure():
            if next(rebalances) == conf["fail_at_rebalance"]:
                fleet.handle_host_failure(1)
            orig()

        fleet.rebalance = rebalance_with_failure
        fleet.run(rebalance_every=3, ckpt_every=4, max_ticks=600)
    jobs = {j.job_id: {"step": j.step, "resizes": j.resizes, "chips": j.chips}
            for j in fleet.jobs.values()}
    (out / "fleet.json").write_text(json.dumps({
        "events": fleet.events, "jobs": jobs,
        "reconfigurations": pool.reconfigurations}))
    for j in fleet.jobs.values():
        np.savez(out / f"final_{j.job_id}.npz", **flatten(j.state["params"]))


def run_dp(conf, cfg, params, out: Path) -> None:
    """One step of the factory's jitted step on a mesh of each width, from
    seed 1's params, on its first batch."""
    for width in conf["widths"]:
        make_step = make_job_factory(1, conf["steps"], cfg, params[1])
        mesh = Mesh(np.array(jax.devices()[:width]), ("data",))
        step, state, _ = make_step(mesh)
        batch = next(make_step.batches)
        ndev = width
        bshard = NamedSharding(mesh, P("data") if 8 % ndev == 0 else P())
        b = {k: jax.device_put(jnp.asarray(v), bshard) for k, v in batch.items()}
        inner = make_train_step(cfg, make_step.opt_cfg, grad_accum=1)
        _, opt, metrics = jax.jit(inner)(state["params"], state["opt"], b)
        b1 = make_step.opt_cfg.b1
        seen = jax.tree_util.tree_map(lambda m: np.asarray(m) / (1 - b1), opt["m"])
        np.savez(out / f"dp_{width}.npz", loss=np.float32(metrics["loss"]),
                 **flatten(seen))


def main() -> None:
    src, out = Path(sys.argv[1]), Path(sys.argv[2])
    conf = json.loads((src / "config.json").read_text())
    cfg = tiny_config()
    params = {}
    for seed in (1, 2, 3):
        with np.load(src / f"params_{seed}.npz") as z:
            params[seed] = unflatten({k: z[k] for k in z.files})
    run_dp(conf, cfg, params, out)
    run_fleet(conf, cfg, params, out)


if __name__ == "__main__":
    main()
