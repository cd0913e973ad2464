"""Multi-rank cases of the port, run on gloo ranks on the CPU: the body of
tests/test_torch_{distributed,attn_sm,pipeline,compression}.py.

    python tests/torch_distributed_main.py CASE IN.pkl OUT.pkl

(tests call ``run_case``, which runs it so).
IN.pkl holds the case's inputs (numpy, made by the test from a seed; the JAX
side is computed there, never here: no rank imports JAX).  The case runs on
``world`` ranks spawned here (``torch.multiprocessing``, one thread each,
joined by a TCP store on a port the system picks: no port is fixed); rank 0
writes OUT.pkl.  Not collected by pytest.
"""
import os

os.environ.setdefault("OMP_NUM_THREADS", "1")

import pickle  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def _np(t):
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    t = t.detach()
    return (t.float() if t.is_floating_point() else t).numpy()


def _set_mesh(data: int, model: int):
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel.activations import set_activation_sharding
    mesh = make_test_mesh(data, model)
    set_activation_sharding(dp="data", dp_size=data, tp="model", tp_size=model,
                            mesh=mesh, fsdp="data" if data > 1 else None)
    return mesh


def _replicated(x, mesh):
    from repro_torch.parallel.sharding import PartitionSpec as P, shard_batch
    return shard_batch(torch.as_tensor(x), P(), mesh)


# -- train: the mesh train step against the one-rank step ---------------------

def case_train(rank, inp):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.adamw import _global_norm
    from repro_torch.parallel.activations import clear
    from repro_torch.parallel.sharding import (ShardingPolicy, distribute_params,
                                               local_shape, make_param_specs,
                                               spec_leaves)
    from repro_torch.testing import from_jax_params
    data, model = inp["mesh"]
    mesh = _set_mesh(data, model)
    out = {}
    for arch, case in inp["archs"].items():
        cfg = get_smoke_config(arch)
        batch = {k: torch.from_numpy(v).long() for k, v in case["batch"].items()}
        opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=0)
        params = from_jax_params(cfg, case["params"], "cpu")
        # one rank, no mesh
        clear()
        one = make_train_step(cfg, opt_cfg, grad_accum=2)
        p1 = tree_map(lambda x: x.clone(), params)
        o1 = adamw_init(p1)
        losses_one = []
        for _ in range(2):
            p1, o1, m = one(p1, o1, batch)
            losses_one.append(float(m["loss"]))
        # the mesh: FSDP over data, TP over model
        mesh = _set_mesh(data, model)
        specs = make_param_specs(cfg, params, mesh, ShardingPolicy(fsdp=True))
        ps = distribute_params(params, specs, mesh)
        # every local shard has the shape its spec gives; count the leaves
        # that are really split
        shapes_ok, sharded = True, 0
        for p, s in zip(tree_leaves(ps), spec_leaves(specs)):
            want = local_shape(p.shape, s, mesh)
            shapes_ok &= tuple(p.to_local().shape) == want
            sharded += want != tuple(p.shape)
        os_ = adamw_init(ps)
        step = make_train_step(cfg, opt_cfg, grad_accum=2, dp_entry="data",
                               grad_specs=specs)
        losses_mesh = []
        for _ in range(2):
            ps, os_, m = step(ps, os_, batch)
            losses_mesh.append(float(m["loss"].full_tensor()))
        # the global norm of a sharded tree (the params: their norm scales,
        # replicated, weigh as much as the sharded weights): replicated
        # leaves once, sharded leaves across their shards
        norm_mesh = float(_global_norm(ps))
        norm_full = float(_global_norm([x.full_tensor() for x in tree_leaves(ps)]))
        out[arch] = {"one": losses_one, "mesh": losses_mesh,
                     "shapes_ok": bool(shapes_ok), "sharded_leaves": sharded,
                     "leaves": len(tree_leaves(ps)),
                     "norm_mesh": norm_mesh, "norm_full": norm_full}
    clear()
    return out


# -- attn_sm: row-parallel attention, and the bh_flat branch ---------------------

def case_attn_sm(rank, inp):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import attn_sm
    from repro_torch.models import layers as L
    from repro_torch.parallel.activations import clear
    mesh = _set_mesh(*inp["mesh"])
    cfg = get_smoke_config("llama3.2-3b")
    calls = {"n": 0}
    real = attn_sm.flash_attention_shard_map

    def counted(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    attn_sm.flash_attention_shard_map = counted
    out = {}
    for causal, window in inp["masks"]:
        routes = {
            "shard_map": lambda q, k, v: attn_sm.flash_attention_shard_map(
                q, k, v, causal, window),
            "row_parallel": lambda q, k, v: L.attention(
                cfg.replace(attn_row_parallel=True), q, k, v, causal=causal,
                window=window),
            "bh_flat": lambda q, k, v: L.attention(
                cfg.replace(attn_impl="bh_flat", attn_row_parallel=False), q, k, v,
                causal=causal, window=window)}
        for name, fn in routes.items():
            q, k, v = (_replicated(inp[n], mesh).requires_grad_() for n in "qkv")
            w = _replicated(inp["w"], mesh)
            before = calls["n"]
            o = fn(q, k, v)
            (o * w).sum().backward()
            out[(causal, window, name)] = {
                "out": _np(o), "dq": _np(q.grad), "dk": _np(k.grad),
                "dv": _np(v.grad), "shard_map_calls": calls["n"] - before}
    clear()
    return out


# -- moe: the shard_map MoE layer ----------------------------------------------

def case_moe(rank, inp):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import moe as M
    from repro_torch.parallel.activations import clear
    from repro_torch.parallel.sharding import (ShardingPolicy, PartitionSpec as P,
                                               distribute_params, make_param_specs,
                                               shard_batch)
    mesh = _set_mesh(*inp["mesh"])
    out = {}
    for arch, case in inp["archs"].items():
        cfg = get_smoke_config(arch)
        p = {k: (torch.from_numpy(v) if not isinstance(v, dict) else
                 {kk: torch.from_numpy(vv) for kk, vv in v.items()})
             for k, v in case["params"].items()}
        specs = make_param_specs(cfg, p, mesh, ShardingPolicy(fsdp=True))
        ps = distribute_params(p, specs, mesh)
        leaves = {k: v for k, v in ps.items() if k != "shared"}
        for v in leaves.values():
            v.requires_grad_()
        x = shard_batch(torch.from_numpy(case["x"]), P("data"), mesh).requires_grad_()
        w = shard_batch(torch.from_numpy(case["w"]), P("data"), mesh)
        from torch.distributed.tensor.experimental import implicit_replication
        with implicit_replication():
            o, aux = M.moe_ffn(cfg, {**ps, **leaves}, x)
            (((o * w).sum()) + 3.0 * aux).backward()
            _, _, kept = M._moe_ffn_shard_map(cfg, leaves, x.detach(), return_kept=True)
        out[arch] = {"out": _np(o), "aux": float(aux.full_tensor()),
                     "kept": _np(kept), "dx": _np(x.grad),
                     "grads": {k: _np(v.grad) for k, v in leaves.items()},
                     "specs": {k: tuple(s) for k, s in specs.items() if k != "shared"},
                     "local": {k: tuple(v.to_local().shape) for k, v in leaves.items()}}
    clear()
    return out


# -- pipeline: GPipe over four stages ------------------------------------------

def case_pipeline(rank, inp):
    from repro_torch.parallel.pipeline import pipeline_apply, reference_apply

    def layer_fn(lp, x):
        return torch.tanh(x @ lp["w"]) + x

    params = {"w": torch.from_numpy(inp["w"])}
    x = torch.from_numpy(inp["x"])
    return {"out": pipeline_apply(layer_fn, params, x).numpy(),
            "ref": reference_apply(layer_fn, params, x).numpy()}


# -- compression: the int8 error-feedback all-reduce ------------------------------

def case_compress(rank, inp):
    from repro_torch.parallel.compression import compressed_psum
    x = torch.from_numpy(inp["x"][rank])
    residual = torch.from_numpy(inp["residual"][rank])
    summed, new_residual = compressed_psum(x, None, residual)
    res = [torch.empty_like(new_residual) for _ in range(dist.get_world_size())]
    dist.all_gather(res, new_residual)
    sums = [torch.empty_like(summed) for _ in range(dist.get_world_size())]
    dist.all_gather(sums, summed)
    return {"summed": [s.numpy() for s in sums], "residual": [r.numpy() for r in res]}


CASES = {"train": case_train, "attn_sm": case_attn_sm, "moe": case_moe,
         "pipeline": case_pipeline, "compress": case_compress}


def _worker(rank, world, port, case, in_path, out_path):
    torch.set_num_threads(1)
    with open(in_path, "rb") as f:
        inp = pickle.load(f)
    store = dist.TCPStore("127.0.0.1", port, world_size=world, is_master=False)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        out = CASES[case](rank, inp)
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_case(case: str, inp: dict, tmp_path: Path, timeout: int = 300) -> dict:
    """For a test: ``inp`` through this script on ``inp["world"]`` gloo
    ranks, in a subprocess -> rank 0's result."""
    import subprocess
    tag = f"{case}_{len(list(tmp_path.glob(case + '_*.in')))}"
    src, dst = tmp_path / f"{tag}.in", tmp_path / f"{tag}.out"
    with open(src, "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(Path(__file__).resolve().parents[1] / "src")
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run([sys.executable, __file__, case, str(src), str(dst)],
                          env=env, capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-3000:])
    with open(dst, "rb") as f:
        return pickle.load(f)


def main() -> None:
    case, in_path, out_path = sys.argv[1:4]
    with open(in_path, "rb") as f:
        inp = pickle.load(f)
    world = int(inp["world"])
    # the store's server lives here, on a port the system picks
    store = dist.TCPStore("127.0.0.1", 0, world_size=world + 1, is_master=True,
                          wait_for_workers=False)
    # the inputs go by path: a large argument would make each start wait for
    # the child before it to import torch
    mp.spawn(_worker, args=(world, store.port, case, in_path, out_path), nprocs=world)
    if "jax" in sys.modules:
        raise RuntimeError("a rank imported JAX")


if __name__ == "__main__":
    main()
