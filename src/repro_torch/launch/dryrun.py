"""Multi-pod dry-run of the port: build every (architecture × input-shape ×
mesh) cell against the production mesh on the ``meta`` device, with an
``AbstractMesh`` of 16x16 or 2x16x16 standing in for 256 or 512 cards.  No
device is touched and nothing is allocated.

For each cell we record:
  * per-device argument bytes, from each argument's local shard shape
    (``parallel.sharding.attach``): the params, AdamW state, batch and cache;
  * per-device dot FLOPs of the step, counted on meta tensors by
    ``analysis.flops`` (the whole step's count at the local batch, split
    evenly over the model axis), and the collectives' wire bytes from the
    sharding specs (ring model) — these feed the roofline
    (``analysis.roofline``).
There is no compiler, so no ``compile_s`` and no temporaries.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh both --out build/dryrun
Hillclimb knobs: --no-fsdp --remat=none|dots|full --grad-accum N --fsdp-pod
                 --tag label (--attn is recorded; the FLOPs are counted on
                 the dense path, the kernels cannot run on meta tensors)
"""
from __future__ import annotations

import argparse
import gzip
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch.analysis.flops import StepSummary, count_flops, param_collectives
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.launch.steps import loss_and_grads, make_decode_step, make_prefill_step
from repro_torch.optim import adamw_init
from repro_torch.parallel.sharding import (
    ShardingPolicy, attach, make_batch_specs, make_cache_specs, make_opt_specs,
    make_param_specs, map_specs, spec_leaves)

DOC = __doc__
DEFAULT_OUT = "build/dryrun"


def build_policy(multi_pod: bool, fsdp: bool, fsdp_pod: bool) -> ShardingPolicy:
    dp = ("pod", "data") if multi_pod else ("data",)
    fa = (("pod", "data") if (fsdp_pod and multi_pod) else ("data",))
    return ShardingPolicy(fsdp=fsdp, fsdp_axes=fa, dp_axes=dp)


def production_mesh(multi_pod: bool) -> AbstractMesh:
    """``launch.mesh.make_production_mesh``'s shape and axes, with no ranks."""
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def local_bytes(tree) -> int:
    """Bytes of one device's shards of a tree of ``ShardedShape``s."""
    total = 0
    for leaf in spec_leaves(tree):
        n = 1
        for d in leaf.local_shape:
            n *= d
        total += n * leaf.dtype.itemsize
    return total


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               fsdp: bool = True, fsdp_pod: bool = False,
               remat: str | None = None, attn: str | None = None,
               grad_accum: int | None = None, extra_cfg: dict | None = None,
               breakdown: list | None = None) -> dict:
    """Build one cell on meta tensors; return the result record (the JAX
    package's keys: ``status``, ``memory``, ``cost``, ``hlo``).  With
    ``breakdown`` (a list), each modelled collective is appended to it."""
    t0 = time.time()
    cfg = get_config(arch)
    if remat:
        cfg = cfg.replace(remat=remat)
    if attn:
        cfg = cfg.replace(attn_impl=attn)
    if extra_cfg:
        cfg = cfg.replace(**extra_cfg)
    kind, seq, batch = S.SHAPES[shape_name]
    ok, reason = S.cell_applicable(arch, shape_name)
    rec = {"arch": arch, "shape": shape_name, "kind": kind,
           "mesh": "2x16x16" if multi_pod else "16x16",
           "fsdp": fsdp, "remat": cfg.remat, "attn": cfg.attn_impl}
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec

    try:
        mesh = production_mesh(multi_pod)
        pol = build_policy(multi_pod, fsdp, fsdp_pod)
        tp = mesh.shape[pol.tp_axis]
        pshapes = S.params_shapes(cfg)
        pspecs = make_param_specs(cfg, pshapes, mesh, pol)
        p_in = attach(mesh, pshapes, pspecs)
        bshapes = S.batch_specs(cfg, shape_name)
        b_in = attach(mesh, bshapes, make_batch_specs(cfg, bshapes, mesh, pol))
        args = [p_in, b_in]
        # the kernels cannot run on meta tensors: count the dense path's
        # products, the same matrix products without the kernels' tile skipping
        counted = cfg.replace(attn_impl="dense")
        rows = bshapes["tokens"].shape[0]
        local_rows = b_in["tokens"].local_shape[0]
        tokens = local_rows * sum(v.shape[1] for k, v in bshapes.items()
                                  if k in ("tokens", "enc_embeds"))
        ga = 1
        if kind == "train":
            ga = grad_accum if grad_accum is not None else S.default_grad_accum(cfg, shape_name)
            rec["grad_accum"] = ga
            oshapes = adamw_init(pshapes)
            args.append(attach(mesh, oshapes, make_opt_specs(pspecs)))
            mb = {k: v[:rows // ga] for k, v in bshapes.items()}
            dot, conv = count_flops(loss_and_grads, counted, pshapes, mb)
            dot, conv = dot * ga, conv * ga
        elif kind == "prefill":
            dot, conv = count_flops(make_prefill_step(counted), pshapes, bshapes)
        else:
            cshapes = S.cache_specs(cfg, shape_name)
            # the cache's fill length, a Python int here, is an int32 scalar
            # argument in the JAX package's step
            scalars = map_specs(lambda x: x if hasattr(x, "shape") else
                                torch.empty((), dtype=torch.int32, device=S.META), cshapes)
            args.append(attach(mesh, scalars, make_cache_specs(cfg, scalars, mesh, pol)))
            dot, conv = count_flops(make_decode_step(counted), pshapes, cshapes, bshapes)
        share = local_rows / rows / tp
        hs = StepSummary(dot_flops=dot * share, conv_flops=conv * share)
        param_collectives(
            hs, p_in, mesh, fsdp_axes=pol.fsdp_axes if pol.fsdp else (),
            dp_axes=pol.dp_axes, tp_axis=pol.tp_axis, kind=kind, microbatches=ga,
            forward_passes=2 if (kind == "train" and cfg.remat == "full") else 1,
            tokens=tokens / ga, compute_dtype=cfg.compute_dtype)
        if breakdown is not None:
            breakdown.extend(hs.per_collective)
        rec.update(
            status="ok",
            lower_s=round(time.time() - t0, 2),
            memory={"argument_size_in_bytes": sum(local_bytes(a) for a in args)},
            cost={"flops": hs.total_flops},
            hlo=hs.to_json(),
        )
    except Exception as e:  # noqa: BLE001 — record the failure, keep the matrix going
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-4000:])
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=DOC,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--fsdp-pod", action="store_true")
    ap.add_argument("--remat", default=None)
    ap.add_argument("--attn", default=None)
    ap.add_argument("--grad-accum", type=int, default=None)
    ap.add_argument("--save-hlo", action="store_true",
                    help="write each cell's modelled collectives (the port has no "
                         "HLO) to <out>/hlo/<tag>_<arch>_<shape>_<mesh>.json.gz")
    ap.add_argument("--cfg", default=None, help="extra cfg overrides k=v,k=v")
    args = ap.parse_args(argv)

    extra = {}
    if args.cfg:
        for kv in args.cfg.split(","):
            k, v = kv.split("=")
            try:
                v = int(v)
            except ValueError:
                try:
                    v = float(v)
                except ValueError:
                    pass
            extra[k] = v

    archs = ALL_ARCHS if (args.all or args.arch is None) else [args.arch]
    shapes = list(S.SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    outfile = outdir / f"dryrun_{args.tag}.jsonl"
    done = set()
    if outfile.exists():
        for line in outfile.read_text().splitlines():
            try:
                r = json.loads(line)
                done.add((r["arch"], r["shape"], r["mesh"]))
            except Exception:
                pass

    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                mesh_name = "2x16x16" if mp else "16x16"
                if (arch, shape, mesh_name) in done:
                    continue
                print(f"[dryrun] {arch} x {shape} x {mesh_name} ...", flush=True)
                breakdown = [] if args.save_hlo else None
                rec = lower_cell(
                    arch, shape, multi_pod=mp, fsdp=not args.no_fsdp,
                    fsdp_pod=args.fsdp_pod, remat=args.remat, attn=args.attn,
                    grad_accum=args.grad_accum, extra_cfg=extra or None,
                    breakdown=breakdown)
                rec["tag"] = args.tag
                with open(outfile, "a") as f:
                    f.write(json.dumps(rec) + "\n")
                if breakdown:
                    path = outdir / "hlo" / f"{args.tag}_{arch}_{shape}_{mesh_name}.json.gz"
                    path.parent.mkdir(parents=True, exist_ok=True)
                    with gzip.open(path, "wt") as f:
                        json.dump(breakdown, f)
                status = rec.get("status")
                extra_info = (f" build={rec.get('lower_s')}s"
                              f" args={rec.get('memory', {}).get('argument_size_in_bytes', 0)/2**30:.2f}GiB"
                              f" flops={rec.get('cost', {}).get('flops', 0):.3e}"
                              if status == "ok" else rec.get("error", rec.get("reason", "")))
                print(f"[dryrun]   -> {status}{extra_info}", flush=True)


if __name__ == "__main__":
    main()
