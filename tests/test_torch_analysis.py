"""The port's analysis layer and dry-run (``repro_torch.analysis``,
``repro_torch.launch.dryrun``) against the JAX package's, on the CPU.

tests/test_analysis.py's checks on the port: FLOPs counted on meta tensors
(``FlopCounterMode``, the port's counterpart of the HLO parser), the ring
model's all-gather bytes, the analytic parameter counts.  Then the parameter
counts and every roofline function equal to the JAX package's on every arch
× shape, the roofline's terms in the ratio of the two packages' hardware
constants, and one dry-run cell of each family at both meshes: ``ok`` (or the
JAX package's ``skipped`` reason), its per-device argument bytes equal to the
sum of the local shards of the JAX package's specs (``jax.eval_shape`` and
each sharding's ``shard_shape``, no compile).
"""
import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from repro.analysis import params as JPARAMS
from repro.analysis import roofline as JR
from repro.configs import ALL_ARCHS
from repro.configs import get_config as jax_config
from repro.launch import specs as JS
from repro.optim import adamw_init as jax_adamw_init
from repro.parallel import sharding as JSH
from repro_torch.analysis import flops as F
from repro_torch.analysis import params as PPARAMS
from repro_torch.analysis import roofline as PR
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch import specs as PS
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.parallel.sharding import PartitionSpec as P
from repro_torch.parallel.sharding import ShardedShape, spec_leaves

CELLS = [(a, s) for a in ALL_ARCHS for s in JS.SHAPES]


# -- tests/test_analysis.py on the port ---------------------------------------------

def test_flop_counter_counts_every_product_on_meta():
    """Eight chained [128, 256] x [256, 256] products on meta tensors count
    2·128·256·256·8 FLOPs: every product of a Python loop over layers,
    where XLA's cost_analysis counts a scanned body once."""
    x = torch.empty((128, 256), device="meta")
    ws = torch.empty((8, 256, 256), device="meta")

    def f(x, ws):
        for w in ws:
            x = x @ w
        return x

    dot, conv = F.count_flops(f, x, ws)
    assert dot == 2 * 128 * 256 * 256 * 8
    assert conv == 0


def test_flop_counter_counts_convolutions_apart():
    x = torch.empty((2, 8, 100), device="meta")
    w = torch.empty((16, 8, 3), device="meta")
    dot, conv = F.count_flops(torch.nn.functional.conv1d, x, w)
    assert dot == 0 and conv == 2 * 2 * 16 * 98 * 8 * 3


def test_collective_wire_bytes():
    """all-gather over 4 devices: wire = out_bytes * 3/4 per device, for a
    [1024, 64] fp32 leaf sharded over the gathered axis."""
    mesh = AbstractMesh((4,), ("data",))
    leaf = ShardedShape((1024, 64), torch.float32, P("data"), (256, 64))
    s = F.StepSummary()
    F.param_collectives(s, {"w": leaf}, mesh, fsdp_axes=("data",), dp_axes=("data",),
                        tp_axis="model", kind="prefill", compute_dtype=torch.float32)
    out_bytes = 1024 * 64 * 4
    assert s.collective_bytes == {"all-gather": out_bytes * 3 / 4}
    assert s.collective_counts == {"all-gather": 1}


@pytest.mark.parametrize("op,factor", [("all-gather", 3 / 4), ("reduce-scatter", 3),
                                       ("all-reduce", 2 * 3 / 4), ("all-to-all", 3 / 4),
                                       ("collective-permute", 1)])
def test_ring_model_equals_the_hlo_parsers(op, factor):
    assert F.wire_bytes(op, 1000.0, 4) == pytest.approx(1000.0 * factor)


def test_summary_has_the_hlo_summarys_keys():
    from repro.analysis.hlo import HloSummary
    assert set(F.StepSummary().to_json()) == set(HloSummary().to_json())


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_analytic_param_count_matches_meta_shapes(arch):
    cfg = get_config(arch)
    actual = sum(int(np.prod(x.shape)) for x in spec_leaves(PS.params_shapes(cfg)))
    predicted = PPARAMS.param_count(cfg)
    # analytic model skips norms/biases/pos-embeds/conv kernels (<2%)
    assert abs(predicted - actual) / actual < 0.05, (predicted, actual)


def test_headline_param_counts():
    expect = {"tinyllama-1.1b": (0.9e9, 1.3e9),
              "llama3.2-3b": (2.8e9, 3.8e9),
              "mamba2-1.3b": (1.1e9, 1.55e9),
              "mixtral-8x22b": (125e9, 150e9),
              "nemotron-4-15b": (13e9, 17e9)}
    for arch, (lo, hi) in expect.items():
        n = PPARAMS.param_count(get_config(arch))
        assert lo < n < hi, (arch, n)


# -- against the JAX package -----------------------------------------------------------

@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_counts_equal_reference(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    assert PPARAMS.param_count(cfg) == JPARAMS.param_count(jcfg)
    assert PPARAMS.active_param_count(cfg) == JPARAMS.active_param_count(jcfg)
    assert isinstance(PPARAMS.param_count(cfg), int)


def test_roofline_functions_equal_reference():
    for arch, shape in CELLS:
        assert PR.model_flops_for_cell(arch, shape) == JR.model_flops_for_cell(arch, shape)
        assert PR.min_bytes_for_cell(arch, shape) == JR.min_bytes_for_cell(arch, shape)
        _, S, B = JS.SHAPES[shape]
        assert PR.cache_bytes(arch, S, B) == JR.cache_bytes(arch, S, B)
        for kw in ({}, {"grad_accum": 8}, {"remat": "none"}, {"fsdp": False},
                   {"tp": 8, "chips": 512}):
            assert (PR.achieved_bytes_for_cell(arch, shape, **kw)
                    == JR.achieved_bytes_for_cell(arch, shape, **kw)), (arch, shape, kw)


def test_h100_constants():
    assert (PR.PEAK_FLOPS, PR.HBM_BW, PR.LINK_BW) == (989e12, 3.35e12, 450e9)
    assert PR.CHIPS_SINGLE_POD == JR.CHIPS_SINGLE_POD == 256
    assert "MXU" not in " ".join(PR._LEVER.values())
    assert "VMEM" not in " ".join(PR._LEVER.values())


def _records():
    """Dry-run records with the JAX package's keys, one a cell."""
    rng = np.random.default_rng(0)
    recs = []
    for arch, shape in CELLS:
        kind = JS.SHAPES[shape][0]
        recs.append({"arch": arch, "shape": shape, "kind": kind, "mesh": "16x16",
                     "status": "ok", "grad_accum": 8, "remat": "full", "fsdp": True,
                     "hlo": {"dot_flops": float(rng.uniform(1e12, 1e15)),
                             "conv_flops": float(rng.uniform(0, 1e10)),
                             "total_collective_bytes": float(rng.uniform(1e8, 1e11))},
                     "memory": {"temp_size_in_bytes": int(rng.integers(1, 1 << 34)),
                                "argument_size_in_bytes": int(rng.integers(1, 1 << 34))}})
    recs.append(dict(recs[0], mesh="2x16x16"))
    recs.append(dict(recs[0], status="skipped"))
    return recs


def test_roofline_rows_scale_by_the_hardware_ratio(tmp_path):
    recs = _records()
    port, ref = PR.build_rows(recs), JR.build_rows(recs)
    assert len(port) == len(ref) == len(CELLS)
    for a, b in zip(port, ref):
        assert (a.arch, a.shape, a.kind) == (b.arch, b.shape, b.kind)
        assert a.compute_s == pytest.approx(b.compute_s * JR.PEAK_FLOPS / PR.PEAK_FLOPS)
        assert a.memory_s == pytest.approx(b.memory_s * JR.HBM_BW / PR.HBM_BW)
        assert a.collective_s == pytest.approx(b.collective_s * JR.ICI_BW / PR.LINK_BW)
        for f in ("model_flops_per_chip", "min_bytes_per_chip", "hlo_flops_per_chip",
                  "temp_gib", "useful_ratio"):
            assert getattr(a, f) == getattr(b, f), f
    path = tmp_path / "dryrun.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in recs))
    rows = PR.load_rows(path)
    assert [r.step_s for r in rows] == [r.step_s for r in port]
    md = PR.to_markdown(rows)
    assert md.count("\n") == len(rows) + 2 and "mem GiB/card" in md


# -- the dry-run -----------------------------------------------------------------------

# one cell of each family, and one the JAX package skips
DRYRUN_CELLS = [("llama3.2-3b", "train_4k"), ("qwen2-vl-2b", "prefill_32k"),
                ("deepseek-v2-lite-16b", "decode_32k"), ("mamba2-1.3b", "decode_32k"),
                ("zamba2-1.2b", "long_500k"), ("whisper-large-v3", "train_4k"),
                ("tinyllama-1.1b", "long_500k")]
JAX_LAYOUTS = {
    False: (JaxAbstractMesh((16, 16), ("data", "model")), JSH.ShardingPolicy()),
    True: (JaxAbstractMesh((2, 16, 16), ("pod", "data", "model")),
           JSH.ShardingPolicy(dp_axes=("pod", "data"))),
}


class _JaxFakeMesh:
    def __init__(self, mesh):
        self.shape = dict(zip(mesh.axis_names, mesh.axis_sizes))


def _jax_local_bytes(shapes, specs, mesh) -> int:
    pairs = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda spec, s: NamedSharding(mesh, spec).shard_shape(s.shape)
        + (np.dtype(s.dtype).itemsize,), specs, shapes,
        is_leaf=lambda x: isinstance(x, JP)), is_leaf=lambda x: isinstance(x, tuple))
    return sum(int(np.prod(p[:-1])) * p[-1] for p in pairs)


def _jax_argument_bytes(arch, shape, multi_pod) -> int:
    """The JAX package's dry-run arguments for the cell: params, AdamW
    state (train), batch, cache (decode); each leaf's shard shape on the
    mesh, by its spec."""
    mesh, pol = JAX_LAYOUTS[multi_pod]
    fake = _JaxFakeMesh(mesh)
    cfg = jax_config(arch)
    kind = JS.SHAPES[shape][0]
    pshapes = JS.params_shapes(cfg)
    pspecs = JSH.make_param_specs(cfg, pshapes, fake, pol)
    bshapes = JS.batch_specs(cfg, shape)
    total = (_jax_local_bytes(pshapes, pspecs, mesh)
             + _jax_local_bytes(bshapes, JSH.make_batch_specs(cfg, bshapes, fake, pol), mesh))
    if kind == "train":
        oshapes = jax.eval_shape(jax_adamw_init, pshapes)
        total += _jax_local_bytes(oshapes, JSH.make_opt_specs(pspecs), mesh)
    if kind == "decode":
        cshapes = jax.eval_shape(lambda: JS.cache_specs(cfg, shape))
        total += _jax_local_bytes(cshapes, JSH.make_cache_specs(cfg, cshapes, fake, pol),
                                  mesh)
    return total


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch,shape", DRYRUN_CELLS)
def test_dryrun_cell_against_reference(arch, shape, multi_pod):
    rec = dryrun.lower_cell(arch, shape, multi_pod=multi_pod)
    assert rec["mesh"] == ("2x16x16" if multi_pod else "16x16")
    ok, reason = JS.cell_applicable(arch, shape)
    if not ok:
        assert rec["status"] == "skipped" and rec["reason"] == reason
        return
    assert rec["status"] == "ok", rec.get("trace")
    assert "compile_s" not in rec
    assert set(rec["hlo"]) == set(F.StepSummary().to_json())
    assert rec["hlo"]["dot_flops"] > 0 and rec["cost"]["flops"] >= rec["hlo"]["dot_flops"]
    assert (rec["memory"]["argument_size_in_bytes"]
            == _jax_argument_bytes(arch, shape, multi_pod))
    if JS.SHAPES[shape][0] == "train":
        assert rec["grad_accum"] == JS.default_grad_accum(jax_config(arch), shape)
        assert rec["hlo"]["collective_bytes"]["reduce-scatter"] > 0


def test_dryrun_flops_per_device_split_the_global_count():
    """A prefill cell's per-device FLOPs are the whole step's count at the
    global batch over the 256 devices (every dim divides), and the two-pod
    mesh halves them."""
    single = dryrun.lower_cell("tinyllama-1.1b", "prefill_32k", multi_pod=False)
    multi = dryrun.lower_cell("tinyllama-1.1b", "prefill_32k", multi_pod=True)
    cfg = get_config("tinyllama-1.1b").replace(attn_impl="dense")
    from repro_torch.launch.steps import make_prefill_step
    dot, _ = F.count_flops(make_prefill_step(cfg), PS.params_shapes(cfg),
                           PS.batch_specs(cfg, "prefill_32k"))
    assert single["hlo"]["dot_flops"] == pytest.approx(dot / 256)
    assert multi["hlo"]["dot_flops"] == pytest.approx(dot / 512)


def test_dryrun_cli_writes_resumes_and_feeds_the_roofline(tmp_path, capsys):
    argv = ["--arch", "tinyllama-1.1b", "--shape", "prefill_32k", "--mesh", "single",
            "--out", str(tmp_path), "--save-hlo"]
    dryrun.main(argv)
    out = tmp_path / "dryrun_baseline.jsonl"
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [(r["arch"], r["shape"], r["mesh"], r["status"]) for r in recs] == [
        ("tinyllama-1.1b", "prefill_32k", "16x16", "ok")]
    assert (tmp_path / "hlo" / "baseline_tinyllama-1.1b_prefill_32k_16x16.json.gz").exists()
    dryrun.main(argv)                          # resume: the cell is done
    assert len(out.read_text().splitlines()) == 1
    rows = PR.load_rows(out)
    assert len(rows) == 1 and rows[0].compute_s > 0 and rows[0].collective_s > 0
    assert "[dryrun]   -> ok" in capsys.readouterr().out
    assert dryrun.DEFAULT_OUT == "build/dryrun"
