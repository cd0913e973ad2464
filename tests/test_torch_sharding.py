"""The port's sharding rules and abstract shapes against the JAX package's,
with no ranks (meshes of axis names and sizes only).

tests/test_sharding.py's four tests on the port; then, for all ten configs
at the single-pod 16x16 mesh and at the multi-pod policy (("pod", "data")
on 2x16x16), every param, batch and cache spec equal to the JAX package's,
spec for spec (a port leaf of layer i against the JAX package's stacked leaf
without its leading layer entry, every layer alike); and ``launch/specs``'s
meta shapes and dtypes equal to the JAX package's ``eval_shape`` for every
arch × shape cell that ``cell_applicable`` allows.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import ALL_ARCHS
from repro.configs import get_config as jax_config
from repro.launch import specs as JS
from repro.parallel.sharding import ShardingPolicy as JaxPolicy
from repro.parallel.sharding import make_batch_specs as jax_batch_specs
from repro.parallel.sharding import make_cache_specs as jax_cache_specs
from repro.parallel.sharding import make_param_specs as jax_param_specs
from repro_torch.checkpoint.layout import layer_lists
from repro_torch.configs import get_config
from repro_torch.launch import specs as PS
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.parallel.sharding import (PartitionSpec as P, ShardingPolicy,
                                           _fit, attach, make_batch_specs,
                                           make_cache_specs, make_param_specs,
                                           spec_leaves)


def _mesh():
    return AbstractMesh((16, 16), ("data", "model"))


class JaxFakeMesh:
    shape = {"data": 16, "model": 16}


class JaxFakePodMesh:
    shape = {"pod": 2, "data": 16, "model": 16}


LAYOUTS = {
    "pod": (JaxFakeMesh, JaxPolicy(), lambda: _mesh(), ShardingPolicy()),
    "multi_pod": (JaxFakePodMesh,
                  JaxPolicy(fsdp_axes=("pod", "data"), dp_axes=("pod", "data")),
                  lambda: AbstractMesh((2, 16, 16), ("pod", "data", "model")),
                  ShardingPolicy(fsdp_axes=("pod", "data"), dp_axes=("pod", "data"))),
}


# -- tests/test_sharding.py on the port ------------------------------------------

def test_fit_respects_divisibility():
    m = _mesh()
    assert _fit(m, (128256, 3072), ["model", "data"]) == P("model", "data")
    # kv_heads = 4 not divisible by 16 -> dropped; batch 32 shards fine
    assert _fit(m, (22, 32, 4, 64, 128), [None, "data", "model", None, None]
                ) == P(None, "data")
    # one axis never used twice
    assert _fit(m, (32, 32), [["model"], ["model", "data"]]) == P("model", "data")


def test_param_specs_cover_all_archs():
    m = _mesh()
    for arch in ("llama3.2-3b", "mixtral-8x22b", "deepseek-v2-lite-16b",
                 "mamba2-1.3b", "zamba2-1.2b", "whisper-large-v3"):
        cfg = get_config(arch)
        shapes = PS.params_shapes(cfg)
        specs = make_param_specs(cfg, shapes, m, ShardingPolicy())
        flat_shapes, flat_specs = spec_leaves(shapes), spec_leaves(specs)
        assert len(flat_shapes) == len(flat_specs)
        for s, spec in zip(flat_shapes, flat_specs):
            for dim, entry in zip(s.shape, tuple(spec)):
                if entry is None:
                    continue
                size = 1
                for a in (entry if isinstance(entry, tuple) else (entry,)):
                    size *= m.shape[a]
                assert dim % size == 0, (arch, s.shape, spec)


def test_big_tensors_actually_sharded():
    """No >64 MiB parameter (one layer's) may end up fully replicated."""
    m = _mesh()
    for arch in ("mixtral-8x22b", "nemotron-4-15b"):
        cfg = get_config(arch)
        shapes = PS.params_shapes(cfg)
        specs = make_param_specs(cfg, shapes, m, ShardingPolicy())
        for s, spec in zip(spec_leaves(shapes), spec_leaves(specs)):
            if 2 * s.numel() > 64 * 2**20:
                assert tuple(spec), (arch, s.shape)


def test_cache_specs_long_context_batch1():
    """long_500k (B=1): batch unshardable -> heads/seq take the axes."""
    cfg = get_config("zamba2-1.2b")
    specs = make_cache_specs(cfg, PS.cache_specs(cfg, "long_500k"), _mesh(),
                             ShardingPolicy())
    assert "model" in str(specs["attn_k"]) or "data" in str(specs["attn_k"])


# -- spec for spec against the JAX package ---------------------------------------

def _ref_flat(tree):
    """{path: leaf} of a JAX tree (a PartitionSpec or ShapeDtypeStruct a
    leaf)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, JP))[0]:
        out["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)] = leaf
    return out


def _port_flat(cfg, tree, stacked=True):
    """{JAX path: [the leaf of each layer]} of a port tree: a per-layer list
    of ``layer_lists`` collapses into the JAX package's stacked path."""
    lists = layer_lists(cfg) if stacked else {}
    out = {}

    def walk(t, path, in_list):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}/{k}" if path else str(k), in_list)
        elif isinstance(t, list):
            top = path.split("/")[0]
            for i, v in enumerate(t):
                walk(v, path if top in lists and not in_list else f"{path}/{i}",
                     in_list or top in lists)
        else:
            out.setdefault(path, []).append(t)

    walk(tree, "", False)
    return out


def _norm(spec) -> tuple:
    out = list(spec)
    while out and out[-1] is None:
        out.pop()
    return tuple(tuple(e) if isinstance(e, list) else e for e in out)


def _check_specs(cfg, ref_specs, port_specs, stacked=True):
    ref = {k: _norm(v) for k, v in _ref_flat(ref_specs).items()}
    port = _port_flat(cfg, port_specs, stacked)
    assert set(ref) == set(port), (sorted(set(ref) ^ set(port)))
    for path, specs in port.items():
        top = path.split("/")[0]
        if stacked and top in layer_lists(cfg):
            # every layer alike; the JAX package's stack entry is None
            assert all(s == specs[0] for s in specs), path
            assert ref[path] == _norm((None, *specs[0])), (path, ref[path], specs[0])
        else:
            assert len(specs) == 1 and ref[path] == _norm(specs[0]), (path, ref[path], specs)


@pytest.mark.parametrize("layout", ["pod", "multi_pod"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_specs_equal_jax(arch, layout):
    jmesh, jpol, pmesh, ppol = LAYOUTS[layout]
    jcfg, cfg = jax_config(arch), get_config(arch)
    _check_specs(cfg, jax_param_specs(jcfg, JS.params_shapes(jcfg), jmesh(), jpol),
                 make_param_specs(cfg, PS.params_shapes(cfg), pmesh(), ppol))
    for shape, (kind, _, _) in JS.SHAPES.items():
        if not JS.cell_applicable(arch, shape)[0]:
            continue
        _check_specs(cfg, jax_batch_specs(jcfg, JS.batch_specs(jcfg, shape), jmesh(), jpol),
                     make_batch_specs(cfg, PS.batch_specs(cfg, shape), pmesh(), ppol),
                     stacked=False)
        if kind == "decode":
            jc = jax.eval_shape(lambda: JS.cache_specs(jcfg, shape))
            _check_specs(cfg, jax_cache_specs(jcfg, jc, jmesh(), jpol),
                         make_cache_specs(cfg, PS.cache_specs(cfg, shape), pmesh(), ppol),
                         stacked=False)


# -- abstract shapes -----------------------------------------------------------------

def _same_shape(cfg, ref_tree, port_tree, stacked):
    ref = _ref_flat(ref_tree)
    port = _port_flat(cfg, port_tree, stacked)
    assert set(ref) == set(port), sorted(set(ref) ^ set(port))
    for path, leaves in port.items():
        r = ref[path]
        shape = ((len(leaves), *leaves[0].shape)
                 if stacked and path.split("/")[0] in layer_lists(cfg) else
                 tuple(getattr(leaves[0], "shape", ())))
        assert tuple(r.shape) == shape, (path, r.shape, shape)
        if isinstance(leaves[0], torch.Tensor):
            assert leaves[0].device.type == "meta"
            assert str(leaves[0].dtype).split(".")[-1] == np.dtype(r.dtype).name, path


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_meta_shapes_equal_jax_eval_shape(arch):
    jcfg, cfg = jax_config(arch), get_config(arch)
    _same_shape(cfg, JS.params_shapes(jcfg), PS.params_shapes(cfg), True)
    for shape, (kind, _, _) in JS.SHAPES.items():
        ok, why = JS.cell_applicable(arch, shape)
        assert PS.cell_applicable(arch, shape) == (ok, why)
        if not ok:
            continue
        _same_shape(cfg, JS.batch_specs(jcfg, shape), PS.batch_specs(cfg, shape), False)
        assert PS.default_grad_accum(cfg, shape) == JS.default_grad_accum(jcfg, shape)
        if kind == "decode":
            _same_shape(cfg, jax.eval_shape(lambda: JS.cache_specs(jcfg, shape)),
                        PS.cache_specs(cfg, shape), False)


def test_attach_gives_each_shard_its_shape():
    cfg = get_config("nemotron-4-15b")
    shapes = PS.params_shapes(cfg)
    specs = make_param_specs(cfg, shapes, _mesh(), ShardingPolicy())
    att = attach(_mesh(), shapes, specs)
    wq = att["layers"][0]["attn"]["wq"]
    assert wq.spec == P("data", "model")
    assert wq.local_shape == (wq.shape[0] // 16, wq.shape[1] // 16)
    assert wq.dtype == torch.bfloat16
