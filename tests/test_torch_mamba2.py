"""The Mamba-2 serving slice of the port against the JAX package: the causal
conv, the decode step, the block, the configs, the parameter bridge, prefill,
the cache, decode and a greedy generation, on the mamba2-1.3b smoke config.

Weights and tokens are made with numpy from a seed and handed to both sides.
Everything is float32 on the CPU.  Single functions are compared at 2e-5
relative to max|ref| (sums in another order, chained products); logits at
2e-4, the tolerance of the JAX package's own prefill/decode consistency test.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.launch import serve as jax_serve
from repro.models import mamba2 as JM
from repro.models.common import get_model as jax_model
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import serve
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import mamba2 as PM
from repro_torch.models.common import get_model, param_count
from repro_torch.testing import from_jax_params, rel_err, to_numpy, to_torch

ARCH = "mamba2-1.3b"
TOL = 2e-4
TOL_FN = 2e-5


def _rng(seed):
    return np.random.default_rng(seed)


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _np_params(jcfg, seed):
    """A numpy tree with the JAX model's structure: weights normal with each
    leaf's own standard deviation; norm scales and D around 1, A_log and
    dt_bias spread out, so that every parameter matters."""
    init = jax_model(jcfg).init(jcfg, jax.random.PRNGKey(0))
    rng = _rng(seed)

    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        a = np.asarray(tree, dtype=np.float32)
        noise = rng.standard_normal(a.shape).astype(np.float32)
        if name in ("scale", "D"):
            return 1 + 0.1 * noise
        if name == "A_log":
            return 0.3 * noise
        if name == "dt_bias":
            return -1.0 + 0.5 * noise
        return noise * a.std()
    return walk(init)


def _jnp_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _tokens(cfg, B, S, seed):
    return _rng(seed).integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)


def _layer0(np_tree):
    return jax.tree_util.tree_map(lambda a: a[0], np_tree["layers"]["mamba"])


# -- the pieces of the block ------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv(with_state):
    rng = _rng(1)
    x, w = _f32(rng, 2, 9, 24), _f32(rng, 4, 24, scale=0.5)
    st = _f32(rng, 2, 3, 24) if with_state else None
    jy, jst = JM._causal_conv(jnp.asarray(x), jnp.asarray(w),
                              None if st is None else jnp.asarray(st))
    py, pst = PM._causal_conv(to_torch(x), to_torch(w),
                              None if st is None else to_torch(st))
    assert rel_err(py, np.asarray(jy)) < TOL_FN
    assert pst.shape == (2, 3, 24)
    assert np.array_equal(to_numpy(pst), np.asarray(jst))     # a copy of inputs


def test_ssd_decode_step():
    rng = _rng(2)
    B, H, P, G, N = 2, 4, 16, 2, 8
    x, B_, C = _f32(rng, B, 1, H, P), _f32(rng, B, 1, G, N), _f32(rng, B, 1, G, N)
    dt = np.abs(_f32(rng, B, 1, H))
    A = -np.exp(_f32(rng, H, scale=0.3))
    state = _f32(rng, B, H, P, N)
    args = (x, dt, A, B_, C, state)
    jy, jst = JM.ssd_decode_step(*(jnp.asarray(a) for a in args))
    py, pst = PM.ssd_decode_step(*(to_torch(a) for a in args))
    assert py.shape == (B, 1, H, P) and pst.dtype == torch.float32
    assert rel_err(py, np.asarray(jy)) < TOL_FN
    assert rel_err(pst, np.asarray(jst)) < TOL_FN


@pytest.mark.parametrize("attn_impl", ["kernel", "dense"])
def test_mamba_block_prefill_and_decode(attn_impl):
    """The block in prefill (the scan, its final state and the conv states)
    and then one decode step from that state, against the JAX block."""
    jcfg = jax_smoke(ARCH)
    pcfg = get_smoke_config(ARCH).replace(attn_impl=attn_impl)
    np_tree = _np_params(jcfg, seed=3)
    jp = _jnp_tree(_layer0(np_tree))
    pp = from_jax_params(pcfg, np_tree, "cpu")["layers"][0]["mamba"]
    rng = _rng(4)
    u = _f32(rng, 2, 45, jcfg.d_model)            # two chunks of 32, ragged
    jo, jst = JM.mamba_block_fwd(jcfg, jp, jnp.asarray(u))
    po, pst = PM.mamba_block_fwd(pcfg, pp, to_torch(u))
    assert rel_err(po, np.asarray(jo)) < TOL_FN
    for key in ("ssm", "conv_x", "conv_B", "conv_C"):
        assert pst[key].shape == tuple(jst[key].shape), key
        assert rel_err(pst[key], np.asarray(jst[key])) < TOL_FN, key

    u1 = _f32(rng, 2, 1, jcfg.d_model)
    jo, jst = JM.mamba_block_fwd(jcfg, jp, jnp.asarray(u1), state=jst)
    po, pst = PM.mamba_block_fwd(pcfg, pp, to_torch(u1), state=pst)
    assert rel_err(po, np.asarray(jo)) < TOL_FN
    assert rel_err(pst["ssm"], np.asarray(jst["ssm"])) < TOL_FN
    with pytest.raises(ValueError, match="one token"):
        PM.mamba_block_fwd(pcfg, pp, to_torch(u[:, :2]), state=pst)
    with pytest.raises(ValueError, match="attn_impl"):
        PM.mamba_block_fwd(pcfg.replace(attn_impl="flash"), pp, to_torch(u))


# -- configs and the bridge ----------------------------------------------------------

def _dtype_name(d):
    return str(d).split(".")[-1] if isinstance(d, torch.dtype) else jnp.dtype(d).name


@pytest.mark.parametrize("preset", ["full", "smoke"])
def test_config_equals_jax_config_field_by_field(preset):
    jcfg = jax_config(ARCH) if preset == "full" else jax_smoke(ARCH)
    pcfg = get_config(ARCH) if preset == "full" else get_smoke_config(ARCH)
    jfields = [f.name for f in dataclasses.fields(jcfg)]
    assert jfields == [f.name for f in dataclasses.fields(pcfg)]
    for name in jfields:
        jv, pv = getattr(jcfg, name), getattr(pcfg, name)
        if name in ("param_dtype", "compute_dtype"):
            assert isinstance(pv, torch.dtype) and _dtype_name(jv) == _dtype_name(pv)
        elif name == "attn_impl":
            assert pv == "kernel"       # the port wires its kernels in
        else:
            assert jv == pv, (name, jv, pv)
    assert (pcfg.d_inner, pcfg.ssm_heads) == (jcfg.d_inner, jcfg.ssm_heads)
    if preset == "full":
        assert (pcfg.num_layers, pcfg.d_inner, pcfg.ssm_heads) == (48, 4096, 64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_from_jax_params_round_trip(dtype):
    """Every leaf survives exactly; the fp32 leaves (dt_bias, A_log, D) stay
    fp32 in a bf16 config, as in the JAX tree."""
    jcfg = jax_smoke(ARCH).replace(param_dtype=dtype)
    pcfg = get_smoke_config(ARCH).replace(param_dtype=dtype)
    jparams = jax_model(jcfg).init(jcfg, jax.random.PRNGKey(3))
    np_tree = jax.tree_util.tree_map(np.asarray, jparams)
    params = from_jax_params(pcfg, np_tree, "cpu")
    assert isinstance(params["layers"], list) and len(params["layers"]) == 2
    assert param_count(params) == sum(
        int(x.size) for x in jax.tree_util.tree_leaves(jparams))
    restack = {k: v for k, v in params.items() if k != "layers"}
    restack["layers"] = jax.tree_util.tree_map(
        lambda *xs: torch.stack(xs), *params["layers"])
    flat_j = jax.tree_util.tree_leaves_with_path(np_tree)
    flat_p = dict(jax.tree_util.tree_leaves_with_path(restack))
    assert len(flat_j) == len(flat_p)
    fp32_leaves = {"dt_bias", "A_log", "D"}
    for path, leaf in flat_j:
        t = flat_p[path]
        name = path[-1].key
        want = torch.float32 if name in fp32_leaves else getattr(torch, dtype)
        assert t.dtype == want, (path, t.dtype)
        assert tuple(t.shape) == leaf.shape
        assert np.array_equal(to_numpy(t), leaf.astype(np.float32)), path


def test_init_has_the_bridge_layout_and_full_size():
    jcfg, pcfg = jax_smoke(ARCH), get_smoke_config(ARCH)
    bridged = from_jax_params(pcfg, _np_params(jcfg, 0), "cpu")
    own = get_model(pcfg).init(pcfg, torch.Generator().manual_seed(0), "cpu")
    shapes = lambda t: jax.tree_util.tree_map(lambda x: (tuple(x.shape), x.dtype), t)
    assert shapes(own) == shapes(bridged)
    # the full config's size, counted on the meta device (nothing allocated)
    full = get_config(ARCH)
    meta = get_model(full).init(full, torch.Generator(), "meta")
    assert param_count(meta) == 1_446_505_472


def test_init_cache_layout_equals_jax():
    jcfg, pcfg = jax_smoke(ARCH), get_smoke_config(ARCH)
    jc = jax_model(jcfg).init_cache(jcfg, 3, 20)
    pc = get_model(pcfg).init_cache(pcfg, 3, 20, "cpu")
    for key in ("ssm", "conv_x", "conv_B", "conv_C"):
        assert pc[key].shape == tuple(jc[key].shape), key
        assert _dtype_name(pc[key].dtype) == jnp.dtype(jc[key].dtype).name, key
        assert float(pc[key].abs().max()) == 0.0
    assert pc["ssm"].shape == (2, 3, 8, 16, 16) and pc["len"] == 0


# -- the model against the JAX model -----------------------------------------------

@pytest.mark.parametrize("attn_impl", ["kernel", "dense"])
def test_prefill_cache_and_decode_step_equal_jax(attn_impl):
    jcfg = jax_smoke(ARCH)
    pcfg = get_smoke_config(ARCH).replace(attn_impl=attn_impl)
    np_tree = _np_params(jcfg, seed=1)
    jparams, params = _jnp_tree(np_tree), from_jax_params(pcfg, np_tree, "cpu")
    B, S = 2, 37                                   # two chunks of 32, ragged
    toks = _tokens(jcfg, B, S + 2, seed=2)

    jl, jcache = JM.Mamba2LM.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks[:, :S])})
    pl, cache = make_prefill_step(pcfg)(params, {"tokens": to_torch(toks[:, :S])})
    assert pl.shape == (B, 1, pcfg.vocab_size) and pl.dtype == torch.float32
    assert rel_err(pl, np.asarray(jl)) < TOL
    assert cache["len"] == S == int(jcache["len"])
    for key in ("ssm", "conv_x", "conv_B", "conv_C"):
        assert cache[key].shape == tuple(jcache[key].shape), key
        assert rel_err(cache[key], np.asarray(jcache[key])) < TOL, key

    # the SSM cache has no sequence axis: padding leaves it as it is
    padded = serve.pad_cache_to(cache, S + 8)
    assert all(padded[k] is cache[k] for k in ("ssm", "conv_x", "conv_B", "conv_C"))
    jcache = jax_serve.pad_cache_to(jcache, S + 8)
    ssm_before = cache["ssm"]
    for i in range(2):
        tok = toks[:, S + i:S + i + 1]
        jd, jcache = JM.Mamba2LM.decode_step(jcfg, jparams, jcache, {"tokens": jnp.asarray(tok)})
        pd, cache = make_decode_step(pcfg)(params, padded, {"tokens": to_torch(tok)})
        assert rel_err(pd, np.asarray(jd)) < TOL, i
        assert cache["len"] == S + 1 + i == int(jcache["len"])
        for key in ("ssm", "conv_x", "conv_B", "conv_C"):
            assert rel_err(cache[key], np.asarray(jcache[key])) < TOL, (i, key)
        assert cache["ssm"] is ssm_before            # written in place
        padded = cache


def test_forward_hidden_equals_jax():
    jcfg, pcfg = jax_smoke(ARCH), get_smoke_config(ARCH)
    np_tree = _np_params(jcfg, seed=5)
    toks = _tokens(jcfg, 2, 70, seed=6)            # three chunks, ragged
    jh = JM.Mamba2LM.forward(jcfg, _jnp_tree(np_tree), jnp.asarray(toks))
    ph = get_model(pcfg).forward(pcfg, from_jax_params(pcfg, np_tree, "cpu"),
                                 to_torch(toks))
    assert ph.shape == (2, 70, pcfg.d_model)
    assert rel_err(ph, np.asarray(jh)) < TOL


def test_prefill_decode_consistency():
    """prefill(S) + decode(token S) == full forward at position S."""
    cfg = get_smoke_config(ARCH)
    model = get_model(cfg)
    params = model.init(cfg, torch.Generator().manual_seed(1), "cpu")
    B, S = 2, 40
    tks = to_torch(_tokens(cfg, B, S + 1, seed=2))
    full = model.logits(cfg, params, model.forward(cfg, params, tks))
    logits_p, cache = model.prefill(cfg, params, {"tokens": tks[:, :S]})
    logits_d, _ = model.decode_step(cfg, params, cache, {"tokens": tks[:, S:S + 1]})
    assert rel_err(logits_p[:, -1], full[:, S - 1]) < TOL
    assert rel_err(logits_d[:, 0], full[:, S]) < TOL


# -- the launcher -------------------------------------------------------------------------

def test_greedy_generation_gives_the_jax_tokens():
    jcfg, pcfg = jax_smoke(ARCH), get_smoke_config(ARCH)
    np_tree = _np_params(jcfg, seed=7)
    jparams, params = _jnp_tree(np_tree), from_jax_params(pcfg, np_tree, "cpu")
    B, S, G = 3, 12, 8
    prompts = _tokens(jcfg, B, S, seed=8)

    logits, cache = JM.Mamba2LM.prefill(jcfg, jparams, {"tokens": jnp.asarray(prompts)})
    cache = jax_serve.pad_cache_to(cache, S + G)
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None]
    want = [tok]
    for _ in range(G - 1):
        logits, cache = JM.Mamba2LM.decode_step(jcfg, jparams, cache, {"tokens": tok})
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None]
        want.append(tok)
    want = np.asarray(jnp.concatenate(want, axis=1))

    got, t_prefill, t_decode = serve.generate(pcfg, params, to_torch(prompts), G)
    assert got.shape == (B, G) and t_prefill > 0 and t_decode > 0
    assert np.array_equal(got.numpy(), want)


def test_serve_main_on_cpu(capsys):
    serve.main(["--device", "cpu", "--arch", ARCH, "--preset", "smoke",
                "--batch", "2", "--prompt-len", "40", "--gen", "4", "--seed", "3"])
    out = capsys.readouterr().out
    assert re.search(rf"\[serve\] {ARCH} on cpu: prefill 2x40 in \d+ ms; "
                     r"decode 3 steps", out)
    assert "[serve] sample:" in out
