"""The Zamba2 slice of the port against the JAX package: the segments, the
shared block with its per-application LoRA, the config, the parameter
bridge, the loss and its gradients, prefill, the cache, the decode step and
the launchers, on the zamba2-1.2b smoke config (4 Mamba layers, the shared
block before every 2: two applications); and which path attention and the
scan take.

Weights and tokens are made with numpy from a seed and handed to both sides.
``lora_b`` starts at zero in both packages, which would hide the LoRA path,
so the trees here give it random values, and each application its own
``lora_a``.  Everything is float32 on the CPU.  The shared block alone is
compared at 2e-5 relative to max|ref|; logits, hidden states and caches at
2e-4; the loss at 1e-5 and each gradient leaf at 1e-4.
"""
import dataclasses
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.launch import serve as jax_serve
from repro.models import zamba2 as JZ
from repro.models.common import get_model as jax_model
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import serve, train
from repro_torch.launch.steps import loss_and_grads
from repro_torch.models import layers as PL
from repro_torch.models import mamba2 as PM
from repro_torch.models import zamba2 as PZ
from repro_torch.models.common import get_model, param_count, tree_unflatten
from repro_torch.testing import (from_jax_params, rel_err, to_jax_layout,
                                 to_numpy, to_torch)

ARCH = "zamba2-1.2b"
TOL = 2e-4
TOL_FN = 2e-5
GRAD_TOL = 1e-4
LOSS_TOL = 1e-5
STATE_KEYS = ("ssm", "conv_x", "conv_B", "conv_C", "attn_k", "attn_v")


def _np_params(jcfg, seed):
    """A numpy tree with the JAX model's structure: weights normal with each
    leaf's own standard deviation; norm scales and D around 1, A_log and
    dt_bias spread out; lora_b random (it is zero at init), so that every
    parameter matters."""
    init = jax_model(jcfg).init(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

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
        if name == "lora_b":
            return 0.1 * noise
        return noise * a.std()
    return walk(init)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)


@pytest.fixture
def paths(monkeypatch):
    """Counts the attention calls on the kernel and the dense path, and the
    scans through the kernel (``ops.ssd``) and the plain chunked function."""
    calls = {"kernel": 0, "dense": 0, "ssd": 0, "ssd_chunked": 0}

    def count(module, attr, name):
        fn = getattr(module, attr)

        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(module, attr, wrapped)
    count(PL, "flash_attention", "kernel")
    count(PL, "attention_dense", "dense")
    count(PM, "ssd", "ssd")
    count(PM, "ssd_chunked", "ssd_chunked")
    return calls


# -- the pieces ---------------------------------------------------------------------

@pytest.mark.parametrize("n,period", [(38, 6), (4, 2), (5, 2), (6, 6), (1, 3)])
def test_segments_equal_jax(n, period):
    assert PZ._segments(n, period) == JZ._segments(n, period)
    assert sum(PZ._segments(n, period)) == n


def test_n_applications_of_the_full_config():
    assert PZ.n_applications(get_config(ARCH)) == JZ.n_applications(jax_config(ARCH)) == 7


@pytest.mark.parametrize("app", [0, 1])
def test_shared_block_with_lora_equals_jax(app):
    """Each application's own LoRA, non-zero; the delta sliced to d_model."""
    jcfg, pcfg = jax_smoke(ARCH), get_smoke_config(ARCH)
    P = _np_params(jcfg, 1)
    assert np.abs(P["shared"]["lora_b"]).min() > 0
    assert not np.array_equal(P["shared"]["lora_a"][0], P["shared"]["lora_a"][1])
    rng = np.random.default_rng(2)
    x, x0 = (rng.standard_normal((2, 13, jcfg.d_model)).astype(np.float32)
             for _ in range(2))
    jy, jst = JZ.shared_block_fwd(jcfg, _jnp(P["shared"]), jnp.asarray(x),
                                  jnp.asarray(x0), app, jnp.arange(13))
    sp = from_jax_params(pcfg, P, "cpu")["shared"]
    py, pst = PZ.shared_block_fwd(pcfg, sp, to_torch(x), to_torch(x0), app)
    assert rel_err(py, np.asarray(jy)) < TOL_FN
    assert rel_err(pst["k"], np.asarray(jst["k"])) < TOL_FN
    # the LoRA matters: without it the block differs
    sp0 = dict(sp, lora_b=torch.zeros_like(sp["lora_b"]))
    assert rel_err(PZ.shared_block_fwd(pcfg, sp0, to_torch(x), to_torch(x0), app)[0],
                   np.asarray(jy)) > 1e-3


# -- config and bridge ------------------------------------------------------------

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
            assert pv == "kernel"
        else:
            assert jv == pv, (name, jv, pv)


def test_kernels_take_the_full_width_shapes():
    """On the card prefill and training go through both kernels, which raise
    on a shape they were not built for: zamba2's full config must be one
    they take.  Its N 64 (one 64-column atom of the state) is in the wgmma
    variants' domain, so bf16 runs on wgmma + TMA, forward and backward;
    float32 on the fp32 pipes."""
    from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS
    from repro_torch.kernels.ssd_scan import kernel
    cfg = get_config(ARCH)
    assert cfg.resolved_head_dim in HEAD_DIMS
    assert kernel.takes(cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_chunk)
    shape = (cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_chunk)
    assert kernel.variant(torch.bfloat16, *shape) == "ssd_wgmma"
    assert kernel.variant_bwd(torch.bfloat16, *shape) == "ssd_bwd_wgmma"
    assert kernel.variant(torch.float32, *shape) == "ssd_fwd_kernel"
    assert kernel.variant_bwd(torch.float32, *shape) == "ssd_bwd_simt"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_and_init_layout(dtype):
    jcfg = jax_smoke(ARCH).replace(param_dtype=dtype)
    pcfg = get_smoke_config(ARCH).replace(param_dtype=dtype)
    np_tree = _np_params(jcfg, 3)
    if dtype == "bfloat16":
        np_tree = jax.tree_util.tree_map(
            lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), np_tree)
    params = from_jax_params(pcfg, np_tree, "cpu")
    assert len(params["layers"]) == pcfg.num_layers
    assert params["shared"]["lora_a"].shape == (2, pcfg.d_model, 8)
    assert params["shared"]["lora_b"].shape == (2, 8, pcfg.n_heads * pcfg.resolved_head_dim)
    back = to_jax_layout(pcfg, params)
    flat_j = jax.tree_util.tree_leaves_with_path(np_tree)
    flat_p = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_p)
    for path, leaf in flat_j:
        assert np.array_equal(flat_p[path], np.asarray(leaf, np.float32)), path
    own = get_model(pcfg).init(pcfg, torch.Generator().manual_seed(0), "cpu")
    shapes = lambda t: jax.tree_util.tree_map(lambda x: (tuple(x.shape), x.dtype), t)
    bridged = from_jax_params(pcfg, _np_params(jcfg, 3), "cpu")
    if dtype == "float32":
        assert shapes(own) == shapes(bridged)
    assert float(own["shared"]["lora_b"].abs().max()) == 0.0     # as the reference
    full = get_config(ARCH)
    meta = get_model(full).init(full, torch.Generator(), "meta")
    jshapes = jax.eval_shape(lambda: jax_model(jax_config(ARCH)).init(
        jax_config(ARCH), jax.random.PRNGKey(0)))
    assert param_count(meta) == sum(math.prod(x.shape)
                                    for x in jax.tree_util.tree_leaves(jshapes))


def test_init_cache_layout_equals_jax():
    jcfg, pcfg = jax_smoke(ARCH), get_smoke_config(ARCH)
    jc = jax_model(jcfg).init_cache(jcfg, 3, 20)
    pc = get_model(pcfg).init_cache(pcfg, 3, 20, "cpu")
    for key in STATE_KEYS:
        assert pc[key].shape == tuple(jc[key].shape), key
        assert _dtype_name(pc[key].dtype) == jnp.dtype(jc[key].dtype).name, key
    assert pc["attn_k"].shape == (2, 3, 4, 20, 16) and pc["len"] == 0


# -- the loss and its gradients --------------------------------------------------------

def _batch(cfg, B=2, S=40):
    tok = _tokens(cfg, B, S, seed=4)
    lab = np.concatenate([tok[:, 1:], tok[:, :1]], axis=1)
    lab[0, :3] = -100
    return ({"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)},
            {"tokens": torch.from_numpy(tok).long(), "labels": torch.from_numpy(lab).long()})


@pytest.mark.parametrize("impl", ["kernel", "dense"])
def test_loss_and_grads_equal_jax_with_the_lora_path(impl, paths):
    """Every gradient leaf, the LoRA's included (lora_a's gradient is zero
    unless lora_b is not); the kernel path reaches the flash-attention op at
    each application and the scan op at each Mamba layer."""
    jcfg = jax_smoke(ARCH)
    cfg = get_smoke_config(ARCH).replace(attn_impl=impl)
    P = _np_params(jcfg, 0)
    jb, tb = _batch(cfg)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jax_model(jcfg).loss(jcfg, p, jb), has_aux=True)(_jnp(P))
    params = from_jax_params(cfg, P, "cpu")
    loss, grads = loss_and_grads(cfg, params, tb)
    assert abs(float(loss) - float(jl)) / abs(float(jl)) < LOSS_TOL
    gtree = to_jax_layout(cfg, tree_unflatten(params, grads))
    flat, _ = jax.tree_util.tree_flatten_with_path(gtree)
    ref = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jg))
    errs = {jax.tree_util.keystr(p): rel_err(a, b) for (p, a), b in zip(flat, ref)}
    assert len(errs) == len(ref) and max(errs.values()) < GRAD_TOL, errs
    for leaf in ("lora_a", "lora_b"):
        assert np.abs(gtree["shared"][leaf]).max() > 0, leaf
        assert np.abs(gtree["shared"][leaf][1]).max() > 0, leaf   # both sites
    napp = PZ.n_applications(cfg)
    if impl == "kernel":
        assert paths == {"kernel": napp, "dense": 0, "ssd": cfg.num_layers,
                         "ssd_chunked": 0}
    else:
        assert paths == {"kernel": 0, "dense": napp, "ssd": 0,
                         "ssd_chunked": cfg.num_layers}


def test_remat_leaves_loss_and_grads_unchanged():
    cfg = get_smoke_config(ARCH)
    params = from_jax_params(cfg, _np_params(jax_smoke(ARCH), 5), "cpu")
    _, tb = _batch(cfg)
    loss0, grads0 = loss_and_grads(cfg, params, tb)
    for policy in ("full", "comm"):
        loss, grads = loss_and_grads(cfg.replace(remat=policy), params, tb)
        assert float(loss) == float(loss0)
        assert max(rel_err(g, g0) for g, g0 in zip(grads, grads0)) < 1e-6


# -- serving ------------------------------------------------------------------------------

def test_prefill_cache_and_decode_step_equal_jax(paths):
    """Prefill takes the kernels (attention at each application, the scan
    at each layer); the decode steps the dense attention and the recurrent
    step; every cache tensor against the reference's, after
    ``pad_cache_to`` grew the shared attention's K and V."""
    jcfg, pcfg = jax_smoke(ARCH), get_smoke_config(ARCH)
    np_tree = _np_params(jcfg, seed=6)
    jparams, params = _jnp(np_tree), from_jax_params(pcfg, np_tree, "cpu")
    model, jmodel = get_model(pcfg), jax_model(jcfg)
    B, S = 2, 37
    toks = _tokens(jcfg, B, S + 2, seed=7)
    jl, jcache = jmodel.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks[:, :S])})
    pl, cache = model.prefill(pcfg, params, {"tokens": to_torch(toks[:, :S]).long()})
    napp = PZ.n_applications(pcfg)
    assert paths == {"kernel": napp, "dense": 0, "ssd": pcfg.num_layers, "ssd_chunked": 0}
    assert rel_err(pl, np.asarray(jl)) < TOL
    assert cache["len"] == S == int(jcache["len"])
    for key in STATE_KEYS:
        assert cache[key].shape == tuple(jcache[key].shape), key
        assert rel_err(cache[key], np.asarray(jcache[key])) < TOL, key
    jcache = jax_serve.pad_cache_to(jcache, S + 4)
    cache = serve.pad_cache_to(cache, S + 4)
    assert cache["attn_k"].shape[3] == S + 4 == jcache["attn_k"].shape[3]
    for i in range(2):
        tok = toks[:, S + i:S + i + 1]
        jd, jcache = jmodel.decode_step(jcfg, jparams, jcache, {"tokens": jnp.asarray(tok)})
        pd, cache = model.decode_step(pcfg, params, cache, {"tokens": to_torch(tok).long()})
        assert rel_err(pd, np.asarray(jd)) < TOL, i
        assert cache["len"] == S + 1 + i == int(jcache["len"])
        for key in STATE_KEYS:
            assert rel_err(cache[key], np.asarray(jcache[key])) < TOL, (i, key)
    assert paths["dense"] == 2 * napp and paths["kernel"] == napp


def test_forward_hidden_equals_jax():
    jcfg, pcfg = jax_smoke(ARCH), get_smoke_config(ARCH)
    np_tree = _np_params(jcfg, seed=8)
    toks = _tokens(jcfg, 2, 45, seed=9)
    jh = jax_model(jcfg).forward(jcfg, _jnp(np_tree), jnp.asarray(toks))
    ph = get_model(pcfg).forward(pcfg, from_jax_params(pcfg, np_tree, "cpu"),
                                 to_torch(toks).long())
    assert rel_err(ph, np.asarray(jh)) < TOL


def test_prefill_decode_consistency():
    """prefill(S) + decode(token S) == full forward at position S."""
    cfg = get_smoke_config(ARCH)
    model = get_model(cfg)
    params = from_jax_params(cfg, _np_params(jax_smoke(ARCH), 10), "cpu")
    B, S = 2, 33
    tks = to_torch(_tokens(cfg, B, S + 1, seed=11)).long()
    full = model.logits(cfg, params, model.forward(cfg, params, tks))
    logits_p, cache = model.prefill(cfg, params, {"tokens": tks[:, :S]})
    cache = serve.pad_cache_to(cache, S + 4)
    logits_d, _ = model.decode_step(cfg, params, cache, {"tokens": tks[:, S:S + 1]})
    assert rel_err(logits_p[:, -1], full[:, S - 1]) < TOL
    assert rel_err(logits_d[:, 0], full[:, S]) < TOL


def test_decode_on_an_unpadded_cache_raises():
    cfg = get_smoke_config(ARCH)
    model = get_model(cfg)
    params = model.init(cfg, torch.Generator().manual_seed(12), "cpu")
    tks = to_torch(_tokens(cfg, 2, 9, seed=13)).long()
    _, cache = model.prefill(cfg, params, {"tokens": tks[:, :8]})
    with pytest.raises(ValueError, match="pad_cache_to"):
        model.decode_step(cfg, params, cache, {"tokens": tks[:, 8:]})


# -- the launchers ---------------------------------------------------------------------------

def test_greedy_generation_gives_the_jax_tokens():
    jcfg, pcfg = jax_smoke(ARCH), get_smoke_config(ARCH)
    np_tree = _np_params(jcfg, seed=14)
    jparams, params = _jnp(np_tree), from_jax_params(pcfg, np_tree, "cpu")
    B, S, G = 2, 12, 6
    prompts = _tokens(jcfg, B, S, seed=15)
    jmodel = jax_model(jcfg)
    logits, cache = jmodel.prefill(jcfg, jparams, {"tokens": jnp.asarray(prompts)})
    cache = jax_serve.pad_cache_to(cache, S + G)
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None]
    want = [tok]
    for _ in range(G - 1):
        logits, cache = jmodel.decode_step(jcfg, jparams, cache, {"tokens": tok})
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None]
        want.append(tok)
    want = np.asarray(jnp.concatenate(want, axis=1))
    got, _, _ = serve.generate(pcfg, params, to_torch(prompts).long(), G)
    assert np.array_equal(got.numpy(), want)


def test_serve_and_train_launchers_take_zamba2_on_the_cpu(capsys):
    serve.main(["--device", "cpu", "--arch", ARCH, "--preset", "smoke",
                "--batch", "2", "--prompt-len", "20", "--gen", "4"])
    out = capsys.readouterr().out
    assert re.search(rf"\[serve\] {ARCH} on cpu: prefill 2x20 in \d+ ms; decode 3 steps", out)
    result = train.train(get_smoke_config(ARCH), steps=4, seq=64, batch=4, lr=3e-3,
                         device="cpu")
    assert all(map(math.isfinite, result["losses"]))
    assert result["losses"][-1] < result["losses"][0]
    assert to_numpy(result["params"]["shared"]["lora_b"]).any()   # the LoRA learns
