"""The Qwen2-VL slice of the port against the JAX package: M-RoPE, the config,
the parameter bridge, the loss and its gradients (text only, with explicit
3-D positions, with vision embeddings), prefill, the cache and the decode
step, on the qwen2-vl-2b smoke config; and which attention path each case
takes (the dispatch rule).

Weights, tokens and vision embeddings are made with numpy from a seed and
handed to both sides.  Everything is float32 on the CPU.  M-RoPE alone is
compared at 2e-5 relative to max|ref|; logits and caches at 2e-4 (the JAX
package's prefill/decode consistency tolerance); the loss at 1e-5 and each
gradient leaf at 1e-4 (tests/test_torch_train.py's).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.launch import serve as jax_serve
from repro.models import layers as JL
from repro.models.common import get_model as jax_model
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import serve
from repro_torch.launch.steps import loss_and_grads
from repro_torch.models import layers as PL
from repro_torch.models.common import get_model, param_count, tree_unflatten
from repro_torch.models.transformer import VLMTransformer
from repro_torch.testing import (from_jax_params, rel_err, to_jax_layout,
                                 to_numpy, to_torch)

ARCH = "qwen2-vl-2b"
TOL = 2e-4
TOL_FN = 2e-5
GRAD_TOL = 1e-4
LOSS_TOL = 1e-5


def _np_params(jcfg, seed):
    """A numpy tree with the JAX model's structure: weights normal with each
    leaf's own standard deviation, norm scales around 1."""
    init = jax_model(jcfg).init(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        a = np.asarray(tree, dtype=np.float32)
        noise = rng.standard_normal(a.shape).astype(np.float32)
        return 1 + 0.1 * noise if name == "scale" else noise * a.std()
    return walk(init)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)


def _positions(B, S, seed):
    """Three distinct, non-decreasing streams (temporal, height, width) per
    batch row: what a vision frontend would hand in."""
    rng = np.random.default_rng(seed)
    steps = rng.integers(0, 3, size=(B, 3, S))
    return np.cumsum(steps, axis=2).astype(np.int32)


@pytest.fixture
def paths(monkeypatch):
    """Counts the attention calls that took the kernel (``flash_attention``,
    its plain version on the CPU) and the dense path."""
    calls = {"kernel": 0, "dense": 0}
    kernel, dense = PL.flash_attention, PL.attention_dense

    def count(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped
    monkeypatch.setattr(PL, "flash_attention", count("kernel", kernel))
    monkeypatch.setattr(PL, "attention_dense", count("dense", dense))
    return calls


# -- M-RoPE ---------------------------------------------------------------------

@pytest.mark.parametrize("sections,D", [((4, 6, 6), 32), ((16, 24, 24), 128)])
def test_apply_mrope_with_distinct_streams_equals_jax(sections, D):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 11, D)).astype(np.float32)
    pos = _positions(2, 11, seed=1)
    assert not np.array_equal(pos[:, 0], pos[:, 1])
    want = JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
    got = PL.apply_mrope(to_torch(x), to_torch(pos), 1e6, sections)
    assert got.shape == x.shape and got.dtype == torch.float32
    assert rel_err(got, np.asarray(want)) < TOL_FN
    with pytest.raises(ValueError, match="sum to"):
        PL.apply_mrope(to_torch(x), to_torch(pos), 1e6, (1, 2, 3))


def test_rope_for_takes_mrope_for_3d_positions_and_1d_otherwise():
    jcfg, pcfg = jax_smoke(ARCH), get_smoke_config(ARCH)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 4, 9, pcfg.resolved_head_dim)).astype(np.float32)
    pos3 = _positions(2, 9, seed=3)
    pos1 = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9)).copy()
    for pos in (pos3, pos1):
        want = JL.rope_for(jcfg, jnp.asarray(x), jnp.asarray(pos))
        got = PL.rope_for(pcfg, to_torch(x), to_torch(pos))
        assert rel_err(got, np.asarray(want)) < TOL_FN
    # three equal streams are 1-D RoPE over the whole head dim
    equal = np.broadcast_to(pos1[:, None], (2, 3, 9)).copy()
    assert rel_err(PL.rope_for(pcfg, to_torch(x), to_torch(equal)),
                   PL.rope_for(pcfg, to_torch(x), to_torch(pos1))) < 1e-6


# -- config and bridge ----------------------------------------------------------------

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
    if preset == "full":
        assert (pcfg.resolved_head_dim, pcfg.n_heads // pcfg.n_kv_heads) == (128, 6)


def test_bridge_round_trip_and_init_layout():
    jcfg, pcfg = jax_smoke(ARCH), get_smoke_config(ARCH)
    jparams = jax_model(jcfg).init(jcfg, jax.random.PRNGKey(3))
    np_tree = jax.tree_util.tree_map(np.asarray, jparams)
    params = from_jax_params(pcfg, np_tree, "cpu")
    assert len(params["layers"]) == pcfg.num_layers and "lm_head" not in params
    assert param_count(params) == sum(int(x.size) for x in jax.tree_util.tree_leaves(jparams))
    back = to_jax_layout(pcfg, params)
    flat_j = jax.tree_util.tree_leaves_with_path(np_tree)
    flat_p = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_p)
    for path, leaf in flat_j:
        assert np.array_equal(flat_p[path], leaf), path
    own = get_model(pcfg).init(pcfg, torch.Generator().manual_seed(0), "cpu")
    shapes = lambda t: jax.tree_util.tree_map(lambda x: (tuple(x.shape), x.dtype), t)
    assert shapes(own) == shapes(params)
    assert get_model(pcfg) is VLMTransformer


# -- the loss and its gradients --------------------------------------------------------------

def _loss_batch(cfg, case, B=2, S=24, Sv=8):
    rng = np.random.default_rng(4)
    tok = _tokens(cfg, B, S, seed=5)
    lab = np.concatenate([tok[:, 1:], tok[:, :1]], axis=1)
    lab[0, :3] = -100
    batch = {"tokens": tok, "labels": lab}
    if case == "positions":
        batch["positions"] = _positions(B, S, seed=6)
    if case == "vision":
        batch["vision_embeds"] = rng.standard_normal((B, Sv, cfg.d_model)).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: to_torch(v).long() if v.dtype == np.int32 else to_torch(v)
          for k, v in batch.items()}
    return jb, tb


@pytest.mark.parametrize("case,path", [("text", "kernel"), ("positions", "dense"),
                                       ("vision", "kernel")])
def test_loss_and_grads_equal_jax_and_take_the_rule_s_path(case, path, paths):
    """The loss with model-built positions (text only, or vision embeddings
    prepended) takes the kernel in every layer; explicit ``positions`` mask
    by the temporal stream of batch row 0, as the reference does, on the
    dense path."""
    jcfg, cfg = jax_smoke(ARCH), get_smoke_config(ARCH)
    P = _np_params(jcfg, 0)
    jb, tb = _loss_batch(cfg, case)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jax_model(jcfg).loss(jcfg, p, jb), has_aux=True)(_jnp(P))
    params = from_jax_params(cfg, P, "cpu")
    loss, grads = loss_and_grads(cfg, params, tb)
    assert abs(float(loss) - float(jl)) / abs(float(jl)) < LOSS_TOL
    flat, _ = jax.tree_util.tree_flatten_with_path(to_jax_layout(cfg, tree_unflatten(params, grads)))
    ref = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jg))
    errs = {jax.tree_util.keystr(p): rel_err(a, b) for (p, a), b in zip(flat, ref)}
    assert len(errs) == len(ref) and max(errs.values()) < GRAD_TOL, errs
    assert all(float(g.abs().max()) > 0 for g in grads)
    want = {"kernel": cfg.num_layers, "dense": 0}
    if path == "dense":
        want = {"kernel": 0, "dense": cfg.num_layers}
    assert paths == want


def test_kernel_and_dense_impls_give_the_same_loss():
    cfg = get_smoke_config(ARCH)
    params = get_model(cfg).init(cfg, torch.Generator().manual_seed(1), "cpu")
    for case in ("text", "vision"):
        _, tb = _loss_batch(cfg, case)
        lk, gk = loss_and_grads(cfg, params, tb)
        ld, gd = loss_and_grads(cfg.replace(attn_impl="dense"), params, tb)
        assert abs(float(lk) - float(ld)) < 1e-6 * abs(float(ld))
        assert max(rel_err(a, b) for a, b in zip(gk, gd)) < 1e-5


# -- serving ------------------------------------------------------------------------------------

def test_prefill_cache_and_decode_step_equal_jax(paths):
    """Prefill (the reference's 1-D RoPE over arange(S), on the kernel path),
    the cache, and two decode steps (1-D RoPE against the reference's M-RoPE
    on three equal streams, on the dense path)."""
    jcfg, pcfg = jax_smoke(ARCH), get_smoke_config(ARCH)
    np_tree = _np_params(jcfg, seed=7)
    jparams, params = _jnp(np_tree), from_jax_params(pcfg, np_tree, "cpu")
    model, jmodel = get_model(pcfg), jax_model(jcfg)
    B, S = 2, 17
    toks = _tokens(jcfg, B, S + 2, seed=8)
    jl, jcache = jmodel.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks[:, :S])})
    pl, cache = model.prefill(pcfg, params, {"tokens": to_torch(toks[:, :S])})
    assert paths == {"kernel": pcfg.num_layers, "dense": 0}
    assert pl.shape == (B, 1, pcfg.vocab_size)
    assert rel_err(pl, np.asarray(jl)) < TOL
    assert cache["len"] == S == int(jcache["len"])
    for key in ("k", "v"):
        assert rel_err(cache[key], np.asarray(jcache[key])) < TOL
    jcache = jax_serve.pad_cache_to(jcache, S + 4)
    cache = serve.pad_cache_to(cache, S + 4)
    for i in range(2):
        tok = toks[:, S + i:S + i + 1]
        jd, jcache = jmodel.decode_step(jcfg, jparams, jcache, {"tokens": jnp.asarray(tok)})
        pd, cache = model.decode_step(pcfg, params, cache, {"tokens": to_torch(tok)})
        assert rel_err(pd, np.asarray(jd)) < TOL, i
        assert rel_err(cache["k"], np.asarray(jcache["k"])) < TOL, i
    assert paths == {"kernel": pcfg.num_layers, "dense": 2 * pcfg.num_layers}


def test_prefill_decode_consistency_and_both_rope_forms():
    """prefill(S) + decode(token S) == full forward at position S; the
    forward with M-RoPE on three equal streams equals the 1-D one."""
    cfg = get_smoke_config(ARCH)
    model = get_model(cfg)
    params = model.init(cfg, torch.Generator().manual_seed(2), "cpu")
    B, S = 2, 17
    tks = to_torch(_tokens(cfg, B, S + 1, seed=9)).long()
    full = model.logits(cfg, params, model.forward(cfg, params, tks))
    pos3 = torch.arange(S + 1)[None, None].expand(B, 3, S + 1)
    full3 = model.logits(cfg, params, model.forward(cfg, params, tks, pos3))
    assert rel_err(full3, full) < 1e-5
    logits_p, cache = model.prefill(cfg, params, {"tokens": tks[:, :S]})
    cache = serve.pad_cache_to(cache, S + 4)
    logits_d, _ = model.decode_step(cfg, params, cache, {"tokens": tks[:, S:S + 1]})
    assert rel_err(logits_p[:, -1], full[:, S - 1]) < TOL
    assert rel_err(logits_d[:, 0], full[:, S]) < TOL


def test_generate_serves_the_vlm_on_the_cpu():
    cfg = get_smoke_config(ARCH)
    params = get_model(cfg).init(cfg, torch.Generator().manual_seed(3), "cpu")
    prompts = to_torch(_tokens(cfg, 2, 12, seed=10)).long()
    got, t_prefill, t_decode = serve.generate(cfg, params, prompts, 5)
    assert got.shape == (2, 5) and t_prefill > 0 and t_decode > 0
    # greedy tokens are those of repeated prefills
    seq = prompts
    for i in range(5):
        logits, _ = get_model(cfg).prefill(cfg, params, {"tokens": seq})
        nxt = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
        assert torch.equal(nxt, got[:, i:i + 1]), i
        seq = torch.cat([seq, nxt], dim=1)


def test_rope_over_arange_equals_mrope_on_three_equal_streams_bit_for_bit():
    """Why the VLM passes ``None`` positions where the reference builds arange
    on three streams: RoPE and a decode step's attention give the same bits."""
    cfg = get_smoke_config(ARCH)
    params = get_model(cfg).init(cfg, torch.Generator().manual_seed(4), "cpu")
    B, S, cur = 2, 5, 7
    x = torch.randn(B, cfg.n_heads, S, cfg.resolved_head_dim,
                    generator=torch.Generator().manual_seed(5))
    pos = torch.arange(cur, cur + S)
    assert torch.equal(PL.rope_for(cfg, x, pos[None].expand(B, S)),
                       PL.apply_mrope(x, pos[None, None].expand(B, 3, S),
                                      cfg.rope_theta, cfg.mrope_sections))
    h = torch.randn(B, 1, cfg.d_model, generator=torch.Generator().manual_seed(6))
    outs = []
    for positions in (None, torch.tensor([cur])[None, None].expand(B, 3, 1)):
        cache = get_model(cfg).init_cache(cfg, B, 16, "cpu")
        cache["k"].normal_(generator=torch.Generator().manual_seed(8))
        cache["v"].normal_(generator=torch.Generator().manual_seed(9))
        st = {"k": cache["k"][0], "v": cache["v"][0], "len": cur}
        out, new = PL.attn_block(cfg, params["layers"][0]["attn"], h, positions,
                                 kv_state=st)
        outs.append((out, new["k"].clone()))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
