"""Each function of repro_torch.models.layers against its JAX original, on
inputs made with numpy from a seed and handed to both sides.

Everything here is float32 on the CPU; the two sides differ in the order of
their sums only, so the tolerance is 1e-5 relative to max|ref| (attention and
the blocks, which chain several products: 2e-5).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import layers as JL
from repro_torch.configs import get_smoke_config as pt_smoke
from repro_torch.models import layers as PL
from repro_torch.testing import rel_err, to_torch

TOL = 1e-5
TOL_CHAIN = 2e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(arch="tinyllama-1.1b", **kw):
    return jax_smoke(arch).replace(**kw), pt_smoke(arch).replace(**kw)


def _tree(np_tree, fn):
    return {k: fn(v) for k, v in np_tree.items()}


# -- norms --------------------------------------------------------------------

def test_rms_norm():
    rng = _rng(1)
    x, w = _f32(rng, 2, 5, 64), 1 + 0.1 * _f32(rng, 64)
    ref = JL.rms_norm(jnp.asarray(x), jnp.asarray(w))
    assert rel_err(PL.rms_norm(to_torch(x), to_torch(w)), np.asarray(ref)) < TOL


def test_layer_norm():
    rng = _rng(2)
    x, w, b = _f32(rng, 2, 5, 64), 1 + 0.1 * _f32(rng, 64), 0.1 * _f32(rng, 64)
    ref = JL.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    out = PL.layer_norm(to_torch(x), to_torch(w), to_torch(b))
    assert rel_err(out, np.asarray(ref)) < TOL


@pytest.mark.parametrize("norm", ["rms", "ln"])
def test_init_and_apply_norm(norm):
    jcfg, pcfg = _both(norm=norm)
    jp, pp = JL.init_norm(jcfg, 128), PL.init_norm(pcfg, 128, "cpu")
    assert sorted(jp) == sorted(pp)
    for key in jp:
        assert np.array_equal(np.asarray(jp[key]), pp[key].numpy())
    x = _f32(_rng(3), 2, 4, 128)
    ref = JL.apply_norm(jcfg, jp, jnp.asarray(x))
    assert rel_err(PL.apply_norm(pcfg, pp, to_torch(x)), np.asarray(ref)) < TOL


# -- rope -----------------------------------------------------------------------

@pytest.mark.parametrize("fraction", [1.0, 0.25])
def test_apply_rope(fraction):
    rng = _rng(4)
    x = _f32(rng, 2, 3, 9, 32)
    pos = rng.integers(0, 500, size=(2, 9)).astype(np.int32)
    ref = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0, fraction)
    out = PL.apply_rope(to_torch(x), to_torch(pos), 10000.0, fraction)
    assert out.shape == x.shape
    assert rel_err(out, np.asarray(ref)) < TOL
    if fraction < 1.0:      # the tail passes through untouched
        assert np.array_equal(out[..., 8:].numpy(), x[..., 8:])


def test_rope_for_text_positions_through_mrope_shape_and_mrope_raises():
    jcfg, pcfg = _both()
    x = _f32(_rng(5), 2, 4, 6, 64)
    pos3 = np.broadcast_to(np.arange(6, dtype=np.int32), (2, 3, 6)).copy()
    ref = JL.rope_for(jcfg, jnp.asarray(x), jnp.asarray(pos3))
    assert rel_err(PL.rope_for(pcfg, to_torch(x), to_torch(pos3)),
                   np.asarray(ref)) < TOL
    # M-RoPE, which used to raise here, is ported: with sections it follows
    # the JAX package's apply_mrope (three equal streams here; distinct ones
    # in tests/test_torch_vlm.py)
    ref = JL.rope_for(jcfg.replace(mrope_sections=(8, 12, 12)), jnp.asarray(x),
                      jnp.asarray(pos3))
    assert rel_err(PL.rope_for(pcfg.replace(mrope_sections=(8, 12, 12)), to_torch(x),
                               to_torch(pos3)), np.asarray(ref)) < TOL


# -- attention cores --------------------------------------------------------------

@pytest.mark.parametrize("case", ["causal", "kv_len", "window", "positions",
                                  "softcap", "bidirectional"])
def test_attention_dense(case):
    rng = _rng(6)
    B, Hq, Hkv, Sq, Skv, D = 2, 4, 2, 5, 12, 16
    q, k, v = _f32(rng, B, Hq, Sq, D), _f32(rng, B, Hkv, Skv, D), _f32(rng, B, Hkv, Skv, D)
    qpos, kpos = np.arange(7, 7 + Sq, dtype=np.int32), np.arange(Skv, dtype=np.int32)
    kw = dict(causal=True)
    if case == "kv_len":
        kw["kv_len"] = 9
    elif case == "window":
        kw["window"] = 4
    elif case == "positions":       # a ring: slots out of order, one unused
        kpos = np.roll(kpos, 5)
        kpos[3] = np.iinfo(np.int32).max
    elif case == "softcap":
        kw["softcap"] = 5.0
    elif case == "bidirectional":
        kw["causal"] = False
    ref = JL.attention_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             q_positions=jnp.asarray(qpos),
                             kv_positions=jnp.asarray(kpos), **kw)
    out = PL.attention_dense(to_torch(q), to_torch(k), to_torch(v),
                             q_positions=to_torch(qpos),
                             kv_positions=to_torch(kpos), **kw)
    assert rel_err(out, np.asarray(ref)) < TOL_CHAIN


def test_attention_dispatch():
    """Prefill with default positions takes the kernel's wrapper; explicit
    positions, kv_len, softcap, one query or attn_impl="dense" take the dense
    path.  Both give the JAX dispatcher's values."""
    jcfg, pcfg = _both()
    rng = _rng(7)
    q, k, v = _f32(rng, 1, 4, 10, 32), _f32(rng, 1, 2, 10, 32), _f32(rng, 1, 2, 10, 32)
    ref = np.asarray(JL.attention(jcfg, jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True, window=6))
    tq, tk, tv = to_torch(q), to_torch(k), to_torch(v)
    calls = []
    real = PL.flash_attention
    PL.flash_attention = lambda *a, **kw: calls.append(kw) or real(*a, **kw)
    try:
        out = PL.attention(pcfg, tq, tk, tv, causal=True, window=6)
        assert calls == [{"causal": True, "window": 6}]
        assert rel_err(out, ref) < TOL_CHAIN
        pos = torch.arange(10)
        for cfg, kw in [
            (pcfg, dict(q_positions=pos, kv_positions=pos)),
            (pcfg, dict(kv_len=10)),
            (pcfg.replace(attn_impl="dense"), {}),
        ]:
            out = PL.attention(cfg, tq, tk, tv, causal=True, window=6, **kw)
            assert rel_err(out, ref) < TOL_CHAIN
        PL.attention(pcfg.replace(attn_logit_softcap=5.0), tq, tk, tv)
        PL.attention(pcfg, tq[:, :, :1], tk, tv, causal=False)
        assert len(calls) == 1
    finally:
        PL.flash_attention = real
    with pytest.raises(ValueError, match="attn_impl"):
        PL.attention(pcfg.replace(attn_impl="chunked_packed"), tq, tk, tv)


# -- attention block -----------------------------------------------------------------

def _attn_params(rng, cfg):
    hd = cfg.resolved_head_dim
    s = 1.0 / np.sqrt(cfg.d_model)
    return {"wq": _f32(rng, cfg.d_model, cfg.n_heads * hd, scale=s),
            "wk": _f32(rng, cfg.d_model, cfg.n_kv_heads * hd, scale=s),
            "wv": _f32(rng, cfg.d_model, cfg.n_kv_heads * hd, scale=s),
            "wo": _f32(rng, cfg.n_heads * hd, cfg.d_model, scale=s)}


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "stablelm-3b"])
def test_attn_block_prefill(arch):
    jcfg, pcfg = _both(arch)
    rng = _rng(8)
    p = _attn_params(rng, jcfg)
    x = _f32(rng, 2, 11, jcfg.d_model)
    ref, rst = JL.attn_block(jcfg, _tree(p, jnp.asarray), jnp.asarray(x),
                             jnp.arange(11))
    out, st = PL.attn_block(pcfg, _tree(p, to_torch), to_torch(x))
    assert rel_err(out, np.asarray(ref)) < TOL_CHAIN
    assert rel_err(st["k"], np.asarray(rst["k"])) < TOL
    assert rel_err(st["v"], np.asarray(rst["v"])) < TOL
    # explicit positions give the same through the dense path
    out2, _ = PL.attn_block(pcfg, _tree(p, to_torch), to_torch(x), torch.arange(11))
    assert rel_err(out2, np.asarray(ref)) < TOL_CHAIN


@pytest.mark.parametrize("window,cache_len,cur", [
    (None, 16, 9),      # plain append at slot `len`, tail hidden by kv_len
    (8, 8, 5),          # ring not yet full: unused slots masked by position
    (8, 8, 19),         # ring wrapped: slot = len % window
    (8, 16, 9),         # window over a cache longer than the window: no ring
])
def test_attn_block_decode_append(window, cache_len, cur):
    jcfg, pcfg = _both(window=window)
    rng = _rng(9)
    p = _attn_params(rng, jcfg)
    hd = jcfg.resolved_head_dim
    x = _f32(rng, 2, 1, jcfg.d_model)
    ck = _f32(rng, 2, jcfg.n_kv_heads, cache_len, hd)
    cv = _f32(rng, 2, jcfg.n_kv_heads, cache_len, hd)
    if window is None or cache_len != window:
        ck[:, :, cur:] = 0       # as pad_cache_to leaves the tail
        cv[:, :, cur:] = 0
    pos = np.full((2, 1), cur, dtype=np.int32)
    ref, rst = JL.attn_block(
        jcfg, _tree(p, jnp.asarray), jnp.asarray(x), jnp.asarray(pos),
        window=window,
        kv_state={"k": jnp.asarray(ck), "v": jnp.asarray(cv),
                  "len": jnp.asarray(cur, jnp.int32)})
    tk, tv = to_torch(ck), to_torch(cv)
    out, st = PL.attn_block(pcfg, _tree(p, to_torch), to_torch(x), None,
                            window=window, kv_state={"k": tk, "v": tv, "len": cur})
    assert rel_err(out, np.asarray(ref)) < TOL_CHAIN
    assert st["len"] == cur + 1 == int(rst["len"])
    assert st["k"] is tk and st["v"] is tv          # written in place
    assert rel_err(tk, np.asarray(rst["k"])) < TOL
    assert rel_err(tv, np.asarray(rst["v"])) < TOL
    # explicit [B, S] positions, as the JAX decode step passes them
    out2, _ = PL.attn_block(pcfg, _tree(p, to_torch), to_torch(x), to_torch(pos),
                            window=window,
                            kv_state={"k": to_torch(ck), "v": to_torch(cv), "len": cur})
    assert rel_err(out2, np.asarray(ref)) < TOL_CHAIN


def test_decode_past_the_end_of_a_linear_cache_raises():
    """A decode step that would write past the end of a cache that is not a
    ring raises: torch would assign into an empty slice and drop the new
    token's K and V.  The JAX package clamps the write and overwrites the
    last slot instead; on the tinyllama smoke config in fp32 its logits then
    stand far (0.43 to 0.46 relative, by the weights) from its own decode
    from a padded cache, which the port's padded decode matches.  Recorded here: the reference's
    behaviour, not the port's."""
    import jax

    from repro.models.common import get_model as jax_model
    from repro_torch.models.common import get_model
    from repro_torch.testing import from_jax_params

    jcfg, pcfg = _both()
    rng = _rng(12)
    p = _attn_params(rng, jcfg)
    hd = jcfg.resolved_head_dim
    x = _f32(rng, 2, 1, jcfg.d_model)
    full = {"k": to_torch(_f32(rng, 2, jcfg.n_kv_heads, 8, hd)),
            "v": to_torch(_f32(rng, 2, jcfg.n_kv_heads, 8, hd)), "len": 8}
    with pytest.raises(ValueError, match="past the end of a cache of 8"):
        PL.attn_block(pcfg, _tree(p, to_torch), to_torch(x), None, kv_state=full)

    jmodel, pmodel = jax_model(jcfg), get_model(pcfg)
    init = jmodel.init(jcfg, jax.random.PRNGKey(3))
    np_tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a, dtype=np.float32), init)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_tree)
    params = from_jax_params(pcfg, np_tree, "cpu")
    toks = rng.integers(0, jcfg.vocab_size, size=(2, 9)).astype(np.int32)
    prompt, nxt = toks[:, :8], toks[:, 8:]

    _, jcache = jmodel.prefill(jcfg, jparams, {"tokens": jnp.asarray(prompt)})
    clamped, _ = jmodel.decode_step(jcfg, jparams, jcache, {"tokens": jnp.asarray(nxt)})
    padded = {**jcache, "k": jnp.pad(jcache["k"], [(0, 0)] * 3 + [(0, 4), (0, 0)]),
              "v": jnp.pad(jcache["v"], [(0, 0)] * 3 + [(0, 4), (0, 0)])}
    jd, _ = jmodel.decode_step(jcfg, jparams, padded, {"tokens": jnp.asarray(nxt)})
    # 0.46 with these weights and tokens
    assert rel_err(to_torch(np.asarray(clamped)), np.asarray(jd)) > 0.3

    _, cache = pmodel.prefill(pcfg, params, {"tokens": to_torch(prompt)})
    with pytest.raises(ValueError, match="past the end"):
        pmodel.decode_step(pcfg, params, cache, {"tokens": to_torch(nxt)})
    cache = {**cache, "k": torch.nn.functional.pad(cache["k"], (0, 0, 0, 4)),
             "v": torch.nn.functional.pad(cache["v"], (0, 0, 0, 4))}
    pd, _ = pmodel.decode_step(pcfg, params, cache, {"tokens": to_torch(nxt)})
    assert rel_err(pd, np.asarray(jd)) < 2e-4


def test_attn_block_cross_kv():
    jcfg, pcfg = _both()
    rng = _rng(10)
    p = _attn_params(rng, jcfg)
    hd = jcfg.resolved_head_dim
    x = _f32(rng, 2, 6, jcfg.d_model)
    k, v = _f32(rng, 2, jcfg.n_kv_heads, 13, hd), _f32(rng, 2, jcfg.n_kv_heads, 13, hd)
    ref, rst = JL.attn_block(jcfg, _tree(p, jnp.asarray), jnp.asarray(x),
                             jnp.arange(6), cross_kv=(jnp.asarray(k), jnp.asarray(v)))
    out, st = PL.attn_block(pcfg, _tree(p, to_torch), to_torch(x),
                            cross_kv=(to_torch(k), to_torch(v)))
    assert rst is None and st is None
    assert rel_err(out, np.asarray(ref)) < TOL_CHAIN


# -- ffn, embeddings ---------------------------------------------------------------------

@pytest.mark.parametrize("act", ["swiglu", "relu2", "gelu"])
def test_ffn(act):
    jcfg, pcfg = _both(act=act)
    rng = _rng(11)
    s = 1.0 / np.sqrt(jcfg.d_model)
    p = {"w_up": _f32(rng, jcfg.d_model, jcfg.d_ff, scale=s),
         "w_down": _f32(rng, jcfg.d_ff, jcfg.d_model, scale=s)}
    if act == "swiglu":
        p["w_gate"] = _f32(rng, jcfg.d_model, jcfg.d_ff, scale=s)
    x = _f32(rng, 2, 7, jcfg.d_model)
    ref = JL.ffn(jcfg, _tree(p, jnp.asarray), jnp.asarray(x))
    assert rel_err(PL.ffn(pcfg, _tree(p, to_torch), to_torch(x)),
                   np.asarray(ref)) < TOL_CHAIN


@pytest.mark.parametrize("tie", [False, True])
def test_embed_unembed(tie):
    jcfg, pcfg = _both(tie_embeddings=tie)
    rng = _rng(12)
    emb = {"tok": _f32(rng, jcfg.vocab_size, jcfg.d_model, scale=0.02)}
    head = _f32(rng, jcfg.d_model, jcfg.vocab_size, scale=0.1)
    tokens = rng.integers(0, jcfg.vocab_size, size=(2, 9)).astype(np.int32)
    x = _f32(rng, 2, 9, jcfg.d_model)
    ref = JL.embed(jcfg, _tree(emb, jnp.asarray), jnp.asarray(tokens))
    out = PL.embed(pcfg, _tree(emb, to_torch), to_torch(tokens))
    assert np.array_equal(out.numpy(), np.asarray(ref))
    ref = JL.unembed(jcfg, _tree(emb, jnp.asarray), jnp.asarray(head), jnp.asarray(x))
    out = PL.unembed(pcfg, _tree(emb, to_torch), to_torch(head), to_torch(x))
    assert out.dtype == torch.float32
    assert rel_err(out, np.asarray(ref)) < TOL


def test_unembed_keeps_compute_dtype_without_logits_fp32():
    _, pcfg = _both(logits_fp32=False)
    emb = {"tok": torch.zeros((pcfg.vocab_size, pcfg.d_model), dtype=torch.bfloat16)}
    x = torch.zeros((1, 2, pcfg.d_model), dtype=torch.bfloat16)
    assert PL.unembed(pcfg, emb, None, x).dtype == torch.bfloat16
    assert PL.unembed(pcfg.replace(logits_fp32=True), emb, None, x).dtype == torch.float32


def test_init_shapes_scales_and_dtypes():
    """init_linear / init_attn / init_ffn / init_embed: the JAX package's
    shapes and standard deviations (the random streams differ by design)."""
    import jax
    jcfg, pcfg = _both(d_model=256, d_ff=512)
    gen = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    pairs = [(JL.init_attn(jcfg, key), PL.init_attn(pcfg, gen, "cpu")),
             (JL.init_ffn(jcfg, key), PL.init_ffn(pcfg, gen, device="cpu")),
             (JL.init_embed(jcfg, key), PL.init_embed(pcfg, gen, "cpu"))]
    for jp, pp in pairs:
        assert sorted(jp) == sorted(pp)
        for name in jp:
            assert tuple(jp[name].shape) == tuple(pp[name].shape)
            assert pp[name].dtype == torch.float32
            js, ps = float(np.std(np.asarray(jp[name]))), float(pp[name].std())
            assert abs(ps - js) / js < 0.05, (name, js, ps)
    w = PL.init_linear(gen, 64, 32, torch.bfloat16, scale=0.5, device="cpu")
    assert w.dtype == torch.bfloat16 and w.shape == (64, 32)
