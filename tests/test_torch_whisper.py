"""The Whisper slice of the port against the JAX package: the sinusoids, the
encoder, the cross K/V, the decoder layer, the config, the parameter bridge,
the loss and its gradients, prefill, the cache and the decode step, on the
whisper-large-v3 smoke config (2 encoder and 2 decoder layers, 24 encoder
frames); which path each attention takes; and the launchers' refusal.

Weights, tokens and frame embeddings are made with numpy from a seed and
handed to both sides.  Everything is float32 on the CPU.  Single functions
are compared at 2e-5 relative to max|ref|; logits, hidden states and caches
at 2e-4; the loss at 1e-5 and each gradient leaf at 1e-4.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.models import whisper as JW
from repro.models.common import get_model as jax_model
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import serve, train
from repro_torch.launch.steps import loss_and_grads, make_train_step
from repro_torch.models import layers as PL
from repro_torch.models import whisper as PW
from repro_torch.models.common import get_model, param_count, tree_unflatten
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.testing import from_jax_params, rel_err, to_jax_layout, to_torch

ARCH = "whisper-large-v3"
TOL = 2e-4
TOL_FN = 2e-5
GRAD_TOL = 1e-4
LOSS_TOL = 1e-5
S_ENC = 24


def _np_params(jcfg, seed):
    """A numpy tree with the JAX model's structure: weights normal with each
    leaf's own standard deviation, layer-norm scales around 1 and small
    biases, so that every parameter matters."""
    init = jax_model(jcfg).init(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        a = np.asarray(tree, dtype=np.float32)
        noise = rng.standard_normal(a.shape).astype(np.float32)
        if name == "scale":
            return 1 + 0.1 * noise
        if name == "bias":
            return 0.1 * noise
        return noise * a.std()
    return walk(init)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _inputs(cfg, B, S, seed, s_enc=S_ENC):
    rng = np.random.default_rng(seed)
    enc = rng.standard_normal((B, s_enc, cfg.d_model)).astype(np.float32)
    tok = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    return enc, tok


def _setup(seed):
    jcfg, pcfg = jax_smoke(ARCH), get_smoke_config(ARCH)
    P = _np_params(jcfg, seed)
    return jcfg, pcfg, _jnp(P), from_jax_params(pcfg, P, "cpu")


@pytest.fixture
def paths(monkeypatch):
    """Counts the attention calls on the kernel and the dense path, by mask:
    causal or not."""
    calls = {"kernel": 0, "kernel_noncausal": 0, "dense": 0}
    kernel, dense = PL.flash_attention, PL.attention_dense

    def k(*args, **kwargs):
        calls["kernel" if kwargs.get("causal", True) else "kernel_noncausal"] += 1
        return kernel(*args, **kwargs)

    def d(*args, **kwargs):
        calls["dense"] += 1
        return dense(*args, **kwargs)
    monkeypatch.setattr(PL, "flash_attention", k)
    monkeypatch.setattr(PL, "attention_dense", d)
    return calls


# -- the pieces ------------------------------------------------------------------------

@pytest.mark.parametrize("length", [S_ENC, 1500])
def test_sinusoids_equal_jax(length):
    """At the tests' 24 frames at 2e-5.  Over the full config's 1500 the
    two packages' fp32 ``exp`` may round a frequency (at most 1) one ulp
    apart, which frame t turns into an angle t·2⁻²³ apart: bounded by twice
    that at the last frame."""
    got, want = PW.sinusoids(length, 1280), np.asarray(JW.sinusoids(length, 1280))
    assert got.shape == want.shape == (length, 1280)
    if length == S_ENC:
        assert rel_err(got, want) < TOL_FN
    else:
        assert float(np.abs(got.numpy() - want).max()) < 2 * length * 2.0 ** -23


def test_encoder_and_cross_kv_equal_jax(paths):
    """The encoder's bidirectional self-attention takes the kernel, non-causal,
    at every layer; rope_fraction 0 leaves q and k unrotated."""
    jcfg, pcfg, jp, pp = _setup(1)
    enc, _ = _inputs(pcfg, 2, 1, seed=2)
    jm = JW.encode(jcfg, jp, jnp.asarray(enc))
    pm = PW.encode(pcfg, pp, to_torch(enc))
    assert rel_err(pm, np.asarray(jm)) < TOL
    assert paths == {"kernel": 0, "kernel_noncausal": pcfg.enc_layers, "dense": 0}
    jk, jv = JW._cross_kv(jcfg, jp, jm)
    pk, pv = PW._cross_kv(pcfg, pp, pm)
    assert len(pk) == pcfg.dec_layers
    assert rel_err(torch.stack(pk), np.asarray(jk)) < TOL
    assert rel_err(torch.stack(pv), np.asarray(jv)) < TOL


def test_decoder_layer_equals_jax(paths):
    """Causal self-attention and the cross-attention over Skv != Sq frames,
    both on the kernel."""
    jcfg, pcfg, jp, pp = _setup(3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, pcfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, S_ENC, pcfg.d_model)).astype(np.float32)
    jk, jv = JW._cross_kv(jcfg, jp, jnp.asarray(mem))
    pk, pv = PW._cross_kv(pcfg, pp, to_torch(mem))
    jlp = jax.tree_util.tree_map(lambda a: a[0], jp["dec_layers"])
    jy, jst = JW.dec_layer_fwd(jcfg, jlp, jnp.asarray(x), jnp.arange(9), jk[0], jv[0])
    py, pst = PW.dec_layer_fwd(pcfg, pp["dec_layers"][0], to_torch(x), pk[0], pv[0])
    assert rel_err(py, np.asarray(jy)) < TOL_FN
    assert rel_err(pst["k"], np.asarray(jst["k"])) < TOL_FN
    assert paths == {"kernel": 1, "kernel_noncausal": 1, "dense": 0}


# -- config and bridge --------------------------------------------------------------------

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
        from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS
        assert pcfg.resolved_head_dim in HEAD_DIMS


def test_bridge_round_trip_and_init_layout():
    jcfg, pcfg = jax_smoke(ARCH), get_smoke_config(ARCH)
    jparams = jax_model(jcfg).init(jcfg, jax.random.PRNGKey(3))
    np_tree = jax.tree_util.tree_map(np.asarray, jparams)
    params = from_jax_params(pcfg, np_tree, "cpu")
    assert len(params["enc_layers"]) == pcfg.enc_layers
    assert len(params["dec_layers"]) == pcfg.dec_layers
    assert params["pos_embed"].shape == (pcfg.max_target_positions, pcfg.d_model)
    back = to_jax_layout(pcfg, params)
    flat_j = jax.tree_util.tree_leaves_with_path(np_tree)
    flat_p = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_p)
    for path, leaf in flat_j:
        assert np.array_equal(flat_p[path], leaf), path
    own = get_model(pcfg).init(pcfg, torch.Generator().manual_seed(0), "cpu")
    shapes = lambda t: jax.tree_util.tree_map(lambda x: (tuple(x.shape), x.dtype), t)
    assert shapes(own) == shapes(params)
    full = get_config(ARCH)
    meta = get_model(full).init(full, torch.Generator(), "meta")
    jshapes = jax.eval_shape(lambda: jax_model(jax_config(ARCH)).init(
        jax_config(ARCH), jax.random.PRNGKey(0)))
    assert param_count(meta) == sum(math.prod(x.shape)
                                    for x in jax.tree_util.tree_leaves(jshapes))


def test_init_cache_layout_equals_jax():
    jcfg, pcfg = jax_smoke(ARCH), get_smoke_config(ARCH)
    jc = jax_model(jcfg).init_cache(jcfg, 3, 20, enc_len=S_ENC)
    pc = get_model(pcfg).init_cache(pcfg, 3, 20, enc_len=S_ENC, device="cpu")
    for key in ("k", "v", "cross_k", "cross_v"):
        assert pc[key].shape == tuple(jc[key].shape), key
    assert get_model(pcfg).init_cache(pcfg, 1, 4, device="cpu")["cross_k"].shape[3] == 1500
    assert pc["len"] == 0


# -- the loss and its gradients ----------------------------------------------------------------

def _batch(cfg, B=2, S=12, seed=5):
    enc, tok = _inputs(cfg, B, S, seed)
    lab = np.concatenate([tok[:, 1:], tok[:, :1]], axis=1)
    lab[0, :3] = -100
    jb = {"enc_embeds": jnp.asarray(enc), "tokens": jnp.asarray(tok),
          "labels": jnp.asarray(lab)}
    tb = {"enc_embeds": to_torch(enc), "tokens": torch.from_numpy(tok).long(),
          "labels": torch.from_numpy(lab).long()}
    return jb, tb


@pytest.mark.parametrize("impl", ["kernel", "dense"])
def test_loss_and_grads_equal_jax(impl, paths):
    """Every gradient leaf; on the kernel path the encoder's and the
    cross-attention's non-causal calls and the decoder's causal ones all go
    through the flash-attention op."""
    jcfg = jax_smoke(ARCH)
    cfg = get_smoke_config(ARCH).replace(attn_impl=impl)
    P = _np_params(jcfg, 0)
    jb, tb = _batch(cfg)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jax_model(jcfg).loss(jcfg, p, jb), has_aux=True)(_jnp(P))
    params = from_jax_params(cfg, P, "cpu")
    loss, grads = loss_and_grads(cfg, params, tb)
    assert abs(float(loss) - float(jl)) / abs(float(jl)) < LOSS_TOL
    flat, _ = jax.tree_util.tree_flatten_with_path(
        to_jax_layout(cfg, tree_unflatten(params, grads)))
    ref = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jg))
    errs = {jax.tree_util.keystr(p): rel_err(a, b) for (p, a), b in zip(flat, ref)}
    assert len(errs) == len(ref) and max(errs.values()) < GRAD_TOL, errs
    Le, Ld = cfg.enc_layers, cfg.dec_layers
    if impl == "kernel":
        assert paths == {"kernel": Ld, "kernel_noncausal": Le + Ld, "dense": 0}
    else:
        assert paths == {"kernel": 0, "kernel_noncausal": 0, "dense": Le + 2 * Ld}


def test_train_step_learns_and_remat_leaves_grads_unchanged():
    cfg = get_smoke_config(ARCH)
    params = from_jax_params(cfg, _np_params(jax_smoke(ARCH), 6), "cpu")
    _, tb = _batch(cfg, seed=7)
    loss0, grads0 = loss_and_grads(cfg, params, tb)
    for policy in ("full", "comm"):
        loss, grads = loss_and_grads(cfg.replace(remat=policy), params, tb)
        assert float(loss) == float(loss0)
        assert max(rel_err(g, g0) for g, g0 in zip(grads, grads0)) < 1e-6
    step = make_train_step(cfg, AdamWConfig(lr=3e-3, warmup_steps=0), grad_accum=2)
    opt = adamw_init(params)
    losses = []
    for _ in range(3):
        params, opt, m = step(params, opt, tb)
        losses.append(float(m["loss"]))
    assert all(map(math.isfinite, losses)) and losses[-1] < losses[0]


# -- serving --------------------------------------------------------------------------------------

def test_prefill_cache_and_decode_step_equal_jax(paths):
    jcfg, pcfg, jp, pp = _setup(8)
    model, jmodel = get_model(pcfg), jax_model(jcfg)
    B, S = 2, 17
    enc, toks = _inputs(pcfg, B, S + 2, seed=9)
    jl, jcache = jmodel.prefill(jcfg, jp, {"enc_embeds": jnp.asarray(enc),
                                           "tokens": jnp.asarray(toks[:, :S])})
    pl, cache = model.prefill(pcfg, pp, {"enc_embeds": to_torch(enc),
                                         "tokens": to_torch(toks[:, :S]).long()})
    Le, Ld = pcfg.enc_layers, pcfg.dec_layers
    assert paths == {"kernel": Ld, "kernel_noncausal": Le + Ld, "dense": 0}
    assert rel_err(pl, np.asarray(jl)) < TOL
    assert cache["len"] == S == int(jcache["len"])
    for key in ("k", "v", "cross_k", "cross_v"):
        assert cache[key].shape == tuple(jcache[key].shape), key
        assert rel_err(cache[key], np.asarray(jcache[key])) < TOL, key
    # the reference's consistency test pads k and v by hand
    jcache["k"] = jnp.pad(jcache["k"], ((0, 0),) * 3 + ((0, 4), (0, 0)))
    jcache["v"] = jnp.pad(jcache["v"], ((0, 0),) * 3 + ((0, 4), (0, 0)))
    cache = serve.pad_cache_to(cache, S + 4)
    assert cache["k"].shape == tuple(jcache["k"].shape)
    assert cache["cross_k"].shape[3] == S_ENC          # not a sequence key
    for i in range(2):
        tok = toks[:, S + i:S + i + 1]
        jd, jcache = jmodel.decode_step(jcfg, jp, jcache, {"tokens": jnp.asarray(tok)})
        pd, cache = model.decode_step(pcfg, pp, cache, {"tokens": to_torch(tok).long()})
        assert rel_err(pd, np.asarray(jd)) < TOL, i
        assert cache["len"] == S + 1 + i == int(jcache["len"])
        assert rel_err(cache["k"], np.asarray(jcache["k"])) < TOL, i
    assert paths["dense"] == 2 * 2 * Ld                 # self and cross, each step


def test_prefill_decode_consistency():
    """As tests/test_models_smoke.py's for whisper: prefill(S) + decode(token
    S) == the teacher-forced decoder at position S, 24 encoder frames."""
    cfg = get_smoke_config(ARCH)
    model = get_model(cfg)
    params = model.init(cfg, torch.Generator().manual_seed(1), "cpu")
    B, S = 2, 17
    enc, tks = _inputs(cfg, B, S + 1, seed=10)
    enc, tks = to_torch(enc), to_torch(tks).long()
    memory = PW.encode(cfg, params, enc)
    with torch.no_grad():
        full = PW._unembed(cfg, params, model.decode_fwd(cfg, params, tks, memory))
    logits_p, cache = model.prefill(cfg, params, {"enc_embeds": enc, "tokens": tks[:, :S]})
    cache = serve.pad_cache_to(cache, S + 4)
    logits_d, _ = model.decode_step(cfg, params, cache, {"tokens": tks[:, S:S + 1]})
    assert rel_err(logits_p[:, -1], full[:, S - 1]) < TOL
    assert rel_err(logits_d[:, 0], full[:, S]) < TOL


# -- the launchers -----------------------------------------------------------------------------

def test_launchers_refuse_whisper_with_the_reference_s_messages():
    with pytest.raises(SystemExit, match="whisper serving needs audio frontend inputs"):
        serve.main(["--device", "cpu", "--arch", ARCH])
    cfg = get_smoke_config(ARCH)
    with pytest.raises(SystemExit, match="use a seq2seq driver for whisper"):
        train.main(["--device", "cpu", "--arch", ARCH, "--steps", "1"])
    with pytest.raises(SystemExit, match="seq2seq"):
        train.train(cfg, steps=1, seq=8, batch=2, device="cpu")


def test_generate_serves_whisper_with_its_frames():
    """``launch.serve.generate`` with ``enc_embeds`` in ``extra``: greedy
    tokens are those of repeated prefills over the same frames."""
    cfg = get_smoke_config(ARCH)
    model = get_model(cfg)
    params = model.init(cfg, torch.Generator().manual_seed(3), "cpu")
    enc, tks = _inputs(cfg, 2, 12, seed=11)
    enc, prompts = to_torch(enc), to_torch(tks).long()
    got, t_prefill, t_decode = serve.generate(cfg, params, prompts, 5,
                                              extra={"enc_embeds": enc})
    assert got.shape == (2, 5) and t_prefill > 0 and t_decode > 0
    seq = prompts
    for i in range(5):
        logits, _ = model.prefill(cfg, params, {"enc_embeds": enc, "tokens": seq})
        nxt = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
        assert torch.equal(nxt, got[:, i:i + 1]), i
        seq = torch.cat([seq, nxt], dim=1)


def test_decode_past_max_target_positions_raises():
    """A decode step at or past ``max_target_positions`` raises, and names
    it: the learned position table has no row there, and slicing it past its
    end gave an empty slice that died later in a reshape.  The JAX package
    clamps the slice's start (``dynamic_slice_in_dim``), so every token at or
    past the end silently reuses the table's last row; recorded here, the
    reference's behaviour, not the port's."""
    jcfg, pcfg, jp, pp = _setup(12)
    assert pcfg.max_target_positions == jcfg.max_target_positions == 256
    model, jmodel = get_model(pcfg), jax_model(jcfg)
    S = pcfg.max_target_positions - 1
    enc, toks = _inputs(pcfg, 1, S + 2, seed=13)
    _, jcache = jmodel.prefill(jcfg, jp, {"enc_embeds": jnp.asarray(enc),
                                         "tokens": jnp.asarray(toks[:, :S])})
    _, cache = model.prefill(pcfg, pp, {"enc_embeds": to_torch(enc),
                                        "tokens": to_torch(toks[:, :S]).long()})
    jcache["k"] = jnp.pad(jcache["k"], ((0, 0),) * 3 + ((0, 4), (0, 0)))
    jcache["v"] = jnp.pad(jcache["v"], ((0, 0),) * 3 + ((0, 4), (0, 0)))
    cache = serve.pad_cache_to(cache, S + 4)
    # position 255, the table's last row: both sides agree
    tok = toks[:, S:S + 1]
    jd, jcache = jmodel.decode_step(jcfg, jp, jcache, {"tokens": jnp.asarray(tok)})
    pd, cache = model.decode_step(pcfg, pp, cache, {"tokens": to_torch(tok).long()})
    assert rel_err(pd, np.asarray(jd)) < TOL and cache["len"] == 256
    # position 256: the port raises; the reference runs on row 255
    tok = toks[:, S + 1:S + 2]
    with pytest.raises(ValueError, match="max_target_positions 256"):
        model.decode_step(pcfg, pp, cache, {"tokens": to_torch(tok).long()})
    jd, _ = jmodel.decode_step(jcfg, jp, jcache, {"tokens": jnp.asarray(tok)})
    assert np.isfinite(np.asarray(jd)).all()
    clamped = jax.lax.dynamic_slice_in_dim(jp["pos_embed"], 256, 1, 0)
    np.testing.assert_array_equal(np.asarray(clamped)[0], np.asarray(jp["pos_embed"])[255])
