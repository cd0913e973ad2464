"""The MoE slice of the port against the JAX package: the routed expert FFN
(routing, capacity drops, the aux loss), MLA with its compressed cache, the
configs, the parameter bridge, the loss and its gradients, prefill, the
cache, the decode step, Mixtral's ring, a train step, checkpoints across the
packages and the launchers, on the smoke configs of mixtral-8x22b (2 MoE
layers, window 64) and deepseek-v2-lite-16b (1 dense + 2 MoE layers, MLA);
and which attention path each takes (MLA's prefill and training the
kernel's op, as Mixtral's; every decode step the dense path).

Weights and tokens are made with numpy from a seed and handed to both
sides.  Everything is float32 on the CPU.  The chosen experts must be equal
exactly; one dispatch group or FFN is compared at 2e-5 relative to
max|ref|; logits, hidden states and caches at 2e-4; the loss at 1e-5 and
each gradient leaf at 1e-4.  The model-level tests run at capacity factor
8.0 (nothing drops), as the reference's own prefill/decode test does, and
the FFN tests at the configs' 1.25 (tokens drop) too.
"""
import dataclasses
import math
import re
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jax_restore
from repro.checkpoint import save_checkpoint as jax_save
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.launch import serve as jax_serve
from repro.launch.steps import make_train_step as jax_train_step
from repro.models import moe as JM
from repro.models.common import get_model as jax_model
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro_torch.checkpoint import (from_jax_train_state, restore_checkpoint,
                                   save_checkpoint, to_jax_train_state)
from repro_torch.checkpoint.layout import stack_layers
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import serve, train
from repro_torch.launch.steps import loss_and_grads, make_train_step
from repro_torch.models import layers as PL
from repro_torch.models import moe as PM
from repro_torch.models.common import (get_model, param_count, tree_leaves,
                                       tree_map, tree_unflatten)
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.testing import (from_jax_params, rel_err, to_jax_layout,
                                 to_numpy, to_torch)

ARCHS = ["mixtral-8x22b", "deepseek-v2-lite-16b"]
MIXTRAL, DEEPSEEK = ARCHS
TOL = 2e-4
TOL_FN = 2e-5
GRAD_TOL = 1e-4
LOSS_TOL = 1e-5
NO_DROPS = 8.0


def _np_params(jcfg, seed):
    """A numpy tree with the JAX model's structure: weights normal with each
    leaf's own standard deviation, norm scales around 1, so that every
    parameter matters."""
    init = jax_model(jcfg).init(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, name) for v in tree]
        a = np.asarray(tree, dtype=np.float32)
        noise = rng.standard_normal(a.shape).astype(np.float32)
        if name == "scale":
            return 1 + 0.1 * noise
        return noise * a.std()
    return walk(init)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return to_torch(tree)


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)


def _cfgs(arch, **kw):
    return jax_smoke(arch).replace(**kw), get_smoke_config(arch).replace(**kw)


@pytest.fixture
def paths(monkeypatch):
    """Counts the attention calls on the kernel and on the dense path."""
    calls = {"kernel": 0, "dense": 0}

    def count(attr, name):
        fn = getattr(PL, attr)

        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(PL, attr, wrapped)
    count("flash_attention", "kernel")
    count("attention_dense", "dense")
    return calls


# -- the routed expert FFN ------------------------------------------------------------

def _ffn_params(jcfg, seed):
    """One MoE FFN's parameters (the first MoE layer's) as numpy."""
    first = jax.tree_util.tree_map(lambda a: a[0], _np_params(jcfg, seed)["layers"])
    return first["ffn"]


def _jax_choice(jcfg, p, xg):
    """The reference's expert choice for one group: its router lines."""
    logits = jnp.einsum("td,de->te", jnp.asarray(xg), jnp.asarray(p["router"]))
    probs = jax.nn.softmax(logits, axis=-1)
    return np.asarray(jax.lax.top_k(probs.astype(jnp.bfloat16), jcfg.top_k)[1])


@pytest.mark.parametrize("factor", [1.25, NO_DROPS])
@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_group_equals_jax(arch, factor):
    """Three groups through the port's batched ``_dispatch`` against the
    reference's ``_dispatch_group`` on each: the chosen experts exactly, the
    output and the aux; at factor 1.25 some tokens drop (and the port finds
    the same ones: the output would differ by whole expert outputs)."""
    jcfg, pcfg = _cfgs(arch, capacity_factor=factor)
    P = _ffn_params(jcfg, 0)
    G, T = 3, 40
    xg = np.random.default_rng(1).standard_normal((G, T, jcfg.d_model)).astype(np.float32)
    # inputs leaning towards expert 0, so that it overflows at factor 1.25
    lean = P["router"][:, 0] / np.linalg.norm(P["router"][:, 0])
    xg = (xg + 3.0 * lean).astype(np.float32)
    p = _torch(P)
    out, aux = PM._dispatch(pcfg, p, to_torch(xg))
    _, idx, _ = PM.route(pcfg, p, to_torch(xg))
    cap = PM.capacity(pcfg, T)
    dropped = 0
    for g in range(G):
        jo, ja = JM._dispatch_group(jcfg, _jnp(P), jnp.asarray(xg[g]))
        choice = _jax_choice(jcfg, P, xg[g])
        assert np.array_equal(idx[g].numpy(), choice), g
        assert rel_err(out[g], np.asarray(jo)) < TOL_FN, g
        assert abs(float(aux[g]) - float(ja)) < 1e-6 * abs(float(ja)), g
        counts = np.bincount(choice.reshape(-1), minlength=jcfg.n_experts)
        dropped += int(np.maximum(counts - cap, 0).sum())
    assert (dropped > 0) == (factor < NO_DROPS), dropped


@pytest.mark.parametrize("groups", [2, 4])
@pytest.mark.parametrize("factor", [1.25, NO_DROPS])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_equals_jax(arch, factor, groups):
    """``moe_ffn`` over [B, S] = [2, 15]: 30 tokens, which 2 groups divide and
    4 do not (the search lowers it to 3, as the reference's), with the
    shared experts (deepseek)."""
    jcfg, pcfg = _cfgs(arch, capacity_factor=factor, moe_dispatch_groups=groups)
    P = _ffn_params(jcfg, 2)
    x = np.random.default_rng(3).standard_normal((2, 15, jcfg.d_model)).astype(np.float32)
    jo, ja = JM.moe_ffn(jcfg, _jnp(P), jnp.asarray(x))
    p = _torch(P)
    po, pa = PM.moe_ffn(pcfg, p, to_torch(x))
    assert PM.dispatch_groups(pcfg, 30) == (2 if groups == 2 else 3)
    assert rel_err(po, np.asarray(jo)) < TOL_FN
    assert abs(float(pa) - float(ja)) < 1e-6 * abs(float(ja))
    if jcfg.n_shared_experts:    # the shared experts matter
        p0 = dict(p, shared=tree_map(torch.zeros_like, p["shared"]))
        assert rel_err(PM.moe_ffn(pcfg, p0, to_torch(x))[0], np.asarray(jo)) > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_ties_go_to_the_lowest_expert_index(arch):
    """A router of zeros makes every probability 1/E: every token must take
    experts 0..k-1, as ``jax.lax.top_k`` orders ties (``torch.topk`` does
    not), and the outputs agree."""
    jcfg, pcfg = _cfgs(arch, capacity_factor=NO_DROPS)
    P = dict(_ffn_params(jcfg, 4))
    P["router"] = np.zeros_like(P["router"])
    x = np.random.default_rng(5).standard_normal((1, 24, jcfg.d_model)).astype(np.float32)
    p = _torch(P)
    _, idx, gate = PM.route(pcfg, p, to_torch(x))
    k = jcfg.top_k
    assert np.array_equal(_jax_choice(jcfg, P, x[0]), np.tile(np.arange(k), (24, 1)))
    assert torch.equal(idx[0], torch.arange(k).expand(24, k))
    assert torch.allclose(gate, torch.full_like(gate, 1.0 / k))
    jo, _ = JM._dispatch_group(jcfg, _jnp(P), jnp.asarray(x[0]))
    assert rel_err(PM._dispatch(pcfg, p, to_torch(x))[0][0], np.asarray(jo)) < TOL_FN


# -- MLA ---------------------------------------------------------------------------------

def test_mla_block_prefill_and_decode_equal_jax(paths):
    """MLA's prefill (default positions: the kernel's op) and two decode
    steps (explicit positions: the dense path) over its compressed cache,
    which the port writes in place."""
    jcfg, pcfg = _cfgs(DEEPSEEK)
    P = jax.tree_util.tree_map(lambda a: a[0], _np_params(jcfg, 6)["layers"])["attn"]
    p = _torch(P)
    B, S, Smax = 2, 11, 16
    x = np.random.default_rng(7).standard_normal((B, S + 2, jcfg.d_model)).astype(np.float32)
    jy, jst = JM.mla_block(jcfg, _jnp(P), jnp.asarray(x[:, :S]), jnp.arange(S))
    py, pst = PM.mla_block(pcfg, p, to_torch(x[:, :S]))
    assert paths == {"kernel": 1, "dense": 0}
    assert rel_err(py, np.asarray(jy)) < TOL_FN
    for key in ("c_kv", "k_rope"):
        assert rel_err(pst[key], np.asarray(jst[key])) < TOL_FN, key
    pad = lambda a: np.pad(np.asarray(a), ((0, 0), (0, Smax - S), (0, 0)))  # noqa: E731
    jstate = {"c_kv": jnp.asarray(pad(jst["c_kv"])), "k_rope": jnp.asarray(pad(jst["k_rope"])),
              "len": jnp.asarray(S)}
    pstate = {"c_kv": to_torch(pad(jst["c_kv"])), "k_rope": to_torch(pad(jst["k_rope"])),
              "len": S}
    for i in range(2):
        xi = x[:, S + i:S + i + 1]
        jy, jstate = JM.mla_block(jcfg, _jnp(P), jnp.asarray(xi), jnp.asarray([S + i]),
                                  kv_state=jstate)
        cache = pstate["c_kv"]
        py, pstate = PM.mla_block(pcfg, p, to_torch(xi), kv_state=pstate)
        assert pstate["c_kv"] is cache and pstate["len"] == S + i + 1
        assert rel_err(py, np.asarray(jy)) < TOL_FN, i
        for key in ("c_kv", "k_rope"):
            assert rel_err(pstate[key], np.asarray(jstate[key])) < TOL_FN, (i, key)
    assert paths == {"kernel": 1, "dense": 2}
    with pytest.raises(ValueError, match="pad_cache_to"):
        PM.mla_block(pcfg, p, to_torch(x[:, :Smax - S + 1]),
                     kv_state=dict(pstate, len=S + 2))


def test_mla_head_dim_is_not_one_the_kernel_takes():
    """MLA's q/k head dim (nope + rope) is 192 at full width, v's 128: not a
    head dim the kernels take for q, k and v alike, but a pair they take
    (HEAD_DIM_PAIRS), so MLA's prefill runs them on the card.  The smoke
    config's pair (48, 32) is not one: there only the plain versions run."""
    from repro_torch.kernels.flash_attention import kernel as fa
    cfg = get_config(DEEPSEEK)
    pair = (cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim)
    assert pair == (192, 128) and pair in fa.HEAD_DIM_PAIRS
    assert pair[0] not in fa.HEAD_DIMS
    assert fa.variant(torch.bfloat16, *pair) == "fa_fwd_wgmma"
    assert fa.variant_bwd(torch.bfloat16, *pair) == "fa_bwd_wgmma"
    smoke = get_smoke_config(DEEPSEEK)
    small = (smoke.qk_nope_dim + smoke.qk_rope_dim, smoke.v_head_dim)
    assert small == (48, 32) and small not in fa.HEAD_DIM_PAIRS
    with pytest.raises(ValueError, match="no kernel"):
        fa.variant(torch.bfloat16, *small)


# -- configs and the bridge ---------------------------------------------------------------

def _dtype_name(d):
    return str(d).split(".")[-1] if isinstance(d, torch.dtype) else jnp.dtype(d).name


@pytest.mark.parametrize("preset", ["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_jax_config_field_by_field(arch, preset):
    jcfg = jax_config(arch) if preset == "full" else jax_smoke(arch)
    pcfg = get_config(arch) if preset == "full" else get_smoke_config(arch)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_round_trip_init_layout_and_param_count(arch):
    """The JAX tree (MoE layers stacked, deepseek's dense layers a list)
    through ``from_jax_params`` and back, bit for bit; the port's own init
    has the bridged shapes; the full config's parameter count is the
    reference's."""
    jcfg, pcfg = _cfgs(arch)
    np_tree = _np_params(jcfg, 8)
    params = from_jax_params(pcfg, np_tree, "cpu")
    assert len(params["layers"]) == pcfg.num_layers - pcfg.n_dense_layers
    assert len(params.get("dense_layers", [])) == pcfg.n_dense_layers
    back = to_jax_layout(pcfg, params)
    flat_j = jax.tree_util.tree_leaves_with_path(np_tree)
    flat_p = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_p)
    for path, leaf in flat_j:
        assert np.array_equal(flat_p[path], leaf), path
    own = get_model(pcfg).init(pcfg, torch.Generator().manual_seed(0), "cpu")
    shapes = lambda t: jax.tree_util.tree_map(lambda x: (tuple(x.shape), x.dtype), t)  # noqa: E731
    assert shapes(own) == shapes(params)
    full = get_config(arch)
    meta = get_model(full).init(full, torch.Generator(), "meta")
    assert meta["layers"][0]["ffn"]["router"].dtype == torch.float32
    assert meta["layers"][0]["ffn"]["w_gate"].dtype == torch.bfloat16
    jshapes = jax.eval_shape(lambda: jax_model(jax_config(arch)).init(
        jax_config(arch), jax.random.PRNGKey(0)))
    want = {MIXTRAL: 140_630_071_296, DEEPSEEK: 15_706_470_400}[arch]
    assert param_count(meta) == want == sum(
        math.prod(x.shape) for x in jax.tree_util.tree_leaves(jshapes))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_layout_equals_jax(arch):
    jcfg, pcfg = _cfgs(arch)
    jc = jax_model(jcfg).init_cache(jcfg, 3, 80)
    pc = get_model(pcfg).init_cache(pcfg, 3, 80, "cpu")
    assert sorted(pc) == sorted(jc) and pc["len"] == 0
    for part in [k for k in jc if k != "len"]:
        assert sorted(pc[part]) == sorted(jc[part])
        for key, val in pc[part].items():
            assert val.shape == tuple(jc[part][key].shape), (part, key)
            assert _dtype_name(val.dtype) == jnp.dtype(jc[part][key].dtype).name
    if arch == MIXTRAL:     # the window (64) bounds the cache
        assert pc["scan"]["k"].shape[3] == 64


# -- the loss and its gradients -------------------------------------------------------------

def _batch(cfg, B=2, S=40, seed=9):
    tok = _tokens(cfg, B, S, seed)
    lab = np.concatenate([tok[:, 1:], tok[:, :1]], axis=1)
    lab[0, :3] = -100
    return ({"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)},
            {"tokens": torch.from_numpy(tok).long(), "labels": torch.from_numpy(lab).long()})


@pytest.mark.parametrize("impl", ["kernel", "dense"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_equal_jax(arch, impl, paths):
    """The hidden states and aux of ``forward``; the loss with its xent and
    aux parts; every gradient leaf, the router's and deepseek's dense layer's
    included.  Both archs' attention takes the kernel (its op on the CPU:
    the plain forward, and the plain backward under autograd) on the kernel
    path, MLA's at q·k and v head dims that differ."""
    jcfg, cfg = _cfgs(arch, capacity_factor=NO_DROPS)
    cfg = cfg.replace(attn_impl=impl)
    P = _np_params(jcfg, 10)
    params = from_jax_params(cfg, P, "cpu")
    jb, tb = _batch(cfg)
    jh, jaux = jax_model(jcfg).forward(jcfg, _jnp(P), jb["tokens"])
    ph, paux = get_model(cfg).forward(cfg, params, tb["tokens"])
    assert rel_err(ph, np.asarray(jh)) < TOL
    assert abs(float(paux) - float(jaux)) < 1e-5 * abs(float(jaux))
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jax_model(jcfg).loss(jcfg, p, jb), has_aux=True)(_jnp(P))
    _, pm = get_model(cfg).loss(cfg, params, tb)
    for key in ("xent", "aux"):
        assert abs(float(pm[key]) - float(jm[key])) < LOSS_TOL * abs(float(jm[key])), key
    n_moe = cfg.num_layers - cfg.n_dense_layers
    for key in paths:
        paths[key] = 0
    loss, grads = loss_and_grads(cfg, params, tb)
    assert abs(float(loss) - float(jl)) / abs(float(jl)) < LOSS_TOL
    gtree = to_jax_layout(cfg, tree_unflatten(params, grads))
    flat, _ = jax.tree_util.tree_flatten_with_path(gtree)
    ref = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jg))
    errs = {jax.tree_util.keystr(p): rel_err(a, b) for (p, a), b in zip(flat, ref)}
    assert len(errs) == len(ref) and max(errs.values()) < GRAD_TOL, errs
    assert np.abs(gtree["layers"]["ffn"]["router"]).max() > 0
    kernel = cfg.num_layers if impl == "kernel" else 0
    assert paths == {"kernel": kernel, "dense": cfg.num_layers - kernel}
    assert n_moe == 2


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_leaves_loss_and_grads_unchanged(arch):
    _, cfg = _cfgs(arch)
    params = from_jax_params(cfg, _np_params(jax_smoke(arch), 11), "cpu")
    _, tb = _batch(cfg)
    loss0, grads0 = loss_and_grads(cfg, params, tb)
    for policy in ("full", "dots", "comm"):
        loss, grads = loss_and_grads(cfg.replace(remat=policy), params, tb)
        assert float(loss) == float(loss0), policy
        assert max(rel_err(g, g0) for g, g0 in zip(grads, grads0)) < 1e-6, policy


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_equals_jax(arch):
    """One step of ``make_train_step`` against the reference's from the same
    weights (capacity 1.25: tokens drop on both sides alike): the loss at
    1e-5, the params at 1e-5 of each leaf's max but for elements whose
    clipped gradient is within a hundred Adam eps of zero (their update is
    ill-conditioned), each within 2 lr."""
    jcfg, cfg = _cfgs(arch)
    P = _np_params(jcfg, 12)
    jb, tb = _batch(cfg, B=4, S=32, seed=13)
    opt_kw = dict(lr=1e-3, warmup_steps=0)
    jp = _jnp(P)
    jp1, jo1, jm1 = jax.jit(jax_train_step(jcfg, JaxAdamWConfig(**opt_kw)))(
        jp, jax_adamw_init(jp), jb)
    params = from_jax_params(cfg, P, "cpu")
    params, opt, m = make_train_step(cfg, AdamWConfig(**opt_kw))(
        params, adamw_init(params), tb)
    assert abs(float(m["loss"]) - float(jm1["loss"])) / abs(float(jm1["loss"])) < LOSS_TOL
    assert int(opt["step"]) == int(jo1["step"]) == 1
    seen_g = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda x: np.asarray(x) / (1 - AdamWConfig().b1), jo1["m"]))
    n_off, worst_abs, n_params = 0, 0.0, 0
    for a, b, g in zip(jax.tree_util.tree_leaves(to_jax_layout(cfg, params)),
                       jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jp1)),
                       seen_g):
        diff = np.abs(a - b)
        off = diff > 1e-5 * (np.abs(b).max() + 1e-9)
        assert np.all(np.abs(g[off]) < 100 * AdamWConfig().eps)
        n_off += int(off.sum())
        worst_abs = max(worst_abs, float(diff.max()))
        n_params += a.size
    assert n_off <= 1e-4 * n_params and worst_abs <= 2 * opt_kw["lr"], (n_off, worst_abs)


# -- serving --------------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["kernel", "dense"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_cache_and_decode_equal_jax(arch, impl, paths):
    """Prefill logits and every cache leaf; then, after ``pad_cache_to``
    grew the cache (``k``/``v``, or MLA's ``c_kv``/``k_rope``), two decode
    steps, logits and every cache leaf.  The prefill reaches the
    flash-attention op once a layer on the kernel path, MLA's as Mixtral's;
    every decode step the dense path."""
    jcfg, pcfg = _cfgs(arch, capacity_factor=NO_DROPS)
    pcfg = pcfg.replace(attn_impl=impl)
    np_tree = _np_params(jcfg, 14)
    jparams, params = _jnp(np_tree), from_jax_params(pcfg, np_tree, "cpu")
    model, jmodel = get_model(pcfg), jax_model(jcfg)
    B, S, L = 2, 37, pcfg.num_layers
    toks = _tokens(jcfg, B, S + 2, seed=15)
    jl, jcache = jmodel.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks[:, :S])})
    pl, cache = model.prefill(pcfg, params, {"tokens": to_torch(toks[:, :S]).long()})
    kernel = L if impl == "kernel" else 0
    assert paths == {"kernel": kernel, "dense": L - kernel}
    assert rel_err(pl, np.asarray(jl)) < TOL
    assert cache["len"] == S == int(jcache["len"])

    def leaves(pc, jc):
        parts = [k for k in jc if k != "len"]
        assert sorted(parts) == sorted(k for k in pc if k != "len")
        return [(f"{part}/{key}", pc[part][key], np.asarray(jc[part][key]))
                for part in parts for key in jc[part]]

    for name, a, b in leaves(cache, jcache):
        assert a.shape == b.shape and rel_err(a, b) < TOL, name
    jcache = jax_serve.pad_cache_to(jcache, S + 4)
    cache = serve.pad_cache_to(cache, S + 4, pcfg.window)
    for name, a, b in leaves(cache, jcache):
        assert a.shape == b.shape and a.shape[-2] == S + 4, name
    for i in range(2):
        tok = toks[:, S + i:S + i + 1]
        jd, jcache = jmodel.decode_step(jcfg, jparams, jcache, {"tokens": jnp.asarray(tok)})
        pd, cache = model.decode_step(pcfg, params, cache, {"tokens": to_torch(tok).long()})
        assert rel_err(pd, np.asarray(jd)) < TOL, i
        assert cache["len"] == S + 1 + i == int(jcache["len"])
        for name, a, b in leaves(cache, jcache):
            assert rel_err(a, b) < TOL, (i, name)
    assert paths == {"kernel": kernel, "dense": 3 * L - kernel}


def test_mixtral_ring_past_the_window_equals_jax():
    """A prompt of 80 past the smoke window of 64: the window masks the
    prefill, each layer's cache is a ring of the last 64 positions (slot =
    position % 64) equal to the reference's, and three decode steps on the
    ring give the reference's logits and ring, and the port's own prefill of
    the longer prompt."""
    jcfg, pcfg = _cfgs(MIXTRAL, capacity_factor=NO_DROPS)
    np_tree = _np_params(jcfg, 16)
    jparams, params = _jnp(np_tree), from_jax_params(pcfg, np_tree, "cpu")
    model, jmodel = get_model(pcfg), jax_model(jcfg)
    B, S, W = 2, 80, pcfg.window
    toks = _tokens(jcfg, B, S + 3, seed=17)
    jl, jcache = jmodel.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks[:, :S])})
    pl, cache = model.prefill(pcfg, params, {"tokens": to_torch(toks[:, :S]).long()})
    assert rel_err(pl, np.asarray(jl)) < TOL
    assert cache["scan"]["k"].shape[3] == W
    for key in ("k", "v"):
        assert rel_err(cache["scan"][key], np.asarray(jcache["scan"][key])) < TOL, key
    cache = serve.pad_cache_to(cache, S + 3, pcfg.window)      # a ring stays a ring
    assert cache["scan"]["k"].shape[3] == W
    for i in range(3):
        tok = toks[:, S + i:S + i + 1]
        jd, jcache = jmodel.decode_step(jcfg, jparams, jcache, {"tokens": jnp.asarray(tok)})
        pd, cache = model.decode_step(pcfg, params, cache, {"tokens": to_torch(tok).long()})
        assert rel_err(pd, np.asarray(jd)) < TOL, i
        for key in ("k", "v"):
            assert rel_err(cache["scan"][key], np.asarray(jcache["scan"][key])) < TOL, (i, key)
        whole, _ = model.prefill(pcfg, params, {"tokens": to_torch(toks[:, :S + i + 1]).long()})
        assert rel_err(pd, whole) < TOL, i


def test_decode_on_an_unpadded_mla_cache_raises():
    cfg = get_smoke_config(DEEPSEEK)
    model = get_model(cfg)
    params = model.init(cfg, torch.Generator().manual_seed(18), "cpu")
    tks = to_torch(_tokens(cfg, 2, 9, seed=19)).long()
    _, cache = model.prefill(cfg, params, {"tokens": tks[:, :8]})
    with pytest.raises(ValueError, match="pad_cache_to"):
        model.decode_step(cfg, params, cache, {"tokens": tks[:, 8:]})


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generation_gives_the_jax_tokens(arch):
    jcfg, pcfg = _cfgs(arch, capacity_factor=NO_DROPS)
    np_tree = _np_params(jcfg, 20)
    jparams, params = _jnp(np_tree), from_jax_params(pcfg, np_tree, "cpu")
    B, S, G = 2, 12, 6
    prompts = _tokens(jcfg, B, S, seed=21)
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


# -- checkpoints across the packages ----------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoints_cross_between_the_packages(arch):
    """The JAX package's save of {"params", "opt"} restores in the port
    (into a meta template, un-stacked: deepseek's dense layers stay a list)
    bit for bit; the port's save of that state restores in the JAX package
    into its own template bit for bit."""
    jcfg, cfg = _cfgs(arch)
    P = _np_params(jcfg, 22)
    rng = np.random.default_rng(23)
    rand = lambda x: rng.standard_normal(np.shape(x)).astype(np.float32)  # noqa: E731
    state = {"params": P, "opt": {"m": jax.tree_util.tree_map(rand, P),
                                  "v": jax.tree_util.tree_map(lambda x: np.abs(rand(x)), P),
                                  "step": np.asarray(7, np.int32)}}
    params = get_model(cfg).init(cfg, torch.Generator().manual_seed(0), "cpu")
    meta = tree_map(lambda t: t.to("meta"), {"params": params, "opt": adamw_init(params)})
    template = to_jax_train_state(cfg, meta["params"], meta["opt"])
    with tempfile.TemporaryDirectory() as d:
        jax_save(d, 7, state)
        got_params, got_opt = from_jax_train_state(
            cfg, restore_checkpoint(d, 7, template, device="cpu"))
    assert int(got_opt["step"]) == 7
    want = from_jax_params(cfg, P, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got_params), tree_leaves(want)))
    assert len(tree_leaves(stack_layers(cfg, got_params))) == len(jax.tree_util.tree_leaves(P))
    jp = jax_model(jcfg).init(jcfg, jax.random.PRNGKey(0))
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 7, to_jax_train_state(cfg, got_params, got_opt))
        back = jax_restore(d, 7, {"params": jp, "opt": jax_adamw_init(jp)})
    for tree, key in ((P, "params"), (state["opt"]["m"], "m"), (state["opt"]["v"], "v")):
        got_tree = back["params"] if key == "params" else back["opt"][key]
        assert jax.tree_util.tree_structure(got_tree) == jax.tree_util.tree_structure(
            _jnp(tree))
        for a, b in zip(jax.tree_util.tree_leaves(got_tree), jax.tree_util.tree_leaves(tree)):
            assert np.array_equal(np.asarray(a), b), key


# -- the launchers -------------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_serve_and_train_launchers_take_moe_on_the_cpu(arch, capsys):
    serve.main(["--device", "cpu", "--arch", arch, "--preset", "smoke",
                "--batch", "2", "--prompt-len", "20", "--gen", "4"])
    out = capsys.readouterr().out
    assert re.search(rf"\[serve\] {re.escape(arch)} on cpu: prefill 2x20 in \d+ ms; "
                     r"decode 3 steps", out)
    result = train.train(get_smoke_config(arch), steps=4, seq=64, batch=4, lr=3e-3,
                         device="cpu")
    assert all(map(math.isfinite, result["losses"]))
    assert result["losses"][-1] < result["losses"][0]
    assert to_numpy(result["params"]["layers"][0]["ffn"]["router"]).any()
