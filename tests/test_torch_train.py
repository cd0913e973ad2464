"""The training slice of the port against the JAX package: the loss, its
gradients, the remat policies, AdamW, the train step with and without
gradient accumulation, the data pipeline's copy, the Eq.-10 estimator's copy,
and the launchers, on the CPU.

Weights, tokens and gradients are made with numpy from a seed and handed to
both sides; everything is float32.  Tolerances (relative to max|reference|):
loss and each gradient leaf 1e-4 (products and sums in another order through
two layers); ``adamw_update`` 1e-6 (the same formula on the same numbers);
train-step losses 1e-5.  Parameters after two train steps agree at 1e-5
except on elements whose gradient is within a hundred Adam eps of zero,
where m̂/(√v̂ + eps) turns a gradient difference at rounding level into an
update difference of up to lr: those elements are counted, and each must be
one of them.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.core.estimator import min_slots as jax_min_slots
from repro.data import DataConfig as JaxDataConfig
from repro.data import ShardedDataset as JaxShardedDataset
from repro.data import make_batch_iter as jax_batch_iter
from repro.elastic.fleet import EstimatorBridge as JaxBridge
from repro.launch.steps import make_train_step as jax_train_step
from repro.models import layers as JL
from repro.models.common import get_model as jax_model
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import cosine_lr as jax_cosine_lr
from repro_torch.configs import get_smoke_config
from repro_torch.core.estimator import min_slots
from repro_torch.data import DataConfig, ShardedDataset, make_batch_iter
from repro_torch.elastic.fleet import EstimatorBridge
from repro_torch.launch import train
from repro_torch.launch.steps import loss_and_grads, make_train_step
from repro_torch.models import layers as PL
from repro_torch.models.common import get_model, tree_leaves, tree_unflatten
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, cosine_lr
from repro_torch.testing import (from_jax_opt_state, from_jax_params, rel_err,
                                 to_jax_layout, to_torch)

GRAD_TOL = 1e-4
ADAMW_TOL = 1e-6
LOSS_TOL = 1e-5
PARAM_TOL = 1e-5
# |g| (as Adam sees it, after the clip) below which an element's update is
# ill-conditioned: the first step's update lr·g/(|g| + eps) has derivative
# lr·eps/(|g| + eps)², which times a gradient difference at the grad test's
# level (about 5e-8 here) stays under PARAM_TOL of the params only above about
# a hundred eps
NEAR_ZERO_GRAD = 100 * AdamWConfig().eps

# stablelm-3b brings LayerNorm (scale and bias), partial rotary and MHA;
# mamba2-1.3b the SSD scan and its backward
ARCHS = ["tinyllama-1.1b", "llama3.2-3b", "stablelm-3b", "mamba2-1.3b"]


def _np_params(jcfg, seed):
    """A numpy parameter tree with the JAX package's structure and scales:
    normal weights with each leaf's own standard deviation, norm scales
    around 1 and small norm biases, so that every parameter matters.  A
    Mamba-2 block's D, A_log and dt_bias (constant at init, so their standard
    deviation is 0) are spread as in tests/test_torch_mamba2.py: a leaf that
    starts at 0 would hold its params to 1e-5 of the largest of two Adam
    steps, a rounding-level difference."""
    init = jax_model(jcfg).init(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        a = np.asarray(tree, dtype=np.float32)
        noise = rng.standard_normal(a.shape).astype(np.float32)
        if name in ("scale", "D"):
            return 1 + 0.1 * noise
        if name == "bias":
            return 0.1 * noise
        if name == "A_log":
            return 0.3 * noise
        if name == "dt_bias":
            return -1.0 + 0.5 * noise
        return noise * a.std()
    return walk(init)


def _batch(vocab, seed=1, B=4, S=32):
    """numpy tokens and next-token labels, a few labels masked (-100)."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, (B, S)).astype(np.int32)
    lab = np.concatenate([tok[:, 1:], tok[:, :1]], axis=1)
    lab[0, :5] = -100
    return ({"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)},
            {"tokens": torch.from_numpy(tok).long(),
             "labels": torch.from_numpy(lab).long()})


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaf_errs(port_tree_np, jax_tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(port_tree_np)
    ref = jax.tree_util.tree_leaves(_np(jax_tree))
    return {jax.tree_util.keystr(p): rel_err(a, b) for (p, a), b in zip(flat, ref)}


# -- loss ---------------------------------------------------------------------

def test_softmax_xent_matches_jax_with_masked_labels():
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((3, 7, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    labels[1, 2:] = -100
    labels[2, 0] = -100
    ref = float(JL.softmax_xent(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(PL.softmax_xent(to_torch(logits), torch.from_numpy(labels).long()))
    assert abs(got - ref) / abs(ref) < ADAMW_TOL
    none = np.full((3, 7), -100, np.int32)        # every label masked: 0, not nan
    assert float(PL.softmax_xent(to_torch(logits), torch.from_numpy(none))) == 0.0


@pytest.mark.parametrize("impl", ["kernel", "dense"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax_value_and_grad(arch, impl):
    jcfg = jax_smoke(arch)
    cfg = get_smoke_config(arch).replace(attn_impl=impl)
    P = _np_params(jcfg, 0)
    jb, tb = _batch(cfg.vocab_size)
    (jl, jaux), jg = jax.value_and_grad(
        lambda p: jax_model(jcfg).loss(jcfg, p, jb), has_aux=True)(_jnp(P))
    params = from_jax_params(cfg, P, "cpu")
    loss, grads = loss_and_grads(cfg, params, tb)
    aux = get_model(cfg).loss(cfg, params, tb)[1]
    assert abs(float(loss) - float(jl)) / abs(float(jl)) < GRAD_TOL
    assert abs(float(aux["loss"]) - float(jaux["loss"])) / abs(float(jl)) < GRAD_TOL
    errs = _leaf_errs(to_jax_layout(cfg, tree_unflatten(params, grads)), jg)
    assert len(errs) == len(jax.tree_util.tree_leaves(jg))
    assert max(errs.values()) < GRAD_TOL, errs
    # the kernel path must give attention its gradient: every leaf moves
    assert all(float(g.abs().max()) > 0 for g in grads)


def test_parallel_residual_loss_and_grads_match_jax():
    jcfg = jax_smoke("tinyllama-1.1b").replace(parallel_residual=True)
    cfg = get_smoke_config("tinyllama-1.1b").replace(parallel_residual=True)
    P = _np_params(jcfg, 2)
    jb, tb = _batch(cfg.vocab_size, seed=3)
    jl, jg = jax.value_and_grad(lambda p: jax_model(jcfg).loss(jcfg, p, jb)[0])(_jnp(P))
    params = from_jax_params(cfg, P, "cpu")
    loss, grads = loss_and_grads(cfg, params, tb)
    assert abs(float(loss) - float(jl)) / abs(float(jl)) < GRAD_TOL
    errs = _leaf_errs(to_jax_layout(cfg, tree_unflatten(params, grads)), jg)
    assert max(errs.values()) < GRAD_TOL, errs


def test_loss_and_grads_leave_the_params_untouched():
    cfg = get_smoke_config("tinyllama-1.1b")
    params = get_model(cfg).init(cfg, torch.Generator().manual_seed(0), "cpu")
    before = [p.clone() for p in tree_leaves(params)]
    _, tb = _batch(cfg.vocab_size)
    loss_and_grads(cfg, params, tb)
    for p, q in zip(tree_leaves(params), before):
        assert torch.equal(p, q) and not p.requires_grad and p.grad is None


@pytest.mark.parametrize("policy", ["full", "dots", "comm", "comm_lite"])
@pytest.mark.parametrize("parallel", [False, True])
def test_remat_leaves_loss_and_grads_unchanged(policy, parallel):
    cfg = get_smoke_config("tinyllama-1.1b").replace(parallel_residual=parallel)
    params = get_model(cfg).init(cfg, torch.Generator().manual_seed(4), "cpu")
    _, tb = _batch(cfg.vocab_size, seed=5)
    loss0, grads0 = loss_and_grads(cfg.replace(remat="none"), params, tb)
    loss, grads = loss_and_grads(cfg.replace(remat=policy), params, tb)
    assert float(loss) == float(loss0)
    for g, g0 in zip(grads, grads0):
        assert rel_err(g, g0) < 1e-6


def test_remat_refuses_an_unknown_policy():
    cfg = get_smoke_config("tinyllama-1.1b").replace(remat="everything")
    with pytest.raises(ValueError, match="remat"):
        PL.remat_wrap(cfg, lambda x: x)


def test_inference_forward_matches_the_loss_path():
    """forward (no grad) and the grad-enabled _forward give the same hidden
    states; forward builds no graph."""
    cfg = get_smoke_config("llama3.2-3b").replace(remat="full")
    model = get_model(cfg)
    params = model.init(cfg, torch.Generator().manual_seed(6), "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 20), generator=torch.Generator().manual_seed(7))
    hidden = model.forward(cfg, params, tokens)
    assert hidden.grad_fn is None
    assert torch.equal(hidden, model._forward(cfg, params, tokens))


# -- AdamW ----------------------------------------------------------------------

def test_adamw_descends_quadratic():
    cfg = AdamWConfig(lr=0.1, warmup_steps=0, weight_decay=0.0, total_steps=200)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = adamw_init(params)
    for _ in range(150):
        g = {"w": 2 * params["w"]}                # grad of sum(w ** 2)
        params, state = adamw_update(cfg, params, g, state)
    assert float(params["w"].abs().max()) < 0.05


def test_grad_clip_bounds_update():
    cfg = AdamWConfig(lr=1.0, clip_norm=1e-3, warmup_steps=0, weight_decay=0.0)
    params = {"w": torch.zeros(4)}
    state = adamw_init(params)
    p2, _ = adamw_update(cfg, params, {"w": torch.full((4,), 1e6)}, state)
    assert bool(torch.isfinite(p2["w"]).all())


def test_cosine_schedule_shape():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    lrs = [float(cosine_lr(cfg, torch.tensor(s))) for s in range(101)]
    assert lrs[0] < lrs[10]                       # warmup rises
    assert abs(lrs[10] - 1.0) < 1e-6
    assert lrs[100] == pytest.approx(0.1, rel=1e-3)


def test_cosine_schedule_matches_jax():
    for cfg in (dict(lr=3e-4, warmup_steps=7, total_steps=50),
                dict(lr=1e-3, warmup_steps=0, total_steps=10)):
        for s in (0, 1, 3, 7, 8, 30, 50, 60):
            ref = float(jax_cosine_lr(JaxAdamWConfig(**cfg), jnp.int32(s)))
            got = float(cosine_lr(AdamWConfig(**cfg), torch.tensor(s, dtype=torch.int32)))
            assert got == pytest.approx(ref, rel=ADAMW_TOL, abs=1e-12)


def _opt_inputs(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 5), "b": (5,), "layer": {"k": (3, 4)}}

    def tree(fn):
        return {k: ({kk: fn(s) for kk, s in v.items()} if isinstance(v, dict) else fn(v))
                for k, v in shapes.items()}
    params = tree(lambda s: rng.standard_normal(s).astype(dtype))
    grads = tree(lambda s: (0.3 * rng.standard_normal(s)).astype(np.float32))
    m = tree(lambda s: (0.05 * rng.standard_normal(s)).astype(np.float32))
    v = tree(lambda s: (0.01 * rng.random(s)).astype(np.float32))
    return params, grads, m, v


@pytest.mark.parametrize("clip", [1.0, 0.1])
def test_adamw_update_matches_jax(clip):
    """One update from a state three steps in (so bias correction, the
    schedule's warm-up and the clip all act) on the same numpy numbers."""
    params, grads, m, v = _opt_inputs(0)
    kw = dict(lr=2e-3, warmup_steps=5, total_steps=40, clip_norm=clip)
    jp, js = jax_adamw_update(JaxAdamWConfig(**kw), _jnp(params), _jnp(grads),
                              {"m": _jnp(m), "v": _jnp(v), "step": jnp.int32(3)})
    tp = jax.tree_util.tree_map(to_torch, params)
    state = {"m": jax.tree_util.tree_map(to_torch, m),
             "v": jax.tree_util.tree_map(to_torch, v),
             "step": torch.tensor(3, dtype=torch.int32)}
    new_p, new_s = adamw_update(AdamWConfig(**kw), tp,
                                jax.tree_util.tree_map(to_torch, grads), state)
    assert int(new_s["step"]) == int(js["step"]) == 4
    for got, ref in ((new_p, jp), (new_s["m"], js["m"]), (new_s["v"], js["v"])):
        for a, b in zip(jax.tree_util.tree_leaves(jax.tree_util.tree_map(
                lambda t: t.numpy(), got)), jax.tree_util.tree_leaves(_np(ref))):
            assert rel_err(a, b) < ADAMW_TOL
    assert new_p["w"] is tp["w"]                  # updated in place


def test_adamw_keeps_fp32_moments_over_bf16_params():
    """bf16 params: the moments are fp32 and match JAX at 1e-6; the params
    round to bf16 on both sides (one bf16 step of the largest, at most)."""
    params, grads, m, v = _opt_inputs(1)
    bf = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    jp, js = jax_adamw_update(JaxAdamWConfig(lr=1e-2, warmup_steps=0), bf,
                              _jnp(grads), {"m": _jnp(m), "v": _jnp(v),
                                            "step": jnp.int32(1)})
    tp = jax.tree_util.tree_map(lambda a: to_torch(np.asarray(a)), bf)
    state = {"m": jax.tree_util.tree_map(to_torch, m),
             "v": jax.tree_util.tree_map(to_torch, v),
             "step": torch.tensor(1, dtype=torch.int32)}
    new_p, new_s = adamw_update(AdamWConfig(lr=1e-2, warmup_steps=0), tp,
                                jax.tree_util.tree_map(to_torch, grads), state)
    assert all(x.dtype == torch.bfloat16 for x in tree_leaves(new_p))
    assert all(x.dtype == torch.float32 for x in tree_leaves(new_s["m"]))
    for a, b in zip(tree_leaves(new_s["v"]), jax.tree_util.tree_leaves(_np(js["v"]))):
        assert rel_err(a, b) < ADAMW_TOL
    for a, b in zip(tree_leaves(new_p), jax.tree_util.tree_leaves(jp)):
        b = np.asarray(b, np.float32)
        assert rel_err(a, b) <= 2.0 ** -8


# -- train step -------------------------------------------------------------------

def _seen_grads(jax_states):
    """The gradient JAX's Adam saw at each step (microbatches averaged,
    global-norm clip applied), read back from its first moments:
    m_t = b1 m_(t-1) + (1 - b1) g_t."""
    b1 = AdamWConfig().b1
    ms = [None] + [jax.tree_util.tree_leaves(_np(st["m"])) for st in jax_states]
    return [[(m - (0 if prev is None else b1 * pm)) / (1 - b1)
             for m, pm in zip(cur, prev or cur)] for prev, cur in zip(ms, ms[1:])]


def _param_agreement(port_params, jax_params, seen_grads):
    """Elements past PARAM_TOL (relative to the leaf's max|param|): how many,
    the largest |g| Adam saw at any of them (the smaller of the steps', per
    element), and the largest absolute difference among them."""
    flat_p = jax.tree_util.tree_leaves(port_params)
    flat_j = jax.tree_util.tree_leaves(_np(jax_params))
    flat_g = seen_grads
    n_off, worst_g, worst_abs = 0, 0.0, 0.0
    for i, (a, b) in enumerate(zip(flat_p, flat_j)):
        diff = np.abs(a - b)
        off = diff > PARAM_TOL * (np.abs(b).max() + 1e-9)
        if off.any():
            g_min = np.min([np.abs(g[i]) for g in flat_g], axis=0)
            n_off += int(off.sum())
            worst_g = max(worst_g, float(g_min[off].max()))
            worst_abs = max(worst_abs, float(diff[off].max()))
    return n_off, worst_g, worst_abs


def _jax_steps(jcfg, P, jb, accum, opt_kw):
    """Two JAX train steps from P: [(params, opt state, metrics)] after each,
    and the gradient Adam saw at each."""
    jstep = jax.jit(jax_train_step(jcfg, JaxAdamWConfig(**opt_kw), grad_accum=accum))
    jp0 = _jnp(P)
    out1 = jstep(jp0, jax_adamw_init(jp0), jb)
    out2 = jstep(out1[0], out1[1], jb)
    return [out1, out2], _seen_grads([out1[1], out2[1]])


OPT_KW = dict(lr=1e-3, warmup_steps=0)


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_two_train_steps_match_jax(arch, accum):
    """Port of test_models_smoke.py::test_smoke_train_step against the JAX
    step on the same weights and batch, the port on its own trajectory:
    losses at 1e-5, the optimizer's step.  Its params after two steps agree
    at 1e-5 but for a few elements: the elements a first step moved apart
    (gradients near zero, next test) change the second step's gradients a
    little everywhere, and Adam passes that on fully where the two steps'
    gradients nearly cancel in m.  Each such element stays within 2 lr a step."""
    jcfg, cfg = jax_smoke(arch), get_smoke_config(arch)
    P = _np_params(jcfg, 0)
    jb, tb = _batch(cfg.vocab_size)
    (j1, j2), jg = _jax_steps(jcfg, P, jb, accum, OPT_KW)
    step = make_train_step(cfg, AdamWConfig(**OPT_KW), grad_accum=accum)
    params = from_jax_params(cfg, P, "cpu")
    opt = adamw_init(params)
    params, opt, m1 = step(params, opt, tb)
    params, opt, m2 = step(params, opt, tb)
    for got, ref in ((m1, j1[2]), (m2, j2[2])):
        assert abs(float(got["loss"]) - float(ref["loss"])) / abs(float(ref["loss"])) < LOSS_TOL
    assert int(opt["step"]) == int(j2[1]["step"]) == 2
    assert float(m2["loss"]) < float(m1["loss"])
    n_off, _, worst_abs = _param_agreement(to_jax_layout(cfg, params), j2[0], jg)
    n_params = sum(x.numel() for x in tree_leaves(params))
    assert n_off <= 1e-4 * n_params, (n_off, worst_abs)
    assert worst_abs <= 2 * 2 * OPT_KW["lr"], (n_off, worst_abs)


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_each_train_step_matches_jax_from_the_same_state(arch, accum):
    """Each of the two steps from JAX's own params and optimizer state before
    it (the second through ``from_jax_opt_state``): loss at 1e-5, moments and
    params at 1e-5 but for elements whose clipped gradient is within a hundred
    Adam eps of zero, where m̂/(√v̂ + eps) turns a rounding-level gradient difference into
    an update difference of up to lr."""
    jcfg, cfg = jax_smoke(arch), get_smoke_config(arch)
    P = _np_params(jcfg, 0)
    jb, tb = _batch(cfg.vocab_size)
    (j1, j2), jg = _jax_steps(jcfg, P, jb, accum, OPT_KW)
    step = make_train_step(cfg, AdamWConfig(**OPT_KW), grad_accum=accum)
    starts = [(P, None), (_np(j1[0]), _np(j1[1]))]
    for (p_in, o_in), (jp, jo, jm), g in zip(starts, (j1, j2), jg):
        params = from_jax_params(cfg, p_in, "cpu")
        opt = adamw_init(params) if o_in is None else from_jax_opt_state(cfg, o_in, "cpu")
        params, opt, m = step(params, opt, tb)
        assert abs(float(m["loss"]) - float(jm["loss"])) / abs(float(jm["loss"])) < LOSS_TOL
        n_off, worst_g, worst_abs = _param_agreement(to_jax_layout(cfg, params), jp, [g])
        n_params = sum(x.numel() for x in tree_leaves(params))
        assert n_off <= 1e-4 * n_params, (n_off, worst_g, worst_abs)
        assert worst_g < NEAR_ZERO_GRAD, (n_off, worst_g, worst_abs)
        assert worst_abs <= 2 * OPT_KW["lr"], (n_off, worst_g, worst_abs)
        for key in ("m", "v"):
            for a, b in zip(jax.tree_util.tree_leaves(to_jax_layout(cfg, opt[key])),
                            jax.tree_util.tree_leaves(_np(jo[key]))):
                assert rel_err(a, b) < PARAM_TOL * 10


def test_opt_state_bridge_round_trips():
    jcfg, cfg = jax_smoke("tinyllama-1.1b"), get_smoke_config("tinyllama-1.1b")
    P = _np_params(jcfg, 9)
    jp = _jnp(P)
    jb, _ = _batch(cfg.vocab_size)
    _, jo, _ = jax.jit(jax_train_step(jcfg, JaxAdamWConfig(warmup_steps=0)))(
        jp, jax_adamw_init(jp), jb)
    opt = from_jax_opt_state(cfg, _np(jo), "cpu")
    assert int(opt["step"]) == 1 and opt["step"].dtype == torch.int32
    for key in ("m", "v"):
        back = to_jax_layout(cfg, opt[key])
        for a, b in zip(jax.tree_util.tree_leaves(back),
                        jax.tree_util.tree_leaves(_np(jo[key]))):
            assert a.shape == b.shape and np.array_equal(a, b)
    assert [x.shape for x in tree_leaves(opt["m"])] == \
        [x.shape for x in tree_leaves(from_jax_params(cfg, P, "cpu"))]


# -- data and estimator copies -------------------------------------------------------

@pytest.mark.parametrize("hosts,num_hosts,replication", [
    ([0], 1, 1), ([0], 4, 1), ([1, 2], 4, 2), ([3], 4, 3)])
def test_data_pipeline_copy_matches_the_original(hosts, num_hosts, replication):
    kw = dict(vocab_size=1000, seq_len=16, global_batch=4, num_shards=8, seed=7)
    ds = ShardedDataset(DataConfig(**kw), num_hosts=num_hosts, replication=replication)
    jds = JaxShardedDataset(JaxDataConfig(**kw), num_hosts=num_hosts,
                            replication=replication)
    assert ds.placement == jds.placement
    it, jit_ = make_batch_iter(ds, hosts=hosts, step0=3), jax_batch_iter(jds, hosts=hosts, step0=3)
    for _ in range(10):
        b, jb = next(it), next(jit_)
        for key in ("tokens", "labels"):
            assert b[key].dtype == jb[key].dtype and np.array_equal(b[key], jb[key])
    assert (ds.local_reads, ds.remote_reads) == (jds.local_reads, jds.remote_reads)
    assert ds.locality_rate() == jds.locality_rate()


def _demand_fields(d):
    return (d.n_m, d.n_r, d.feasible, repr(d.n_m_cont), repr(d.n_r_cont))


@pytest.mark.parametrize("args,kw", [
    ((10, 4, 2.0, 5.0, 0.1, 100.0), {}),
    ((10, 4, 2.0, 5.0, 0.1, 100.0), {"max_map_slots": 2, "max_reduce_slots": 1}),
    ((200, 10, 3.0, 1.0, 0.01, 50.0), {}),            # shuffle past the deadline
    ((5, 1, 0.0, 0.0, 0.0, 10.0), {}),
    ((7, 3, 1.5, 0.0, 0.0, 0.5), {"max_map_slots": 256}),
    ((1, 1, 1e-3, 1e-3, 0.0, 1e-3), {}),
])
def test_min_slots_copy_matches_the_original(args, kw):
    assert _demand_fields(min_slots(*args, **kw)) == \
        _demand_fields(jax_min_slots(*args, **kw))


def test_min_slots_copy_raises_as_the_original():
    for args in ((0, 1, 1.0, 1.0, 0.0, 1.0), (1, 1, -1.0, 1.0, 0.0, 1.0)):
        with pytest.raises(ValueError):
            min_slots(*args)
        with pytest.raises(ValueError):
            jax_min_slots(*args)


def test_estimator_bridge_copy_matches_the_original():
    for remaining in (1, 7, 500):
        for t_step in (0.01, 0.3, 2.0):
            for width in (0, 1, 4):
                for left in (-5.0, 0.5, 60.0, 3600.0):
                    args = (remaining, t_step, width, left, 256)
                    assert EstimatorBridge.demand(*args) == JaxBridge.demand(*args)


# -- launchers -------------------------------------------------------------------------

def test_train_launcher_runs_on_the_cpu(capsys):
    train.main(["--device", "cpu", "--preset", "smoke", "--steps", "3"])
    out = capsys.readouterr().out
    assert "[train] tinyllama-1.1b" in out and "on 1 device (cpu)" in out
    assert "step    0 loss" in out and "step    2 loss" in out
    assert "Eq.10 min-chips=1" in out
    assert "tok/s, data locality 100%" in out


def test_train_losses_fall_with_grad_accumulation():
    cfg = get_smoke_config("llama3.2-3b")
    result = train.train(cfg, steps=4, seq=32, batch=4, grad_accum=2, lr=3e-3,
                         device="cpu")
    assert len(result["losses"]) == 4 and all(map(math.isfinite, result["losses"]))
    assert result["losses"][-1] < result["losses"][0]
    assert result["locality"] == 1.0 and result["tokens_per_s"] > 0


def test_train_launcher_trains_mamba2_on_the_cpu(capsys):
    """The launcher takes family ssm (it refused it while the SSD scan had no
    backward): the smoke config trains on the CPU and the loss falls."""
    train.main(["--arch", "mamba2-1.3b", "--device", "cpu", "--preset", "smoke",
                "--steps", "3", "--seq", "64", "--batch", "4"])
    out = capsys.readouterr().out
    assert "[train] mamba2-1.3b" in out and "on 1 device (cpu)" in out
    assert "step    0 loss" in out and "step    2 loss" in out
    result = train.train(get_smoke_config("mamba2-1.3b"), steps=4, seq=64,
                         batch=4, lr=3e-3, device="cpu")
    assert all(map(math.isfinite, result["losses"]))
    assert result["losses"][-1] < result["losses"][0]


def test_train_refuses_an_arch_without_a_training_path():
    """A family the port has not ported (mixtral's moe) refuses, and says
    which slice brings it."""
    with pytest.raises(NotImplementedError, match="not ported yet"):
        train.main(["--arch", "mixtral-8x22b", "--device", "cpu", "--steps", "1"])


def test_quickstart_torch_runs_on_the_cpu(capsys):
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples" / "quickstart_torch.py"
    spec = importlib.util.spec_from_file_location("quickstart_torch", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.main(["--device", "cpu", "--steps", "3"])
    out = capsys.readouterr().out
    assert "step   0  loss" in out and "step   2  loss" in out and "on cpu" in out
