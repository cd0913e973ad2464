"""DeepSeek's MLA on the flash-attention path: the port's plain attention at
q·k and v head dims that differ, forward and backward, against the JAX
package's attention core; the MoE model (prefill, decode after prefill,
one train step) through the dispatch that sends MLA's prefill and training
to the kernel's op, against the JAX package; and the
kernel's wrappers, which take MLA's (192, 128) and refuse a pair outside
their table.

The attention core runs at the smoke config's pair (48, 32), which only
the plain versions take, and at the full config's (192, 128); the model at
(192, 128), the smoke config widened to MLA's head dims (nope 128, rope 64,
v 128; tests/test_torch_moe.py holds it at (48, 32)).  Inputs and weights
are made with numpy from a seed and handed to both sides; everything is
float32 on the CPU.  Attention's output is held at 2e-5 and its gradients
at 1e-4, relative to max|ref|; the model at tests/test_torch_moe.py's
tolerances (logits and caches 2e-4, the loss 1e-5, params 1e-5 of each
leaf's max).  The CUDA kernels run only on the card, where chip_smoke.py
holds them to these plain versions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.launch.steps import make_train_step as jax_train_step
from repro.models import layers as JL
from repro.models.common import get_model as jax_model
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro_torch import spans
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention import kernel as fa
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.launch.steps import make_train_step
from repro_torch.models import layers as PL
from repro_torch.models.common import get_model
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.testing import from_jax_params, rel_err, to_jax_layout, to_torch

ARCH = "deepseek-v2-lite-16b"
FWD_TOL = 2e-5
GRAD_TOL = 1e-4
TOL = 2e-4
LOSS_TOL = 1e-5
NO_DROPS = 8.0
# MLA's head dims at full width, on the smoke config's small rest
MLA_DIMS = dict(qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128)


def _cfgs(**kw):
    kw = {**MLA_DIMS, **kw}
    return jax_smoke(ARCH).replace(**kw), get_smoke_config(ARCH).replace(**kw)


def _np_params(jcfg, seed):
    """A numpy tree with the JAX model's structure: weights normal with each
    leaf's own standard deviation, norm scales around 1."""
    init = jax_model(jcfg).init(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, name) for v in tree]
        a = np.asarray(tree, dtype=np.float32)
        noise = rng.standard_normal(a.shape).astype(np.float32)
        return 1 + 0.1 * noise if name == "scale" else noise * a.std()
    return walk(init)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture
def paths(monkeypatch):
    """Counts the attention calls on the kernel's op and on the dense path."""
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


# -- the plain attention at q·k and v head dims that differ ---------------------------

# (B, Hq, Hkv, S, D, Dv) x (causal, window)
CORE_CASES = [
    ((2, 4, 4, 37, 48, 32), (True, None)),     # the smoke config's MLA
    ((1, 2, 2, 64, 192, 128), (True, None)),   # the full config's pair
    ((1, 2, 2, 64, 192, 128), (True, 16)),
    ((1, 4, 2, 50, 192, 128), (False, None)),  # GQA, non-causal
]


@pytest.mark.parametrize("shape,mask", CORE_CASES)
def test_plain_attention_at_mla_head_dims_equals_jax(shape, mask):
    """The port's op on CPU tensors (the plain forward, and under autograd
    the plain backward through ``FlashAttention``) against the JAX package's
    attention core (``layers.attention``, which MLA calls) and its VJP."""
    B, Hq, Hkv, S, D, Dv = shape
    causal, window = mask
    rng = np.random.default_rng(sum(shape))
    q, k = (rng.standard_normal(s).astype(np.float32)
            for s in ((B, Hq, S, D), (B, Hkv, S, D)))
    v = rng.standard_normal((B, Hkv, S, Dv)).astype(np.float32)
    do = rng.standard_normal((B, Hq, S, Dv)).astype(np.float32)
    jcfg = jax_smoke(ARCH)

    def jax_core(q, k, v):
        return JL.attention(jcfg, q, k, v, causal=causal, window=window)

    jout, vjp = jax.vjp(jax_core, *(jnp.asarray(a) for a in (q, k, v)))
    jgrads = vjp(jnp.asarray(do))
    ins = [to_torch(a).requires_grad_() for a in (q, k, v)]
    names = ("kernel.fa_fwd", "kernel.fa_bwd")
    before = [spans.counters()[k] for k in names]
    out = flash_attention(*ins, causal=causal, window=window)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    assert out.shape == (B, Hq, S, Dv)
    assert rel_err(out, np.asarray(jout)) < FWD_TOL
    grads = torch.autograd.grad(out, ins, to_torch(do))
    for name, g, r, n in zip(("dq", "dk", "dv"), grads, jgrads, (D, D, Dv)):
        assert g.shape[-1] == n and g.shape == r.shape, name
        assert rel_err(g, np.asarray(r)) < GRAD_TOL, name
    # the CPU path launches nothing
    assert [spans.counters()[k] for k in names] == before


# -- MLA and the MoE model through the dispatch --------------------------------------

def test_prefill_and_decode_after_prefill_at_mla_head_dims_equal_jax(paths):
    """The MoE model's prefill logits and cache (MLA on the kernel's op once a
    layer), then a decode step on the padded cache (the dense path once a
    layer), against the reference's, where no token drops."""
    from repro.launch import serve as jax_serve
    from repro_torch.launch import serve
    jcfg, pcfg = _cfgs(capacity_factor=NO_DROPS)
    np_tree = _np_params(jcfg, 5)
    jparams, params = _jnp(np_tree), from_jax_params(pcfg, np_tree, "cpu")
    model, jmodel = get_model(pcfg), jax_model(jcfg)
    B, S, L = 2, 29, pcfg.num_layers
    toks = np.random.default_rng(6).integers(0, jcfg.vocab_size, (B, S + 1)).astype(np.int32)
    jl, jcache = jmodel.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks[:, :S])})
    pl, cache = model.prefill(pcfg, params, {"tokens": to_torch(toks[:, :S]).long()})
    assert paths == {"kernel": L, "dense": 0}
    assert rel_err(pl, np.asarray(jl)) < TOL
    for part in ("dense", "scan"):
        for key in jcache[part]:
            assert rel_err(cache[part][key], np.asarray(jcache[part][key])) < TOL, (part, key)
    jcache = jax_serve.pad_cache_to(jcache, S + 2)
    cache = serve.pad_cache_to(cache, S + 2, pcfg.window)
    tok = toks[:, S:S + 1]
    jd, _ = jmodel.decode_step(jcfg, jparams, jcache, {"tokens": jnp.asarray(tok)})
    pd, cache = model.decode_step(pcfg, params, cache, {"tokens": to_torch(tok).long()})
    assert paths == {"kernel": L, "dense": L}
    assert cache["len"] == S + 1
    assert rel_err(pd, np.asarray(jd)) < TOL


def test_one_train_step_at_mla_head_dims_equals_jax(paths):
    """One step of ``make_train_step`` at MLA's full-width head dims (the
    forward on the kernel's op once a layer, its backward the plain
    backward through ``FlashAttention``) against the reference's from the
    same weights: the loss at 1e-5, the params at 1e-5 of each leaf's max
    but for elements whose clipped gradient is within a hundred Adam eps of
    zero, each within 2 lr (tests/test_torch_moe.py's rule)."""
    jcfg, cfg = _cfgs()
    P = _np_params(jcfg, 7)
    tok = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    lab = np.concatenate([tok[:, 1:], tok[:, :1]], axis=1)
    jb = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}
    tb = {"tokens": torch.from_numpy(tok).long(), "labels": torch.from_numpy(lab).long()}
    opt_kw = dict(lr=1e-3, warmup_steps=0)
    jp = _jnp(P)
    jp1, jo1, jm1 = jax.jit(jax_train_step(jcfg, JaxAdamWConfig(**opt_kw)))(
        jp, jax_adamw_init(jp), jb)
    params = from_jax_params(cfg, P, "cpu")
    params, opt, m = make_train_step(cfg, AdamWConfig(**opt_kw))(
        params, adamw_init(params), tb)
    assert paths == {"kernel": cfg.num_layers, "dense": 0}
    assert abs(float(m["loss"]) - float(jm1["loss"])) / abs(float(jm1["loss"])) < LOSS_TOL
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


# -- the kernel's table ---------------------------------------------------------------

def _meta(*shape, dtype=torch.bfloat16):
    return torch.zeros(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("d,dv", [(48, 32), (192, 64), (128, 192), (64, 128), (192, 192)])
def test_kernel_refuses_a_pair_outside_its_table(d, dv):
    """q·k and v head dims that are not a pair of HEAD_DIM_PAIRS raise in
    both wrappers and in the variant rules, before the device check: on a
    card no call falls to the plain version."""
    assert (d, dv) not in fa.HEAD_DIM_PAIRS
    q, k, v = _meta(1, 4, 16, d), _meta(1, 4, 16, d), _meta(1, 4, 16, dv)
    with pytest.raises(ValueError, match="not supported"):
        fa.flash_attention_fwd(q, k, v)
    out, do, lse = _meta(1, 4, 16, dv), _meta(1, 4, 16, dv), _meta(1, 4, 16, dtype=torch.float32)
    with pytest.raises(ValueError, match="not supported"):
        fa.flash_attention_bwd(q, k, v, out, lse, do)
    for rule in (fa.variant, fa.variant_bwd):
        with pytest.raises(ValueError, match="no kernel"):
            rule(torch.bfloat16, d, dv)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_takes_mla_pair_up_to_the_device_check(dtype):
    """(192, 128) passes every check of both wrappers (shapes, dtype, the
    16-byte rows TMA needs) and stops only at the device; the backward wants
    out and dO at v's head dim; the mma.sync variants, which have one head
    dim, refuse it by name."""
    q, k, v = _meta(1, 4, 16, 192, dtype=dtype), _meta(1, 4, 16, 192, dtype=dtype), \
        _meta(1, 4, 16, 128, dtype=dtype)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention_fwd(q, k, v)
    out, do = _meta(1, 4, 16, 128, dtype=dtype), _meta(1, 4, 16, 128, dtype=dtype)
    lse = _meta(1, 4, 16, dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention_bwd(q, k, v, out, lse, do)
    with pytest.raises(ValueError, match="must have q's shape"):
        fa.flash_attention_bwd(q, k, v, _meta(1, 4, 16, 192, dtype=dtype), lse,
                               _meta(1, 4, 16, 192, dtype=dtype))
    if dtype == torch.bfloat16:
        with pytest.raises(ValueError, match="has no kernel"):
            fa.flash_attention_fwd(q, k, v, variant="fa_fwd_bf16_mma")
        with pytest.raises(ValueError, match="has no kernel"):
            fa.flash_attention_bwd(q, k, v, out, lse, do, variant="fa_bwd_bf16_mma")


def test_c_functions_take_both_head_dims_where_the_wrappers_pass_them():
    """fa_fwd and fa_bwd take q·k's head dim and then v's right after the
    sequence lengths, where the wrappers pass D and Dv, and the argument
    counts are what ``load`` / ``load_bwd`` declare to ctypes."""
    import re
    for src, name, n_args in ((fa.SOURCE, "fa_fwd", 5 + 7 + 12 + 5),
                              (fa.SOURCE_BWD, "fa_bwd", 10 + 7 + 15 + 5)):
        sig = re.search(rf'extern "C" int {name}\(([^)]*)\)', src.read_text()).group(1)
        params = [p.strip() for p in sig.split(",")]
        assert len(params) == n_args, name
        i = params.index("int skv")
        assert params[i + 1] == "int d" and params[i + 2] in ("int dv", "int d_v"), name
