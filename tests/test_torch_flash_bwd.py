"""K1b on the CPU: the forward's log-sum-exp, the plain backward and the
autograd Function that carries the backward kernel, against the JAX package's
blocked flash attention (``repro.models.flash``) and against torch autograd.

Inputs are made with numpy from a seed and handed to both sides.  Everything
is float32: lse at rel 2e-5 (relative to max|lse|, the forward's tolerance),
gradients at rel 1e-4 (relative to max|reference|: the two sides sum over up
to 260 keys and two query heads in another order).  The CUDA kernels
themselves run only on the card (``chip_smoke.py`` holds them against
``attention_bwd_ref``); here the wrapper's rule and checks are tested.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.flash import _flash_bwd_impl, _flash_fwd
from repro.models.flash import flash_attention as jax_flash_attention
from repro_torch import spans
from repro_torch.configs import PORTED_ARCHS, get_config
from repro_torch.kernels.flash_attention import kernel as fa
from repro_torch.kernels.flash_attention.ops import FlashAttention, flash_attention
from repro_torch.kernels.flash_attention.ref import (NEG_INF, attention_bwd_ref,
                                                     attention_ref)
from repro_torch.testing import rel_err, to_torch

LSE_TOL = 2e-5
GRAD_TOL = 1e-4
# tests/test_flash_vjp.py's shapes: B 2, Hq 4, Hkv 2, S 260, D 32
B, HQ, HKV, S, D = 2, 4, 2, 260, 32


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _qkv(seed=0, b=B, hq=HQ, hkv=HKV, sq=S, skv=S, d=D):
    return _arrays(seed, (b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d),
                   (b, hq, sq, d))


def _jax_fwd(q, k, v, window, sq=S, skv=S):
    pos_q = jnp.arange(sq, dtype=jnp.int32)
    pos_k = jnp.arange(skv, dtype=jnp.int32)
    return _flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos_q,
                      pos_k, True, window, 64, 64, False)


@pytest.mark.parametrize("window", [None, 64])
def test_lse_matches_jax_flash_fwd(window):
    q, k, v, _ = _qkv(1)
    o_j, lse_j = _jax_fwd(q, k, v, window)
    out, lse = attention_ref(to_torch(q), to_torch(k), to_torch(v), causal=True,
                             window=window, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (B, HQ, S)
    assert rel_err(lse, np.asarray(lse_j)) < LSE_TOL
    assert rel_err(out, np.asarray(o_j)) < LSE_TOL


def test_lse_of_a_row_without_key_is_the_masked_logit():
    """A window that reaches no key of a shorter kv: the JAX forward keeps m
    at the masked logit, and so does the plain version (NEG_INF)."""
    q, k, v, _ = _qkv(2, b=1, hq=2, hkv=2, sq=96, skv=40)
    _, lse = attention_ref(to_torch(q), to_torch(k), to_torch(v), causal=False,
                           window=16, return_lse=True)
    pos_q, pos_k = jnp.arange(96, dtype=jnp.int32), jnp.arange(40, dtype=jnp.int32)
    _, lse_j = _flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos_q,
                          pos_k, False, 16, 64, 64, False)
    lse_j = np.asarray(lse_j)
    blind = lse_j[0, 0] < -1e38
    assert blind.sum() == 96 - (40 + 15)            # rows 55.. see no key
    assert bool((lse[..., 55:] == NEG_INF).all())
    assert rel_err(lse[..., :55], lse_j[..., :55]) < LSE_TOL
    assert np.allclose(lse[..., 55:].numpy(), lse_j[..., 55:], rtol=1e-6)


@pytest.mark.parametrize("window", [None, 64])
def test_bwd_ref_matches_jax_flash_bwd_impl(window):
    q, k, v, do = _qkv(3)
    o_j, lse_j = _jax_fwd(q, k, v, window)
    pos = jnp.arange(S, dtype=jnp.int32)
    ref = _flash_bwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), o_j,
                          lse_j, jnp.asarray(do), pos, pos, True, window, 64, 64)
    got = attention_bwd_ref(to_torch(q), to_torch(k), to_torch(v),
                            to_torch(np.asarray(o_j)), to_torch(np.asarray(lse_j)),
                            to_torch(do), causal=True, window=window)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.shape == r.shape, name
        assert rel_err(g, np.asarray(r)) < GRAD_TOL, name


@pytest.mark.parametrize("window", [None, 64])
def test_bwd_ref_matches_jax_grad_through_flash_attention(window):
    """jax.grad of sum(out * dO) through the custom-VJP flash attention
    against the port's forward (out, lse) and plain backward."""
    q, k, v, do = _qkv(4)
    pos = jnp.arange(S, dtype=jnp.int32)

    def f(q, k, v):
        out = jax_flash_attention(q, k, v, pos, pos, True, window, 64, 64, False)
        return jnp.sum(out * jnp.asarray(do))

    ref = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = to_torch(q), to_torch(k), to_torch(v)
    out, lse = attention_ref(qt, kt, vt, causal=True, window=window, return_lse=True)
    got = attention_bwd_ref(qt, kt, vt, out, lse, to_torch(do), causal=True,
                            window=window)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert rel_err(g, np.asarray(r)) < GRAD_TOL, name


def test_plain_forward_equals_the_packed_jax_forward():
    """K1's plain version against the JAX package's causal-packed blocked
    forward (``causal_pack=True``), at the shape and blocks of
    tests/test_flash_vjp.py::test_packed_equals_unpacked_fwd, within that
    test's 1e-5 (absolute)."""
    b, h, s, d = 1, 2, 512, 32
    q, k, v = _arrays(7, *[(b, h, s, d)] * 3)
    pos = jnp.arange(s, dtype=jnp.int32)
    packed = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 pos, pos, True, None, 128, 128, True)
    out = attention_ref(to_torch(q), to_torch(k), to_torch(v), causal=True)
    assert float((out - to_torch(np.asarray(packed))).abs().max()) < 1e-5


@pytest.mark.parametrize("window", [None, 64])
def test_plain_gradient_matches_jax_grad_through_the_packed_forward(window):
    """torch autograd through K1's plain version against jax.grad through
    the packed flash attention, on sum(out^2) at the shape and blocks of
    tests/test_flash_vjp.py::test_flash_vjp_matches_dense (its pack=True
    half)."""
    q, k, v, _ = _qkv(8)
    pos = jnp.arange(S, dtype=jnp.int32)

    def f(q, k, v):
        return jnp.sum(jax_flash_attention(q, k, v, pos, pos, True, window,
                                           64, 64, True) ** 2)

    ref = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ins = [to_torch(x).requires_grad_() for x in (q, k, v)]
    out = attention_ref(*ins, causal=True, window=window)
    got = torch.autograd.grad((out ** 2).sum(), ins)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert rel_err(g, np.asarray(r)) < GRAD_TOL, name


# (B, Hq, Hkv, Sq, Skv, D), causal, window: GQA, MQA, Skv != Sq both ways
FUNCTION_CASES = [
    ((2, 4, 2, 33, 33, 32), True, None),
    ((1, 8, 1, 40, 40, 64), True, 16),       # MQA, window
    ((2, 4, 2, 20, 45, 64), False, None),    # ragged: Skv > Sq
    ((1, 4, 4, 50, 30, 80), True, None),     # Skv < Sq, causal
    ((1, 6, 2, 24, 24, 128), False, 8),
]


@pytest.mark.parametrize("shape,causal,window", FUNCTION_CASES)
def test_flash_attention_function_matches_autograd_through_plain(shape, causal, window):
    b, hq, hkv, sq, skv, d = shape
    q, k, v, do = _arrays(5, (b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d),
                          (b, hq, sq, d))
    ins = [to_torch(a).requires_grad_() for a in (q, k, v)]
    out = FlashAttention.apply(*ins, causal, window)
    got = torch.autograd.grad(out, ins, to_torch(do))
    ref_ins = [to_torch(a).requires_grad_() for a in (q, k, v)]
    ref_out = attention_ref(*ref_ins, causal=causal, window=window)
    ref = torch.autograd.grad(ref_out, ref_ins, to_torch(do))
    assert torch.equal(out, ref_out)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype, name
        assert rel_err(g, r) < GRAD_TOL, name


def _fa_launches():
    counts = spans.counters()
    return counts["kernel.fa_fwd"], counts["kernel.fa_bwd"]


def test_dispatcher_takes_the_function_only_under_autograd():
    q, k, v, _ = _qkv(6, b=1, hq=2, hkv=1, sq=16, skv=16)
    q, k, v = to_torch(q), to_torch(k), to_torch(v)
    assert flash_attention(q, k, v).grad_fn is None
    with torch.no_grad():
        assert flash_attention(q, k, v.requires_grad_()).grad_fn is None
    out = flash_attention(q, k, v)               # v requires grad
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    before = _fa_launches()
    out.sum().backward()
    assert v.grad is not None and float(v.grad.abs().sum()) > 0
    assert _fa_launches() == before


def test_rows_without_key_get_zero_gradient():
    """Rows 55.. see no key (window 16, kv of 40): their dq is exactly 0, and
    the other rows' gradients are autograd's through the plain version."""
    q, k, v, do = _qkv(7, b=1, hq=2, hkv=1, sq=96, skv=40)
    qt, kt, vt = to_torch(q), to_torch(k), to_torch(v)
    out, lse = attention_ref(qt, kt, vt, causal=False, window=16, return_lse=True)
    dq, dk, dv = attention_bwd_ref(qt, kt, vt, out, lse, to_torch(do),
                                   causal=False, window=16)
    assert float(dq[:, :, 55:].abs().max()) == 0.0
    assert bool(torch.isfinite(dq).all() and torch.isfinite(dk).all()
                and torch.isfinite(dv).all())
    ins = [x.clone().requires_grad_() for x in (qt, kt, vt)]
    ref = torch.autograd.grad(attention_ref(*ins, causal=False, window=16), ins,
                              to_torch(do))
    for g, r in zip((dq, dk, dv), ref):
        assert rel_err(g, r) < GRAD_TOL


def test_gqa_gradient_sums_every_query_head_of_the_group():
    """dk of a KV head is the sum over its query heads: with the dO of all
    but one query head zero, dk is that head's alone, and the full dk is the
    sum of the per-head ones."""
    q, k, v, do = _qkv(8, b=1, hq=8, hkv=1, sq=24, skv=24, d=32)
    qt, kt, vt, dot = (to_torch(a) for a in (q, k, v, do))
    out, lse = attention_ref(qt, kt, vt, return_lse=True)
    _, dk, dv = attention_bwd_ref(qt, kt, vt, out, lse, dot)
    parts = []
    for h in range(8):
        one = torch.zeros_like(dot)
        one[:, h] = dot[:, h]
        parts.append(attention_bwd_ref(qt, kt, vt, out, lse, one)[1:])
    assert rel_err(dk, sum(p[0] for p in parts)) < 1e-5
    assert rel_err(dv, sum(p[1] for p in parts)) < 1e-5
    assert rel_err(dk, parts[0][0]) > 0.1         # not one head's alone


# -- the backward kernel's wrapper --------------------------------------------

@pytest.mark.parametrize("arch", [a for a in PORTED_ARCHS
                                  if get_config(a).family != "ssm"])
def test_backward_variant_of_every_ported_config(arch):
    """bf16 at every ported config's head dims (64: tinyllama-1.1b; 80:
    stablelm-3b; 128: llama3.2-3b, nemotron-4-15b, mixtral-8x22b; q·k 192
    and v 128: DeepSeek's MLA) runs the wgmma backward, float32 always the
    fp32-pipe one."""
    cfg = get_config(arch)
    dims = ((cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim) if cfg.kv_lora_rank
            else (cfg.resolved_head_dim,))
    assert fa.variant_bwd(torch.bfloat16, *dims) == "fa_bwd_wgmma"
    assert fa.variant_bwd(torch.float32, *dims) == "fa_bwd_simt"


def test_backward_variant_refuses_what_no_kernel_takes():
    for dtype, d in ((torch.float16, 64), (torch.bfloat16, 48), (torch.float32, 256)):
        with pytest.raises(ValueError, match="no kernel"):
            fa.variant_bwd(dtype, d)


def test_backward_variant_codes_and_kernel_names_are_the_c_functions():
    """The source's FaBwdVariant enum gives each code the same variant as
    VARIANT_CODES_BWD, and its kKernelNames are the CUDA kernels that
    VARIANT_KERNELS_BWD names, so a reading of the counts around one call
    names the variant that ran."""
    src = fa.SOURCE_BWD.read_text()
    in_source = {name: int(code) for code, name in
                 re.findall(r"k\w+ = (\d+),\s*// (\w+)", src)}
    assert in_source == fa.VARIANT_CODES_BWD
    assert set(fa.VARIANT_CODES_BWD) == set(fa.VARIANT_KERNELS_BWD)
    table = re.search(r"kKernelNames\[kNumKernels\] = \{([^}]*)\}", src).group(1)
    names = re.findall(r'"(\w+)"', table)
    assert len(names) == len(set(names))
    assert set(names) == {k for ks in fa.VARIANT_KERNELS_BWD.values() for k in ks}
    assert not set(names) & set(fa.VARIANT_KERNELS)   # one count per name


def test_forward_c_function_takes_the_lse_pointer():
    """fa_fwd's C signature has the lse pointer after the output's, where
    the wrapper passes it."""
    src = fa.SOURCE.read_text()
    sig = re.search(r'extern "C" int fa_fwd\(([^)]*)\)', src).group(1)
    assert re.sub(r"\s+", " ", sig).startswith(
        "const void* q, const void* k, const void* v, void* o, void* lse, int batch")


def _z(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("bad,message", [
    ("lse_shape", "lse must be"), ("lse_dtype", "lse must be"),
    ("do_shape", "must have q's shape"), ("do_dtype", "must have q's shape"),
    ("device", "CUDA tensors"),
    ("head_dim", "head dim")])
def test_backward_wrapper_raises_on_what_it_does_not_take(bad, message):
    q, k, v = _z(1, 4, 16, 64), _z(1, 2, 16, 64), _z(1, 2, 16, 64)
    out, lse, do = _z(1, 4, 16, 64), _z(1, 4, 16), _z(1, 4, 16, 64)
    if bad == "lse_shape":
        lse = _z(1, 4, 15)
    elif bad == "lse_dtype":
        lse = _z(1, 4, 16, dtype=torch.bfloat16)
    elif bad == "do_shape":
        do = _z(1, 4, 16, 32)
    elif bad == "do_dtype":
        do = _z(1, 4, 16, 64, dtype=torch.bfloat16)
    elif bad == "head_dim":
        q, k, v, out, do = (_z(*x.shape[:3], 48) for x in (q, k, v, out, do))
    with pytest.raises(ValueError, match=message):
        fa.flash_attention_bwd(q, k, v, out, lse, do)


def _offset(shape, dtype, elements=1):
    """A CPU tensor of `shape` whose data starts `elements` past an
    allocation's start: off any 16-byte boundary."""
    flat = torch.zeros(elements + torch.Size(shape).numel(), dtype=dtype)
    return flat[elements:].view(shape)


@pytest.mark.parametrize("which", ["q", "k", "v"])
@pytest.mark.parametrize("bad", ["base", "rows"])
@pytest.mark.parametrize("d", [32, 64, 80, 128])
def test_backward_wrapper_refuses_what_tma_cannot_take(which, bad, d):
    """bf16 at every head dim reaches the wgmma backward, which loads
    q, k and v by TMA: a base or a row stride off a 16-byte boundary raises,
    on CPU tensors, before the device check; aligned inputs reach it."""
    bf = torch.bfloat16
    shapes = {"q": (1, 4, 16, d), "k": (1, 2, 16, d), "v": (1, 2, 16, d)}
    t = {name: torch.zeros(shape, dtype=bf) for name, shape in shapes.items()}
    out, do = torch.zeros(shapes["q"], dtype=bf), torch.zeros(shapes["q"], dtype=bf)
    lse = torch.zeros((1, 4, 16))
    assert fa.variant_bwd(bf, d) == "fa_bwd_wgmma"
    with pytest.raises(ValueError, match="CUDA tensors"):   # aligned: next check
        fa.flash_attention_bwd(t["q"], t["k"], t["v"], out, lse, do)
    if bad == "base":
        t[which] = _offset(shapes[which], bf)
    else:   # rows d + 4 elements apart
        b, h, sq, _ = shapes[which]
        t[which] = torch.zeros((b, h, sq, d + 4), dtype=bf)[..., :d]
    with pytest.raises(ValueError, match="16-byte boundary"):
        fa.flash_attention_bwd(t["q"], t["k"], t["v"], out, lse, do)


@pytest.mark.parametrize("name,dtype,d", [
    ("fa_bwd_wgmma", torch.float32, 32), ("fa_bwd_wgmma", torch.float32, 80),
    ("fa_bwd_wgmma", torch.float32, 64), ("fa_bwd_bf16_mma", torch.float32, 64),
    ("fa_bwd_simt", torch.bfloat16, 128), ("fa_bwd_none", torch.bfloat16, 64)])
def test_explicit_backward_variant_that_does_not_take_raises(name, dtype, d):
    """``variant=`` overrides the rule only with kernels that take the dtype
    and head dim: anything else raises before the device check."""
    q, k, v = _z(1, 4, 16, d, dtype=dtype), _z(1, 2, 16, d, dtype=dtype), \
        _z(1, 2, 16, d, dtype=dtype)
    out, do, lse = _z(1, 4, 16, d, dtype=dtype), _z(1, 4, 16, d, dtype=dtype), \
        _z(1, 4, 16)
    with pytest.raises(ValueError, match="has no kernel"):
        fa.flash_attention_bwd(q, k, v, out, lse, do, variant=name)


@pytest.mark.parametrize("name,dtype,d", [
    ("fa_bwd_wgmma", torch.bfloat16, 32), ("fa_bwd_wgmma", torch.bfloat16, 64),
    ("fa_bwd_wgmma", torch.bfloat16, 80), ("fa_bwd_wgmma", torch.bfloat16, 128),
    ("fa_bwd_bf16_mma", torch.bfloat16, 64), ("fa_bwd_bf16_mma", torch.bfloat16, 80),
    ("fa_bwd_simt", torch.float32, 64)])
def test_explicit_backward_variant_that_takes_reaches_the_device_check(name, dtype, d):
    q, k, v = _z(1, 4, 16, d, dtype=dtype), _z(1, 2, 16, d, dtype=dtype), \
        _z(1, 2, 16, d, dtype=dtype)
    out, do, lse = _z(1, 4, 16, d, dtype=dtype), _z(1, 4, 16, d, dtype=dtype), \
        _z(1, 4, 16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention_bwd(q, k, v, out, lse, do, variant=name)
