"""The port's flash attention on the CPU (its plain version) against the JAX
package's Pallas kernel in interpret mode and against the JAX oracle.

Inputs are made with numpy from a seed and handed to both sides.  Tolerances
are those of tests/test_kernels.py: relative to max|ref|, 2e-5 in float32
(two orders of summation) and 2e-2 in bfloat16 (one bf16 rounding of the
output is 2^-8 = 4e-3 relative).  The CUDA kernel itself runs only on the
card and is held against the same plain version by chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro_torch import spans
from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.testing import rel_err, to_torch

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SHAPES = [
    (1, 1, 1, 64, 64, 64),
    (2, 4, 2, 130, 130, 64),      # GQA + ragged
    (1, 2, 2, 97, 257, 128),      # cross lengths (non-causal)
    (1, 8, 1, 64, 64, 32),        # MQA
]
MASKS = [(True, None), (False, None), (True, 48)]
CASES = [(s, m) for s in SHAPES for m in MASKS if not (m[0] and s[3] != s[4])]


def _qkv(shape, dtype, seed=0):
    B, Hq, Hkv, Sq, Skv, D = shape
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s, dtype=np.float32)
            for s in ((B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D))]
    jdt = jnp.dtype(dtype)
    # round to the working type once, in JAX, so both sides hold equal values
    return [np.asarray(jnp.asarray(a).astype(jdt)) for a in arrs]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,mask", CASES)
def test_flash_attention_matches_jax_kernel_and_oracle(dtype, shape, mask):
    causal, window = mask
    q, k, v = _qkv(shape, dtype)
    out = flash_attention(*(to_torch(a) for a in (q, k, v)),
                          causal=causal, window=window)
    assert out.dtype == getattr(torch, dtype) and out.shape == q.shape
    pallas = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       causal=causal, window=window, q_block=64, kv_block=64,
                       interpret=True)
    oracle = jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, window=window)
    assert rel_err(out, np.asarray(pallas.astype(jnp.float32))) < TOL[dtype]
    assert rel_err(out, np.asarray(oracle.astype(jnp.float32))) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_without_visible_key_is_exact_zero(dtype):
    # non-causal window 16 over 40 keys: queries from 55 on see no key
    q, k, v = (to_torch(a) for a in _qkv((1, 2, 2, 200, 40, 64), dtype, seed=1))
    out = flash_attention(q, k, v, causal=False, window=16)
    assert torch.isfinite(out).all()
    assert float(out[:, :, 55:].abs().max()) == 0.0
    assert float(out[:, :, :55].abs().min(dim=-1).values.max()) > 0.0
    pallas = jax_flash(*(jnp.asarray(a) for a in _qkv((1, 2, 2, 200, 40, 64),
                                                       dtype, seed=1)),
                       causal=False, window=16, q_block=64, kv_block=64,
                       interpret=True)
    assert rel_err(out, np.asarray(pallas.astype(jnp.float32))) < TOL[dtype]


def test_plain_version_ignores_strides():
    q, k, v = (to_torch(a) for a in _qkv((2, 4, 2, 33, 33, 32), "float32", seed=2))
    qs = q.transpose(1, 2).contiguous().transpose(1, 2)   # [B,S,H,D] viewed as [B,H,S,D]
    assert not qs.is_contiguous()
    assert torch.equal(flash_attention(qs, k, v), flash_attention(q, k, v))


def test_cpu_path_counts_no_launch():
    q, k, v = (to_torch(a) for a in _qkv(SHAPES[0], "float32"))
    before = spans.counters()["kernel.fa_fwd"]
    flash_attention(q, k, v)
    assert spans.counters()["kernel.fa_fwd"] == before


@pytest.mark.parametrize("bad,message", [
    ("cpu_tensor", "CUDA tensors"), ("float16", "dtype"), ("float64", "dtype"),
    ("head_dim", "head dim"), ("heads", "multiple of Hkv"),
    ("window", "window"), ("stride", "contiguous in its last"),
    ("mixed_dtype", "share device and dtype"), ("kv_shape", "shapes disagree"),
    ("misaligned_rows", "16-byte boundary")])
def test_kernel_wrapper_raises_on_what_it_does_not_take(bad, message):
    """The launcher checks its arguments before it touches the library, so
    these raise here as they do on the card (tensors on the meta device stand
    in for CUDA tensors: the device is the last thing checked); nothing falls
    to the plain version."""
    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device="meta")
    q, k, v, kw = z(1, 4, 16, 64), z(1, 2, 16, 64), z(1, 2, 16, 64), {}
    if bad == "cpu_tensor":
        q, k, v = (torch.zeros(x.shape) for x in (q, k, v))
    elif bad in ("float16", "float64"):
        q, k, v = (x.to(getattr(torch, bad)) for x in (q, k, v))
    elif bad == "head_dim":
        q, k, v = z(1, 2, 16, 48), z(1, 2, 16, 48), z(1, 2, 16, 48)
    elif bad == "heads":
        q = z(1, 3, 16, 64)
    elif bad == "window":
        kw["window"] = 0
    elif bad == "stride":
        q = z(1, 4, 16, 128)[..., ::2]
    elif bad == "mixed_dtype":
        k = z(1, 2, 16, 64, dtype=torch.bfloat16)
    elif bad == "kv_shape":
        v = z(1, 2, 17, 64)
    elif bad == "misaligned_rows":       # bf16 rows 68 elements apart
        q, k, v = (z(1, h, 16, 68, dtype=torch.bfloat16)[..., :64] for h in (4, 2, 2))
    with pytest.raises(ValueError, match=message):
        flash_attention_fwd(q, k, v, **kw)
