"""int8 gradient compression of the port against the JAX package's, on the
CPU: tests/test_substrates.py's three compression tests on the port; the
int8 codes and block scales bit-equal to the JAX package's
``quantize_int8`` on seeded inputs (padded last blocks, all-zero blocks, a
bf16 input); the tree round trip; and ``compressed_psum`` on 2 gloo ranks:
every rank gets the sum of the ranks' dequantized ``x + residual``, and its
residual is what quantization left out.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.parallel.compression import _blockify as jax_blockify
from repro.parallel.compression import dequantize_int8 as jax_dequantize
from repro.parallel.compression import quantize_int8 as jax_quantize
from repro_torch.parallel.compression import (_blockify, compress_tree,
                                              compressed_psum, decompress_tree,
                                              dequantize_int8, quantize_int8,
                                              wire_bytes_ratio)
from torch_distributed_main import run_case


@given(st.integers(0, 2**31 - 1))
@settings(max_examples=30, deadline=None)
def test_quantization_error_bound(seed):
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(533)
                         .astype(np.float32) * 3.0)
    q, s = quantize_int8(x)
    _, shape, pad = _blockify(x)
    deq = dequantize_int8(q, s, shape, pad)
    err = float((deq - x).abs().max())
    bound = float(x.abs().max()) / 127.0 * 0.5 + 1e-6
    assert err <= bound * 1.01


def test_error_feedback_recovers_mean():
    """With error feedback the time-averaged quantized signal converges to
    the true signal (residual carries the error)."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(256)
                         .astype(np.float32) * 0.01)
    residual = torch.zeros_like(x)
    acc = torch.zeros_like(x)
    steps = 50
    for _ in range(steps):
        xc = x + residual
        q, s = quantize_int8(xc)
        _, shape, pad = _blockify(xc)
        deq = dequantize_int8(q, s, shape, pad)
        residual = xc - deq
        acc = acc + deq
    np.testing.assert_allclose((acc / steps).numpy(), x.numpy(), atol=5e-4)


def test_wire_ratio():
    assert wire_bytes_ratio() < 0.27
    assert wire_bytes_ratio() == (256 + 4) / (256 * 4)


@pytest.mark.parametrize("shape,dtype", [((533,), np.float32), ((7, 300), np.float32),
                                         ((256,), np.float32), ((3, 5, 64), np.float32),
                                         ((1000,), "bfloat16")])
def test_codes_and_scales_bit_equal_to_jax(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * rng.uniform(0.01, 100)).astype(np.float32)
    x.reshape(-1)[:256 if x.size > 512 else 0] = 0.0        # an all-zero block
    if dtype == "bfloat16":
        jx = jnp.asarray(x, jnp.bfloat16)
        tx = torch.from_numpy(x).to(torch.bfloat16)
    else:
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jq, js = jax_quantize(jx)
    q, s = quantize_int8(tx)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))
    _, jshape, jpad = jax_blockify(jx)
    _, tshape, tpad = _blockify(tx)
    assert (tuple(jshape), jpad) == (tshape, tpad)
    np.testing.assert_array_equal(dequantize_int8(q, s, tshape, tpad).numpy(),
                                  np.asarray(jax_dequantize(jq, js, jshape, jpad)))


def test_tree_round_trip():
    rng = np.random.default_rng(3)
    tree = {"a": torch.from_numpy(rng.standard_normal((5, 70)).astype(np.float32)),
            "layers": [{"w": torch.from_numpy(rng.standard_normal(300).astype(np.float32))}]}
    back = decompress_tree(*compress_tree(tree))
    for k in ("a",):
        assert back[k].shape == tree[k].shape
        assert float((back[k] - tree[k]).abs().max()) <= float(tree[k].abs().max()) / 254 + 1e-6
    assert back["layers"][0]["w"].shape == (300,)


def test_compressed_psum_on_two_ranks(tmp_path):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 700)).astype(np.float32)
    residual = (rng.standard_normal((2, 700)) * 1e-3).astype(np.float32)
    res = run_case("compress", {"world": 2, "x": x, "residual": residual}, tmp_path)
    want, left = 0.0, []
    for r in range(2):
        xc = torch.from_numpy(x[r] + residual[r])
        q, s = quantize_int8(xc)
        _, shape, pad = _blockify(xc)
        deq = dequantize_int8(q, s, shape, pad)
        want = want + deq
        left.append((xc - deq).numpy())
    for r in range(2):
        np.testing.assert_array_equal(res["summed"][r], want.numpy())
        np.testing.assert_array_equal(res["residual"][r], left[r])
    # one rank: the sum is the rank's own dequantized value
    one, _ = compressed_psum(torch.from_numpy(x[0]), None, torch.from_numpy(residual[0]))
    xc = torch.from_numpy(x[0] + residual[0])
    q, s = quantize_int8(xc)
    np.testing.assert_array_equal(one.numpy(), dequantize_int8(q, s, (700,), 68).numpy())
