"""GPipe pipeline of the port against the JAX package's, on the CPU.

One stage (no process group: the schedule degenerates but stays exact)
against the JAX package's ``pipeline_apply`` on a one-device mesh and its
``reference_apply``; four stages on 4 gloo ranks at tests/test_pipeline.py's
shapes (8 layers, d 16, 6 microbatches of 4) against ``reference_apply``,
both packages', at atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.parallel.pipeline import pipeline_apply as jax_pipeline_apply
from repro.parallel.pipeline import reference_apply as jax_reference_apply
from repro_torch.parallel.pipeline import pipeline_apply, reference_apply
from torch_distributed_main import run_case

ATOL = 1e-5


def _inputs(n_layers, d, n_micro, mb, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n_layers, d, d)) * 0.2).astype(np.float32)
    x = rng.standard_normal((n_micro, mb, d)).astype(np.float32)
    return w, x


def _jax_layer(lp, x):
    return jnp.tanh(x @ lp["w"]) + x


def _torch_layer(lp, x):
    return torch.tanh(x @ lp["w"]) + x


def test_single_stage_matches_jax():
    w, x = _inputs(4, 8, 3, 2)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1), ("pipe",))
    ref_pipe = jax_pipeline_apply(_jax_layer, {"w": jnp.asarray(w)}, jnp.asarray(x),
                                  mesh=mesh)
    ref = jax_reference_apply(_jax_layer, {"w": jnp.asarray(w)}, jnp.asarray(x))
    params = {"w": torch.from_numpy(w)}
    out = pipeline_apply(_torch_layer, params, torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_pipe), atol=ATOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    np.testing.assert_allclose(
        reference_apply(_torch_layer, params, torch.from_numpy(x)).numpy(),
        np.asarray(ref), atol=ATOL)


def test_four_stages_on_four_ranks(tmp_path):
    w, x = _inputs(8, 16, 6, 4, seed=1)
    res = run_case("pipeline", {"world": 4, "w": w, "x": x}, tmp_path)
    ref = jax_reference_apply(_jax_layer, {"w": jnp.asarray(w)}, jnp.asarray(x))
    np.testing.assert_allclose(res["out"], res["ref"], atol=ATOL)
    np.testing.assert_allclose(res["out"], np.asarray(ref), atol=ATOL)
