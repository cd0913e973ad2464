"""The port's tensor-parallel layers on gloo ranks against the JAX package's
one-device functions, on the CPU.

* Row-parallel attention (``models/attn_sm.py``) on 3 ranks (model=3) with
  smoke llama3.2-3b's 4 / 2 heads, misaligned with tp, so the 12 (batch x
  head) rows of a batch of 3 make 4 a rank (and, at a batch of 2, 8 would
  be padded to 9): forward and the gradients
  of q, k, v against ``repro.models.flash.flash_attention``, fp32 2e-5
  relative to max|ref|.  The same through ``layers.attention`` with
  ``attn_row_parallel`` (which must take ``attn_sm``) and with the opt-in
  ``bh_flat`` layout.
* The shard-map MoE layer (``moe._moe_ffn_shard_map``) on (data=2, model=2)
  for smoke deepseek-v2-lite-16b (shared expert, 8 dispatch groups: 4 a
  data shard) and mixtral-8x22b (2 groups: 1 a shard): output, aux, the set
  of choices capacity keeps, and the gradients of x and of every routed
  weight against the JAX package's ``moe_ffn`` on one device.
* The JAX package's own shard-map MoE, on 4 host devices in a subprocess,
  gives every expert weight half its one-device gradient on a model axis of
  2 (its ``_psum_id_bwd`` passes the cotangent that ``shard_map`` has
  already divided by the model axis); the port does not copy that.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_smoke_config as jax_smoke
from repro.models import moe as JM
from repro.models.flash import flash_attention as jax_flash_attention
from torch_distributed_main import run_case

ROOT = Path(__file__).resolve().parents[1]
FP32_TOL = 2e-5
MOE_TOL = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))


# -- row-parallel attention ----------------------------------------------------------

MASKS = [(True, None), (True, 16), (False, None)]


@pytest.fixture(scope="module")
def attn(tmp_path_factory):
    rng = np.random.default_rng(0)
    # smoke llama3.2-3b's heads; bh_flat needs the B x Hq rows to divide
    # dp x tp: 3 x 4 over 3
    B, Hq, Hkv, S, D = 3, 4, 2, 40, 32
    inp = {n: rng.standard_normal(shape).astype(np.float32)
           for n, shape in (("q", (B, Hq, S, D)), ("k", (B, Hkv, S, D)),
                            ("v", (B, Hkv, S, D)), ("w", (B, Hq, S, D)))}
    res = run_case("attn_sm", {"world": 3, "mesh": (1, 3), "masks": MASKS, **inp},
                   tmp_path_factory.mktemp("attn"))
    pos = jnp.arange(S)
    refs = {}
    for causal, window in MASKS:
        def f(q, k, v):
            return jax_flash_attention(q, k, v, pos, pos, causal, window, 16, 16, False)

        q, k, v, w = (jnp.asarray(inp[n]) for n in "qkvw")
        out, vjp = jax.vjp(f, q, k, v)
        refs[(causal, window)] = {"out": out, **dict(zip(("dq", "dk", "dv"), vjp(w)))}
    return res, refs


@pytest.mark.parametrize("route", ["shard_map", "row_parallel", "bh_flat"])
@pytest.mark.parametrize("mask", MASKS)
def test_row_parallel_attention_matches_jax(attn, route, mask):
    got, ref = attn[0][(*mask, route)], attn[1][mask]
    for name in ("out", "dq", "dk", "dv"):
        assert _rel(got[name], ref[name]) < FP32_TOL, (route, mask, name)
    # attn_row_parallel takes attn_sm; bh_flat does not
    assert got["shard_map_calls"] == (0 if route == "bh_flat" else 1)


# -- the shard-map MoE layer ---------------------------------------------------------

def _jax_kept(cfg, p, x):
    """The choices the JAX package's one-device ``moe_ffn`` keeps, [B, S, k]
    bool: its ``_dispatch_group``'s routing and capacity, group by group."""
    B, S, d = x.shape
    G = max(1, min(cfg.moe_dispatch_groups, B * S))
    while (B * S) % G:
        G -= 1
    T, k, E = (B * S) // G, cfg.top_k, cfg.n_experts
    cap = int(np.ceil(T * k / E * cfg.capacity_factor))

    def one(xg):
        probs = jax.nn.softmax(xg @ p["router"], axis=-1)
        _, idx = jax.lax.top_k(probs.astype(jnp.bfloat16), k)
        flat_e = idx.reshape(T * k)
        order = jnp.argsort(flat_e, stable=True)
        sorted_e = flat_e[order]
        pos = jnp.arange(T * k) - jnp.searchsorted(sorted_e, jnp.arange(E))[sorted_e]
        return jnp.zeros(T * k, bool).at[order].set(pos < cap).reshape(T, k)

    return np.asarray(jax.jit(jax.vmap(one))(x.reshape(G, T, d))).reshape(B, S, k)


@pytest.fixture(scope="module")
def moe(tmp_path_factory):
    archs, refs = {}, {}
    for i, arch in enumerate(("deepseek-v2-lite-16b", "mixtral-8x22b")):
        jcfg = jax_smoke(arch)
        p = jax.tree_util.tree_map(np.asarray, JM.init_moe_ffn(jcfg, jax.random.PRNGKey(i)))
        rng = np.random.default_rng(i)
        # tokens that share a direction crowd the same experts: capacity drops
        x = (rng.standard_normal((4, 16, jcfg.d_model))
             + 2.0 * rng.standard_normal(jcfg.d_model)).astype(np.float32)
        w = rng.standard_normal((4, 16, jcfg.d_model)).astype(np.float32)
        archs[arch] = {"params": p, "x": x, "w": w}
        routed = ("router", "w_gate", "w_up", "w_down")

        def f(pr, xx):
            o, a = JM.moe_ffn(jcfg, {**p, **pr}, xx)
            return jnp.sum(o * w) + 3.0 * a

        pr = {n: jnp.asarray(p[n]) for n in routed}
        out, aux = jax.jit(lambda xx: JM.moe_ffn(jcfg, p, xx))(jnp.asarray(x))
        gp, gx = jax.jit(jax.grad(f, argnums=(0, 1)))(pr, jnp.asarray(x))
        refs[arch] = {"out": np.asarray(out), "aux": float(aux), "dx": np.asarray(gx),
                      "grads": {n: np.asarray(g) for n, g in gp.items()},
                      "kept": _jax_kept(jcfg, p, jnp.asarray(x))}
    res = run_case("moe", {"world": 4, "mesh": (2, 2), "archs": archs},
                   tmp_path_factory.mktemp("moe"))
    return res, refs


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "mixtral-8x22b"])
def test_moe_shard_map_matches_one_device(moe, arch):
    res, refs = moe[0][arch], moe[1][arch]
    assert _rel(res["out"], refs["out"]) < MOE_TOL
    assert abs(res["aux"] - refs["aux"]) <= MOE_TOL * abs(refs["aux"])
    # the same tokens dropped: the local slice cut into G / dp groups
    np.testing.assert_array_equal(res["kept"], refs["kept"])
    assert not refs["kept"].all(), "capacity drops nothing: the check is empty"
    assert _rel(res["dx"], refs["dx"]) < MOE_TOL
    for name, g in refs["grads"].items():
        assert _rel(res["grads"][name], g) < MOE_TOL, name
    # the expert weights are FSDP-sharded over data and tp-sharded on d_ff
    assert res["specs"]["w_gate"] == (None, "data", "model")
    assert res["specs"]["w_down"] == (None, "model", "data")


_JAX_SHARD_MAP_GRADS = """
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import get_smoke_config
from repro.models import moe as M
from repro.parallel.activations import set_activation_sharding, clear
cfg = get_smoke_config("mixtral-8x22b")
p = M.init_moe_ffn(cfg, jax.random.PRNGKey(0))
x = jax.random.normal(jax.random.PRNGKey(1), (4, 16, cfg.d_model))
w = jax.random.normal(jax.random.PRNGKey(2), (4, 16, cfg.d_model))
f = lambda p, x: jnp.sum(M.moe_ffn(cfg, p, x)[0] * w)
one = jax.grad(f)(p, x)
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
set_activation_sharding(dp="data", dp_size=2, tp="model", tp_size=2, mesh=mesh,
                        fsdp="data")
with mesh:
    sm = jax.jit(jax.grad(f))(p, x)
for k in ("w_gate", "w_up", "w_down"):
    print(k, float(jnp.max(jnp.abs(sm[k] - 0.5 * one[k])) / jnp.max(jnp.abs(one[k]))))
"""


def test_jax_shard_map_moe_halves_expert_grads_and_the_port_does_not(moe):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", _JAX_SHARD_MAP_GRADS], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    errs = dict(line.split() for line in out.stdout.strip().splitlines())
    # the reference's shard-map expert gradients are one-device / tp ...
    assert all(float(e) < 1e-6 for e in errs.values()), errs
    # ... and the port's are the one-device gradients (see above)
    res, refs = moe[0]["mixtral-8x22b"], moe[1]["mixtral-8x22b"]
    assert _rel(res["grads"]["w_gate"], refs["grads"]["w_gate"]) < MOE_TOL
