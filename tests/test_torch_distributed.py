"""The port's mesh train step on gloo ranks on the CPU: the counterpart of
tests/test_distributed.py (tests/distributed_parity_main.py).

FSDP over data, TP over model, the activation layouts, the shard-map MoE
layer and the kernels' local regions must give the one-rank step's losses:
step 1 from the same params within STEP1_TOL (relative), step 2 within
STEP2_TOL (AdamW amplifies reduction-order noise; the JAX package pins
deepseek at 2e-2).  Each arch on a (data=2, model=2) mesh of 4 ranks, and
tinyllama also on the JAX package's own (4, 2) of 8 ranks.  Every local
shard must have the shape its spec gives, and some leaves must really be
split.  The one-rank step-1 loss is also held against the JAX package's
single-device loss (tests/test_torch_train.py's LOSS_TOL).  The ranks are
spawned by tests/torch_distributed_main.py; the JAX side is computed here.
"""
import jax
import numpy as np
import pytest

from repro.configs import get_smoke_config as jax_smoke
from repro.models.common import get_model as jax_model
from torch_distributed_main import run_case

STEP1_TOL = 1e-6
STEP2_TOL = {"deepseek-v2-lite-16b": 2e-2}
STEP2_DEFAULT = 5e-3
LOSS_TOL = 1e-5           # tests/test_torch_train.py's, port against JAX
ARCHS = ["tinyllama-1.1b", "deepseek-v2-lite-16b", "mamba2-1.3b", "zamba2-1.2b"]
B, S = 8, 64


def _case(arch: str, seed: int):
    """Numpy params (the JAX package's init) and batch, and the JAX package's
    single-device step-1 loss on them: the mean of its two microbatches'
    losses from those params, as its train step with grad_accum 2 takes it."""
    jcfg = jax_smoke(arch)
    model = jax_model(jcfg)
    init = jax.jit(lambda key: model.init(jcfg, key))
    params = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32),
             "labels": rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)}
    loss = jax.jit(lambda p, b: model.loss(jcfg, p, b)[0])
    half = B // 2
    step1 = np.mean([float(loss(params, {k: v[i * half:(i + 1) * half]
                                         for k, v in batch.items()}))
                     for i in range(2)])
    return {"params": params, "batch": batch}, float(step1)


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    """Every arch on (2, 2), tinyllama also on (4, 2): the port's losses, and
    the JAX package's."""
    tmp = tmp_path_factory.mktemp("dist")
    cases, jax_losses = {}, {}
    for i, arch in enumerate(ARCHS):
        cases[arch], jax_losses[arch] = _case(arch, i)
    res22 = run_case("train", {"world": 4, "mesh": (2, 2), "archs": cases}, tmp)
    res42 = run_case("train", {"world": 8, "mesh": (4, 2),
                               "archs": {"tinyllama-1.1b": cases["tinyllama-1.1b"]}}, tmp)
    return {(2, 2): res22, (4, 2): res42}, jax_losses


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-9)


@pytest.mark.parametrize("mesh,arch", [((2, 2), a) for a in ARCHS]
                         + [((4, 2), "tinyllama-1.1b")])
def test_mesh_train_step_matches_one_rank(parity, mesh, arch):
    res = parity[0][mesh][arch]
    (o1, o2), (m1, m2) = res["one"], res["mesh"]
    assert _rel(m1, o1) < STEP1_TOL, (arch, mesh, m1, o1)
    assert _rel(m2, o2) < STEP2_TOL.get(arch, STEP2_DEFAULT), (arch, mesh, m2, o2)
    # really sharded: every shard as its spec gives, and split leaves
    assert res["shapes_ok"], (arch, mesh)
    assert res["sharded_leaves"] >= res["leaves"] // 3, (arch, mesh, res)
    # the global norm of a sharded tree is the full tree's
    assert _rel(res["norm_mesh"], res["norm_full"]) < 1e-6, res


@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_step_matches_jax(parity, arch):
    one = parity[0][(2, 2)][arch]["one"]
    ref = parity[1][arch]
    assert _rel(one[0], ref) < LOSS_TOL, (arch, one, ref)
