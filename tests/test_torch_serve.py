"""The serving slice of the port as a whole against the JAX package: configs,
the parameter bridge, prefill, the cache, the decode step and a greedy
generation, on the smoke configs of the four dense architectures.

Weights and tokens are made with numpy from a seed and handed to both sides.
Everything is float32 on the CPU; logits are compared relative to
max|reference logit| at 2e-4, the tolerance of the JAX package's own
prefill/decode consistency test.
"""
import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.launch import serve as jax_serve
from repro.launch.steps import make_decode_step as jax_decode_step
from repro.launch.steps import make_prefill_step as jax_prefill_step
from repro.models.common import get_model as jax_model
from repro_torch.configs import ALL_ARCHS, PORTED_ARCHS, get_config, get_smoke_config
from repro_torch.launch import serve
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models.common import ModelConfig, get_model, param_count
from repro_torch.testing import from_jax_params, rel_err, to_numpy, to_torch

DENSE = ["tinyllama-1.1b", "llama3.2-3b", "stablelm-3b", "nemotron-4-15b"]
TOL = 2e-4
REPO = Path(__file__).resolve().parents[1]


def _np_params(jcfg, seed):
    """A numpy parameter tree with the JAX package's structure and scales:
    normal weights with each leaf's own standard deviation, norm scales
    around 1 and small norm biases, so that every parameter matters."""
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


def _jnp_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)


# -- configs ------------------------------------------------------------------------

def _dtype_name(d):
    return str(d).split(".")[-1] if isinstance(d, torch.dtype) else jnp.dtype(d).name


@pytest.mark.parametrize("preset", ["full", "smoke"])
@pytest.mark.parametrize("arch", DENSE)
def test_config_equals_jax_config_field_by_field(arch, preset):
    jcfg = jax_config(arch) if preset == "full" else jax_smoke(arch)
    pcfg = get_config(arch) if preset == "full" else get_smoke_config(arch)
    jfields = [f.name for f in dataclasses.fields(jcfg)]
    assert jfields == [f.name for f in dataclasses.fields(pcfg)]
    for name in jfields:
        jv, pv = getattr(jcfg, name), getattr(pcfg, name)
        if name in ("param_dtype", "compute_dtype"):
            assert isinstance(pv, torch.dtype)      # names are resolved
            assert _dtype_name(jv) == _dtype_name(pv), name
        elif name == "attn_impl":
            # the one deliberate difference: the port wires its kernel in
            assert pv == "kernel"
        else:
            assert jv == pv, (arch, name, jv, pv)
    assert pcfg.resolved_head_dim == jcfg.resolved_head_dim


def test_config_defaults_equal_jax_defaults():
    from repro.models.common import ModelConfig as JaxConfig
    jd = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    pd = {f.name: f.default for f in dataclasses.fields(ModelConfig)}
    assert list(jd) == list(pd)
    for name, jv in jd.items():
        if name in ("param_dtype", "compute_dtype"):
            assert _dtype_name(jv) == _dtype_name(pd[name]) == "bfloat16"
        elif name != "attn_impl":
            assert jv == pd[name], name


def test_arch_lists_and_unported_archs_say_which_slice():
    """Every arch of the JAX package is ported (the MoE family last), and
    each family resolves to its model class."""
    assert ALL_ARCHS == JAX_ARCHS
    assert sorted(PORTED_ARCHS) == sorted(ALL_ARCHS) == sorted(
        DENSE + ["mamba2-1.3b", "qwen2-vl-2b", "zamba2-1.2b", "whisper-large-v3",
                 "mixtral-8x22b", "deepseek-v2-lite-16b"])
    for arch in ALL_ARCHS:
        for getter in (get_config, get_smoke_config):
            assert getter(arch).arch == arch
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("gpt-5")
    from repro_torch.models.mamba2 import Mamba2LM
    from repro_torch.models.moe import MoETransformer
    from repro_torch.models.whisper import WhisperModel
    from repro_torch.models.zamba2 import Zamba2LM
    base = get_smoke_config("tinyllama-1.1b")
    assert get_model(base.replace(family="ssm")) is Mamba2LM
    assert get_model(base.replace(family="hybrid")) is Zamba2LM
    assert get_model(base.replace(family="encdec")) is WhisperModel
    assert get_model(base.replace(family="moe")) is MoETransformer
    for arch in ("mixtral-8x22b", "deepseek-v2-lite-16b"):
        assert get_model(get_config(arch)) is MoETransformer
    with pytest.raises(ValueError, match="unknown model family"):
        get_model(get_smoke_config("tinyllama-1.1b").replace(family="rnn"))
    with pytest.raises(ValueError, match="not a torch dtype"):
        get_smoke_config("tinyllama-1.1b").replace(param_dtype="float33")


# -- the parameter bridge ----------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_from_jax_params_round_trip(dtype):
    jcfg = jax_smoke("llama3.2-3b").replace(param_dtype=dtype)
    pcfg = get_smoke_config("llama3.2-3b").replace(param_dtype=dtype)
    jparams = jax_model(jcfg).init(jcfg, jax.random.PRNGKey(3))
    np_tree = jax.tree_util.tree_map(np.asarray, jparams)
    params = from_jax_params(pcfg, np_tree, "cpu")
    assert isinstance(params["layers"], list) and len(params["layers"]) == pcfg.num_layers
    assert param_count(params) == sum(
        int(x.size) for x in jax.tree_util.tree_leaves(jparams))
    # back to the stacked layout: every value survives exactly, bf16 included
    restack = {k: v for k, v in params.items() if k != "layers"}
    restack["layers"] = jax.tree_util.tree_map(
        lambda *xs: torch.stack(xs), *params["layers"])
    flat_j = jax.tree_util.tree_leaves_with_path(np_tree)
    flat_p = dict(jax.tree_util.tree_leaves_with_path(restack))
    assert len(flat_j) == len(flat_p)
    for path, leaf in flat_j:
        t = flat_p[path]
        assert t.dtype == getattr(torch, dtype)
        assert tuple(t.shape) == leaf.shape
        assert np.array_equal(to_numpy(t), leaf.astype(np.float32)), path
    wq = params["layers"][1]["attn"]["wq"]
    assert wq.shape == (pcfg.d_model, pcfg.n_heads * pcfg.resolved_head_dim)
    assert "lm_head" not in params          # tied embeddings


def test_init_has_the_bridge_layout():
    """model.init gives the tree that from_jax_params gives: same keys, shapes
    and dtypes."""
    for arch in DENSE:
        jcfg, pcfg = jax_smoke(arch), get_smoke_config(arch)
        bridged = from_jax_params(pcfg, _np_params(jcfg, 0), "cpu")
        own = get_model(pcfg).init(pcfg, torch.Generator().manual_seed(0), "cpu")
        shapes = lambda t: jax.tree_util.tree_map(lambda x: (tuple(x.shape), x.dtype), t)
        assert shapes(own) == shapes(bridged), arch


# -- the model against the JAX model ----------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE)
def test_prefill_cache_and_decode_step_equal_jax(arch):
    jcfg, pcfg = jax_smoke(arch), get_smoke_config(arch)
    np_tree = _np_params(jcfg, seed=1)
    jparams, params = _jnp_tree(np_tree), from_jax_params(pcfg, np_tree, "cpu")
    B, S = 2, 17
    toks = _tokens(jcfg, B, S + 1, seed=2)

    jl, jcache = jax_prefill_step(jcfg)(jparams, {"tokens": jnp.asarray(toks[:, :S])})
    pl, cache = make_prefill_step(pcfg)(params, {"tokens": to_torch(toks[:, :S])})
    assert pl.shape == (B, 1, pcfg.vocab_size) and pl.dtype == torch.float32
    assert rel_err(pl, np.asarray(jl)) < TOL
    assert cache["len"] == S == int(jcache["len"])
    assert cache["k"].shape == tuple(jcache["k"].shape)
    assert rel_err(cache["k"], np.asarray(jcache["k"])) < TOL
    assert rel_err(cache["v"], np.asarray(jcache["v"])) < TOL

    jcache = jax_serve.pad_cache_to(jcache, S + 4)
    cache = serve.pad_cache_to(cache, S + 4)
    assert cache["k"].shape == tuple(jcache["k"].shape) and cache["len"] == S
    jd, jcache = jax_decode_step(jcfg)(jparams, jcache, {"tokens": jnp.asarray(toks[:, S:])})
    pd, cache = make_decode_step(pcfg)(params, cache, {"tokens": to_torch(toks[:, S:])})
    assert rel_err(pd, np.asarray(jd)) < TOL
    assert cache["len"] == S + 1 == int(jcache["len"])
    assert rel_err(cache["k"], np.asarray(jcache["k"])) < TOL
    assert rel_err(cache["v"], np.asarray(jcache["v"])) < TOL


@pytest.mark.parametrize("variant", ["window", "parallel_residual", "dense_impl"])
def test_prefill_and_decode_variants_equal_jax(variant):
    """The sliding-window ring (prefill longer than the window rolls the cache,
    decode writes at len % window), the parallel residual, and the dense
    attention path of the port."""
    kw = {"window": dict(window=8), "parallel_residual": dict(parallel_residual=True),
          "dense_impl": {}}[variant]
    jcfg = jax_smoke("tinyllama-1.1b").replace(**kw)
    pcfg = get_smoke_config("tinyllama-1.1b").replace(**kw)
    if variant == "dense_impl":
        pcfg = pcfg.replace(attn_impl="dense")
    np_tree = _np_params(jcfg, seed=3)
    jparams, params = _jnp_tree(np_tree), from_jax_params(pcfg, np_tree, "cpu")
    B, S = 2, 13
    toks = _tokens(jcfg, B, S + 3, seed=4)
    jl, jcache = jax_model(jcfg).prefill(jcfg, jparams, {"tokens": jnp.asarray(toks[:, :S])})
    pl, cache = get_model(pcfg).prefill(pcfg, params, {"tokens": to_torch(toks[:, :S])})
    assert rel_err(pl, np.asarray(jl)) < TOL
    if variant == "window":
        assert cache["k"].shape[3] == 8 == get_model(pcfg).cache_len(pcfg, 100)
    else:
        jcache = jax_serve.pad_cache_to(jcache, S + 3)
        cache = serve.pad_cache_to(cache, S + 3)
    assert rel_err(cache["k"], np.asarray(jcache["k"])) < TOL
    for i in range(3):
        tok = toks[:, S + i:S + i + 1]
        jl, jcache = jax_model(jcfg).decode_step(jcfg, jparams, jcache, {"tokens": jnp.asarray(tok)})
        pl, cache = get_model(pcfg).decode_step(pcfg, params, cache, {"tokens": to_torch(tok)})
        assert rel_err(pl, np.asarray(jl)) < TOL, i
        assert rel_err(cache["k"], np.asarray(jcache["k"])) < TOL, i


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_decode_consistency(arch):
    """prefill(S) + decode(token S) == full forward at position S."""
    cfg = get_smoke_config(arch)
    model = get_model(cfg)
    params = model.init(cfg, torch.Generator().manual_seed(1), "cpu")
    B, S = 2, 17
    tks = to_torch(_tokens(cfg, B, S + 1, seed=2))
    full = model.logits(cfg, params, model.forward(cfg, params, tks))
    logits_p, cache = model.prefill(cfg, params, {"tokens": tks[:, :S]})
    cache = serve.pad_cache_to(cache, S + 4)
    logits_d, _ = model.decode_step(cfg, params, cache, {"tokens": tks[:, S:S + 1]})
    assert rel_err(logits_p[:, -1], full[:, S - 1]) < TOL
    assert rel_err(logits_d[:, 0], full[:, S]) < TOL


def test_forward_hidden_equals_jax_and_init_cache_layout():
    jcfg, pcfg = jax_smoke("stablelm-3b"), get_smoke_config("stablelm-3b")
    np_tree = _np_params(jcfg, seed=5)
    toks = _tokens(jcfg, 2, 9, seed=6)
    jh = jax_model(jcfg).forward(jcfg, _jnp_tree(np_tree), jnp.asarray(toks))
    ph = get_model(pcfg).forward(pcfg, from_jax_params(pcfg, np_tree, "cpu"), to_torch(toks))
    assert rel_err(ph, np.asarray(jh)) < TOL
    jc = jax_model(jcfg).init_cache(jcfg, 3, 20)
    pc = get_model(pcfg).init_cache(pcfg, 3, 20, "cpu")
    assert pc["k"].shape == tuple(jc["k"].shape) == (2, 3, 4, 20, 32)
    assert pc["len"] == 0 and float(pc["v"].abs().max()) == 0.0


# -- the launcher ----------------------------------------------------------------------------------

def test_greedy_generation_gives_the_jax_tokens():
    """Eight greedy tokens through the port's serving steps are the tokens of
    the JAX serving loop (float32: no near-ties to break differently)."""
    jcfg, pcfg = jax_smoke("tinyllama-1.1b"), get_smoke_config("tinyllama-1.1b")
    np_tree = _np_params(jcfg, seed=7)
    jparams, params = _jnp_tree(np_tree), from_jax_params(pcfg, np_tree, "cpu")
    B, S, G = 3, 12, 8
    prompts = _tokens(jcfg, B, S, seed=8)

    logits, cache = jax_prefill_step(jcfg)(jparams, {"tokens": jnp.asarray(prompts)})
    cache = jax_serve.pad_cache_to(cache, S + G)
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None]
    want = [tok]
    for _ in range(G - 1):
        logits, cache = jax_decode_step(jcfg)(jparams, cache, {"tokens": tok})
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None]
        want.append(tok)
    want = np.asarray(jnp.concatenate(want, axis=1))

    got, t_prefill, t_decode = serve.generate(pcfg, params, to_torch(prompts), G)
    assert got.shape == (B, G) and t_prefill > 0 and t_decode > 0
    assert np.array_equal(got.numpy(), want)


def test_generate_under_a_window_keeps_the_ring_cache():
    """A prompt longer than the sliding window leaves a ring cache of the
    window's length; ``generate`` decodes on it without padding it.  Each
    decode's logits equal the last position of a prefill of the sequence so
    far, and the greedy tokens are those of repeated prefills.  The JAX
    package pads the ring to prompt + gen, after which its decode reads the
    ring slots as positions 0..window-1: 0.94 relative against its own
    prefill(S + 1), recorded here as the reference's fault."""
    W, B, S, G = 16, 2, 24, 4
    jcfg = jax_smoke("tinyllama-1.1b").replace(window=W)
    pcfg = get_smoke_config("tinyllama-1.1b").replace(window=W)
    np_tree = _np_params(jcfg, seed=11)
    jparams, params = _jnp_tree(np_tree), from_jax_params(pcfg, np_tree, "cpu")
    prompts = _tokens(jcfg, B, S, seed=12)
    prefill, decode = make_prefill_step(pcfg), make_decode_step(pcfg)

    got, _, _ = serve.generate(pcfg, params, to_torch(prompts), G)
    seq, want, full = to_torch(prompts), [], []
    for _ in range(G):
        logits, _ = prefill(params, {"tokens": seq})
        full.append(logits)
        want.append(torch.argmax(logits[:, -1], dim=-1, keepdim=True))
        seq = torch.cat([seq, want[-1]], dim=1)
    assert torch.equal(got, torch.cat(want, dim=1))

    _, cache = prefill(params, {"tokens": to_torch(prompts)})
    cache = serve.pad_cache_to(cache, S + G, pcfg.window)
    assert cache["k"].shape[3] == W
    for i in range(G - 1):
        step, cache = decode(params, cache, {"tokens": got[:, i:i + 1]})
        assert rel_err(step, full[i + 1]) < TOL, i

    _, jcache = jax_prefill_step(jcfg)(jparams, {"tokens": jnp.asarray(prompts)})
    jcache = jax_serve.pad_cache_to(jcache, S + G)
    jstep, _ = jax_decode_step(jcfg)(jparams, jcache, {"tokens": jnp.asarray(got[:, :1].numpy())})
    jfull, _ = jax_prefill_step(jcfg)(
        jparams, {"tokens": jnp.asarray(np.concatenate([prompts, got[:, :1].numpy()], 1))})
    assert rel_err(to_torch(np.asarray(jstep)), np.asarray(jfull)) > 0.5


def test_pad_cache_to_grows_the_shared_attention_cache():
    """``attn_k`` and ``attn_v`` (Zamba2's shared attention) grow along
    their sequence dim as the reference's ``pad_cache_to`` grows them; the
    Mamba state and conv windows and Whisper's cross K/V stay as they are."""
    cache = {"attn_k": torch.ones(2, 3, 4, 5, 8), "attn_v": torch.ones(2, 3, 4, 5, 8),
             "k": torch.ones(2, 3, 4, 5, 8), "cross_k": torch.ones(2, 3, 4, 5, 8),
             "ssm": torch.ones(2, 3, 4, 5, 8), "conv_x": torch.ones(2, 3, 3, 16),
             "len": 5}
    jcache = jax_serve.pad_cache_to({k: (np.asarray(v) if isinstance(v, torch.Tensor) else v)
                                     for k, v in cache.items()}, 9)
    out = serve.pad_cache_to(cache, 9)
    for key, val in out.items():
        if key == "len":
            assert val == 5
            continue
        assert val.shape == jcache[key].shape, key
        assert np.array_equal(val.numpy(), np.asarray(jcache[key])), key
    assert out["attn_k"].shape[3] == out["attn_v"].shape[3] == 9
    assert out["cross_k"] is cache["cross_k"] and out["ssm"] is cache["ssm"]


def test_sampling_with_temperature_is_seeded():
    cfg = get_smoke_config("tinyllama-1.1b")
    params = get_model(cfg).init(cfg, torch.Generator().manual_seed(0), "cpu")
    prompts = to_torch(_tokens(cfg, 2, 8, seed=9))
    runs = [serve.generate(cfg, params, prompts, 6, temperature=1.0,
                           generator=torch.Generator().manual_seed(s))[0]
            for s in (5, 5, 6)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    assert int(runs[0].min()) >= 0 and int(runs[0].max()) < cfg.vocab_size


def test_serve_main_on_cpu(capsys):
    serve.main(["--device", "cpu", "--preset", "smoke", "--batch", "2",
                "--prompt-len", "16", "--gen", "4", "--seed", "3"])
    out = capsys.readouterr().out
    assert re.search(r"\[serve\] tinyllama-1.1b on cpu: prefill 2x16 in \d+ ms; "
                     r"decode 3 steps", out)
    assert "[serve] sample:" in out


def test_entry_points_refuse_to_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        assert serve.resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main(["--preset", "smoke"])
    assert serve.resolve_device("cpu").type == "cpu"


def test_init_without_a_device_means_the_card():
    """``init``, ``init_cache`` and the parameter bridge default to ``cuda``:
    with no card they raise, and take the CPU only when asked to."""
    for arch in ("tinyllama-1.1b", "mamba2-1.3b", "qwen2-vl-2b", "zamba2-1.2b",
                 "whisper-large-v3"):
        cfg = get_smoke_config(arch)
        model = get_model(cfg)
        np_tree = _np_params(jax_smoke(arch), 0)
        calls = [lambda **kw: model.init(cfg, torch.Generator().manual_seed(0), **kw),
                 lambda **kw: model.init_cache(cfg, 2, 8, **kw),
                 lambda **kw: from_jax_params(cfg, np_tree, **kw)]
        for call in calls:
            if not torch.cuda.is_available():
                with pytest.raises(RuntimeError, match="no CUDA device"):
                    call()
            tree = call(device="cpu")
            leaves = [v for v in jax.tree_util.tree_leaves(tree)
                      if isinstance(v, torch.Tensor)]
            assert leaves and all(t.device.type == "cpu" for t in leaves), arch


@pytest.mark.parametrize("arch", DENSE)
def test_kernel_takes_the_full_width_head_dim(arch):
    """Prefill on the card goes through the kernel, which raises on a head dim
    it was not built for: every ported attention arch's full config must be
    in its set."""
    from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS
    assert get_config(arch).resolved_head_dim in HEAD_DIMS


def test_ssd_kernel_takes_the_full_width_ssm_shape():
    """Mamba-2 prefill on the card goes through the SSD kernel, which raises
    on a (P, N, chunk) it was not built for: mamba2-1.3b's full config must be
    one it takes."""
    from repro_torch.kernels.ssd_scan import kernel
    cfg = get_config("mamba2-1.3b")
    assert [a for a in PORTED_ARCHS if get_config(a).family == "ssm"] == ["mamba2-1.3b"]
    assert kernel.takes(cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_chunk)
    assert cfg.ssm_chunk in kernel.CHUNKS


# -- what the port may import --------------------------------------------------------------------------

def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "examples" / "serve_batch_torch.py",
              REPO / "examples" / "quickstart_torch.py",
              REPO / "scripts" / "profile_torch_serve.py",
              REPO / "scripts" / "train_lr_sweep.py",
              REPO / "scripts" / "flash_bwd_ablation.py",
              REPO / "scripts" / "bench_torch_surrogate.py",
              REPO / "scripts" / "fluid_scan_ablation.py"]
    assert len(files) > 25
    scanned = {p.relative_to(REPO / "src" / "repro_torch").as_posix()
               for p in files if "repro_torch" in p.parts}
    assert {"models/mamba2.py", "configs/mamba2_1p3b.py", "kernels/_build.py",
            "models/zamba2.py", "models/whisper.py", "configs/qwen2_vl_2b.py",
            "kernels/ssd_scan/ref.py", "kernels/ssd_scan/kernel.py",
            "kernels/ssd_scan/ops.py", "optim/adamw.py", "data/pipeline.py",
            "core/estimator.py", "launch/train.py", "checkpoint/ckpt.py",
            "checkpoint/layout.py", "mapreduce/engine.py", "core/types.py",
            "core/policies.py", "simcluster/workloads.py", "simcluster/traces.py",
            "simcluster/surrogate.py", "kernels/fluid_scan/ref.py",
            "kernels/fluid_scan/kernel.py", "kernels/fluid_scan/ops.py",
            "experiments/metrics.py", "experiments/stats.py", "experiments/runner.py",
            "experiments/surrogate.py", "core/scheduler.py", "core/reconfigurator.py",
            "core/baselines.py", "core/tracing.py", "simcluster/sim.py",
            "simcluster/serving.py", "simcluster/largescale.py",
            "experiments/regimes.py", "experiments/__main__.py"} <= scanned
    assert all(p.is_file() for p in files)
    banned = re.compile(
        r"^\s*(import\s+(jax|flax|repro)(\.|\s|,|$)|from\s+(jax|flax|repro)(\.|\s))",
        re.MULTILINE)
    for path in files:
        hit = banned.search(path.read_text())
        assert hit is None, f"{path.relative_to(REPO)}: {hit.group(0).strip()!r}"
