"""The benchmark's harness on the CPU: cells found by name, the contract's
shape of ``BENCHMARK.json``, the yardsticks against hand counts, the
references against the port, the check that decides ``correct`` against
planted faults and the control, the no-JAX check."""
from __future__ import annotations

import json
import re
import shutil
import sys

import pytest
import torch

from bench.tests.helpers import ROOT, smoke_cell
from bench.harness import cells, session, weights, yardstick
from bench.harness.trace import Reading, TraceSummary
from bench import run as bench_run

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# cells, found by name
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", WORKLOADS)
def test_every_cell_has_its_files(name):
    cell = cells.cell(name)
    assert cells.mode_module(cell.mode).run
    assert cells.family_module(cell.family).port_config
    assert cells.reference_module(cell.family).forward_flops
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "peak_mem_gib"}
    assert cell.per_layer and cell.limits
    for m in cell.per_layer:
        assert callable(cells.metric_module(m["name"]).read)
        assert m["moves"] in {e["name"] for e in cell.end_to_end}


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/") and (ROOT / c["file"]).exists()
        conf = json.loads((ROOT / c["file"]).read_text())
        assert sorted(c["reduced"]) == sorted(conf["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert set(m["workloads"]) <= set(WORKLOADS)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_catalog_numbers_kept():
    """The DeepSeek files hold every number of the catalog's config, changed
    only where ``reduced`` (a cut, only the depth) says; a cell runs each of
    ``port_departures`` (the port's own choice) in place of the source's."""
    for name, cut in (("deepseek-v2-lite-16b", {}),
                      ("deepseek-v2-lite-16b-6l", {"num_hidden_layers": [27, 6]})):
        conf = json.loads((ROOT / "bench" / "configs" / f"{name}.json").read_text())
        assert conf["reduced"] == cut
        for key, (published, run) in conf["reduced"].items():
            assert conf[key] == run and published != run
        run_conf = cells.as_run(conf)
        for key, (published, run) in conf["port_departures"].items():
            assert conf[key] == published != run == run_conf[key]
        assert run_conf["rope_scaling"] is None
        assert conf["hidden_size"] == 2048 and conf["n_routed_experts"] == 64
        assert conf["num_experts_per_tok"] == 6 and conf["kv_lora_rank"] == 512


def test_new_cell_config_traffic_and_metric_are_found_as_new_files(tmp_path):
    """A later cell brings a config, a traffic mix, limits and a metric as new
    files and entries in BENCHMARK.json; nothing else is edited."""
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    conf = json.loads((ROOT / "bench/configs/deepseek-v2-lite-16b.json").read_text())
    conf["name"] = "deepseek-v2-lite-16b-12l"
    (tmp_path / "bench/configs/deepseek-v2-lite-16b-12l.json").write_text(json.dumps(conf))
    (tmp_path / "bench/traffic/prefill-mix16k.json").write_text(json.dumps(
        {"mode": "prefill", "prompt_tokens": 16384, "lengths": [1024, 4096]}))
    (tmp_path / "bench/limits/dsv2lite-prefill-mix16k.json").write_text(
        json.dumps({"limits": {"token_gap": 1.0}}))
    (tmp_path / "bench/metrics/launches_per_batch.py").write_text(
        "def read(t):\n    return t.summary.n_device_ops / t.units\n")
    bench["configs"].append({"name": "deepseek-v2-lite-16b-12l", "source": "x",
                             "file": "bench/configs/deepseek-v2-lite-16b-12l.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "dsv2lite-prefill-mix16k",
                               "config": "deepseek-v2-lite-16b-12l",
                               "traffic": "prefill-mix16k", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "launches_per_batch", "unit": "1", "better": "lower",
                               "source": "device_trace", "layer": "device",
                               "moves": "prefill_tokens_per_s",
                               "workloads": ["dsv2lite-prefill-mix16k"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = cells.cell("dsv2lite-prefill-mix16k", root=tmp_path)
    assert cell.config["name"] == "deepseek-v2-lite-16b-12l"
    assert cell.traffic["prompt_tokens"] == 16384
    assert cell.limits == {"token_gap": 1.0}
    assert [m["name"] for m in cell.per_layer] == ["launches_per_batch"]
    reader = cells.metric_module("launches_per_batch", root=tmp_path)
    summary = TraceSummary(busy_s=1.0, region_ms={}, device_ops=[], idle_gaps=[],
                           n_device_ops=120)
    assert reader.read(Reading("prefill", 2.0, 4, 0.0, summary, {})) == 30.0


# ---------------------------------------------------------------------------
# yardsticks
# ---------------------------------------------------------------------------


def T(*shape, dtype="torch.bfloat16"):
    return ("T", tuple(shape), dtype)


def test_visible_pairs_closed_form_and_loop_agree():
    for sq in (1, 5, 64):
        assert yardstick._pairs(sq, sq, True, None) == yardstick.visible_pairs(sq, sq, True, None)
        assert yardstick._pairs(sq, sq, False, None) == sq * sq
    assert yardstick.visible_pairs(6, 6, True, 2) == 11


def test_attention_bounds_by_hand():
    q, k, v = T(2, 4, 8, 16), T(2, 4, 8, 16), T(2, 4, 8, 8)
    pairs = 8 * 9 // 2
    flops = 2 * 2 * 4 * (16 + 8) * pairs
    n_bytes = 2 * (2 * 4 * 8 * 16 * 2 + 2 * 4 * 8 * 8 + 2 * 4 * 8 * 8)
    assert yardstick.attention_fwd_s(q, k, v) == pytest.approx(
        max(flops / 989e12, n_bytes / 3.35e12))
    out, lse, do = T(2, 4, 8, 8), T(2, 4, 8, dtype="torch.float32"), T(2, 4, 8, 8)
    flops_b = 2 * 2 * 4 * (3 * 16 + 2 * 8) * pairs
    bytes_b = 2 * (2 * 1024 + 512 + 512 + 2 * (1024 + 512)) + 4 * 64
    assert yardstick.attention_bwd_s(q, k, v, out, lse, do) == pytest.approx(
        max(flops_b / 989e12, bytes_b / 3.35e12))


def test_ssd_bounds_by_hand():
    x, dt, A = T(1, 8, 2, 4), T(1, 8, 2, dtype="torch.float32"), T(2, dtype="torch.float32")
    B = C = T(1, 8, 1, 3)
    pairs = 2 * (4 * 5 // 2)                      # two chunks of 4
    flops = 2 * (1 * 3 * pairs + 2 * 4 * pairs + 2 * 2 * 4 * 3 * 8)
    n_bytes = 2 * (2 * 64 + 24 + 24) + 4 * 16 + 4 * 2 + 2 * 4 * 3 * 4
    assert yardstick.ssd_fwd_s(x, dt, A, B, C, chunk=4) == pytest.approx(
        max(flops / 989e12, n_bytes / 3.35e12))
    dy = T(1, 8, 2, 4)
    flops_b = 2 * (3 * 3 * pairs + 2 * 8 * pairs + 5 * 2 * 4 * 3 * 8)
    bytes_b = 2 * (3 * 64 + 2 * 48) + 4 * (2 * 16 + 2 * 2)
    assert yardstick.ssd_bwd_s(x, dt, A, B, C, dy, chunk=4) == pytest.approx(
        max(flops_b / 989e12, bytes_b / 3.35e12))


def test_deepseek_flops_by_hand():
    ref = cells.reference_module("deepseek_v2")
    c = smoke_cell("dsv2lite-train-4x2048").config      # 3 layers, 1 dense
    d, H, V = 64, 4, 256
    attn = 2 * (d * H * 24 + d * 40 + 32 * H * 16 * 2 + H * 16 * d)
    per_tok = 3 * attn + 2 * 3 * d * 128 + 2 * 2 * (d * 8 + 3 * d * 32 * 3)
    core = 3 * 2 * H * (24 + 16) * 2 * (10 * 11 / 2)
    assert ref.forward_flops(c, 2, 10, 10) == pytest.approx(
        20 * per_tok + core + 2 * d * V * 2 * 10)
    assert ref.forward_flops(c, 2, 10, 1) == pytest.approx(20 * per_tok + core + 2 * d * V * 2)


# ---------------------------------------------------------------------------
# weights, the references against the port
# ---------------------------------------------------------------------------


def _program_and_weights(cell, seed=987654321987):
    from repro_torch.models.common import get_model
    pcfg = cells.family_module(cell.family).port_config(cell.config)
    meta = get_model(pcfg).init(pcfg, torch.Generator(), "meta")
    return pcfg, weights.make(meta, seed, CPU, cell.config["num_hidden_layers"])


def test_weights_follow_the_seed_and_the_tree():
    from repro_torch.configs.zamba2_1p2b import smoke
    from repro_torch.models.common import get_model
    pcfg = smoke()              # a tree with norms, adapters and Mamba-2's leaves
    meta = get_model(pcfg).init(pcfg, torch.Generator(), "meta")
    a, b, c = (weights.make(meta, seed, CPU, pcfg.num_layers)
               for seed in (987654321987, 987654321987, 5))
    la, lb, lc = (weights.named_leaves(t) for t in (a, b, c))
    assert [n for n, _ in la] == [n for n, _ in lb]
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(la, lb))
    assert not torch.equal(la[0][1], lc[0][1])
    by = dict(la)
    A = by["layers/0/mamba/A_log"].exp()
    assert bool(((A >= 1.0) & (A <= 16.0)).all())
    assert torch.equal(by["final_norm/scale"], torch.ones_like(by["final_norm/scale"]))


def test_reference_loss_and_grads_match_the_port():
    from repro_torch.launch.steps import loss_and_grads
    cell = smoke_cell("dsv2lite-train-4x2048")
    pcfg, w = _program_and_weights(cell)
    ref = cells.reference_module(cell.family)
    t = weights.tokens(7, "t", (2, 33), cell.config["vocab_size"], CPU)
    batch = {"tokens": t[:, :-1], "labels": t[:, 1:]}
    loss, grads = loss_and_grads(pcfg, w, batch)
    names = [n for n, _ in weights.named_leaves(w)]
    leaves = [x.clone().requires_grad_() for _, x in weights.named_leaves(w)]
    tree = weights.map_tree(lambda n, _: leaves[names.index(n)], w)
    r_loss = ref.loss(cell.config, tree, batch)
    r_grads = torch.autograd.grad(r_loss, leaves)
    assert float(loss) == pytest.approx(float(r_loss.detach()), rel=1e-5)
    for n, g, rg in zip(names, grads, r_grads):
        assert float((g - rg).norm()) <= 1e-4 * float(rg.norm()) + 1e-7, n


def test_reference_prefill_matches_the_port():
    from repro_torch.launch.steps import make_prefill_step
    cell = smoke_cell("dsv2lite-prefill-mix8k")
    pcfg, w = _program_and_weights(cell)
    toks = weights.tokens(3, "t", (4, 16), cell.config["vocab_size"], CPU)
    logits, cache = make_prefill_step(pcfg)(w, {"tokens": toks})
    r_logits, r_cache = cells.reference_module(cell.family).prefill(cell.config, w, toks)
    assert torch.allclose(logits[:, -1], r_logits, rtol=1e-4, atol=1e-5)
    ours = cells.family_module(cell.family).cache_of(cache)
    assert len(ours) == len(r_cache) == cell.config["num_hidden_layers"]
    for (c, r), (rc, rr) in zip(ours, r_cache):
        assert torch.allclose(c, rc, atol=1e-5) and torch.allclose(r, rr, atol=1e-5)


# ---------------------------------------------------------------------------
# correct: sound runs pass, planted faults and the control fail
# ---------------------------------------------------------------------------


def _run(cell, monkeypatch):
    # a smoke window on a busy CPU may complete two batches: sample those
    monkeypatch.setattr(cells.mode_module("prefill"), "SAMPLE_FIRST", 2)
    seconds = 0.5 if cell.mode == "prefill" else 0.0
    out = cells.mode_module(cell.mode).run(cell, 2 ** 31 + 12345, seconds, False, CPU, 0.0)
    return session.judge(out["numbers"], cell.limits)[0], out


@pytest.mark.parametrize("name", WORKLOADS)
def test_sound_run_is_correct(name, monkeypatch):
    ok, out = _run(smoke_cell(name), monkeypatch)
    assert ok, out["numbers"]
    assert out["attempted"] > 0 and out["failed"] == 0


def _broken_step(kind):
    from repro_torch.launch import steps
    make = steps.make_train_step

    def make_broken(cfg, opt_cfg, *a, **k):
        step = make(cfg, opt_cfg, *a, **k)

        def broken(params, opt_state, batch):
            if kind == "unchanged":
                _, opt2, out = step([p.clone() for p in params] if isinstance(params, list)
                                    else weights.map_tree(lambda _, x: x.clone(), params),
                                    opt_state, batch)
                return params, opt2, out
            half = {k_: v[:v.shape[0] // 2] for k_, v in batch.items()}
            return step(params, opt_state, half)
        return broken
    return make_broken


@pytest.mark.parametrize("kind", ["unchanged", "half_batch"])
def test_training_faults_are_not_correct(kind, monkeypatch):
    from repro_torch.launch import steps
    monkeypatch.setattr(steps, "make_train_step", _broken_step(kind))
    ok, out = _run(smoke_cell("dsv2lite-train-4x2048"), monkeypatch)
    assert not ok, out["numbers"]


def test_altered_token_is_not_correct(monkeypatch):
    from repro_torch.launch import serve
    # each served token the one the program ranks last
    monkeypatch.setattr(serve, "sample",
                        lambda logits, *a: torch.argmin(logits[:, -1], -1, keepdim=True))
    ok, out = _run(smoke_cell("dsv2lite-prefill-mix8k"), monkeypatch)
    assert not ok and out["numbers"]["token_gap"] > 0


@pytest.mark.parametrize("name", WORKLOADS)
def test_control_in_fp8_is_not_correct(name):
    """The reference in fp8 put in the program's place fails the limits."""
    cell = smoke_cell(name)
    mode = cells.mode_module(cell.mode)
    seed = 424242
    if cell.mode == "train":
        prog = mode.Program(cell, seed, CPU)
        batches, _ = prog.checked_steps(mode.CHECKED_STEPS, seed)
        ref = mode.reference(cell, seed, batches, CPU)
        control = mode.reference(cell, seed, batches, CPU, precision="fp8")
        numbers = mode.numbers(control, ref)
    else:
        prog = mode.Program(cell, seed, CPU, 0.0)
        rows = torch.arange(cell.traffic["prompt_tokens"])
        kept = {i: (prog.prompts(i).clone(), rows) for i in range(2)}
        ref = mode.reference(cell, prog.params, kept, CPU)
        ctl = mode.reference(cell, prog.params, kept, CPU, precision="fp8")
        as_program = {i: (kept[i][0], ctl[i][0].argmax(-1, keepdim=True), ctl[i][0], ctl[i][1],
                          rows) for i in kept}
        numbers = mode.numbers(as_program, ref)
    ok, _ = session.judge(numbers, cell.limits)
    assert not ok, numbers


# ---------------------------------------------------------------------------
# no JAX, and the reference imports nothing of the program
# ---------------------------------------------------------------------------


def test_forbidden_modules_are_compared_by_whole_top_level_name(monkeypatch):
    for name in ("repro_torch", "repro_torch.models", "reproducible", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert not [m for m in bench_run.loaded_forbidden()
                if m.split(".")[0] in ("repro_torch", "reproducible", "jaxtyping")]
    for name in ("repro", "repro.models", "jax.numpy", "flax"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert {"repro", "repro.models", "jax.numpy", "flax"} <= set(bench_run.loaded_forbidden())


def test_reference_imports_nothing_of_the_program(tmp_path):
    assert bench_run.reference_imports() == []
    (tmp_path / "bench" / "reference").mkdir(parents=True)
    (tmp_path / "bench/reference/bad.py").write_text(
        "import torch\nfrom repro_torch.models import moe\nimport jax.numpy as jnp\n")
    assert bench_run.reference_imports(tmp_path) == [("bad.py", "repro_torch.models"),
                                                     ("bad.py", "jax.numpy")]


def test_run_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "path", list(sys.path))
    for key in ("USE_FLAX", "USE_JAX", "TRITON_CACHE_DIR"):
        monkeypatch.setenv(key, "0")
    with pytest.raises(SystemExit) as e:
        bench_run.main(["--workload", WORKLOADS[0], "--seed", "1", "--seconds", "1"])
    assert e.value.code != 0 and capsys.readouterr().out == ""
