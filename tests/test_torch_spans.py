"""The port's spans and counters (``repro_torch.spans``) on the CPU: a span
with no profiler, the names and nesting a profiler sees in a MoE model's train
step and serving, the same bits with a profiler and without, the counters,
and the operator script's split of device time by span."""
from __future__ import annotations

import contextlib
import importlib.util
import threading
import types
from pathlib import Path

import pytest
import torch
from torch.autograd import DeviceType
from torch.autograd.profiler_util import Interval
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve
from repro_torch.launch.steps import loss_and_grads, make_prefill_step, make_train_step
from repro_torch.models.common import get_model, tree_leaves
from repro_torch.optim import AdamWConfig, adamw_init

ARCH = "deepseek-v2-lite-16b"        # MLA and routed experts: every layer's span


def _model(seed=0):
    cfg = get_smoke_config(ARCH)
    params = get_model(cfg).init(cfg, torch.Generator().manual_seed(seed), "cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 17), generator=gen)
    return cfg, params, {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _recorded(fn):
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        fn()
    return [e for e in prof.events() if e.name.startswith(spans.PREFIX)]


def _name(evt) -> str:
    return evt.name[len(spans.PREFIX):]


def _ancestors(evt):
    out, evt = [], evt.cpu_parent
    while evt is not None:
        if evt.name.startswith(spans.PREFIX):
            out.append(_name(evt))
        evt = evt.cpu_parent
    return out


def test_span_without_a_profiler_is_one_shared_null_context():
    off = spans.span("train_step", step=3)
    assert off is spans.span("kernel.fa_fwd", torch.zeros(2), causal=True)
    assert isinstance(off, contextlib.nullcontext)
    with off:
        pass


def test_span_under_a_profiler_is_a_host_range_with_its_inputs_and_ids():
    x = torch.zeros(3, 5)

    def one():
        with spans.span("kernel.fa_fwd", x, causal=True, window=0):
            pass

    (evt,) = _recorded(one)
    assert evt.name == "repro_torch.kernel.fa_fwd"
    assert evt.input_shapes == [[3, 5]]
    assert evt.kwinputs == {"causal": True, "window": 0}
    # function scope: not a user annotation, which the profiler would also
    # draw on the device's timeline
    assert evt.scope == 0


def test_train_step_spans_nest_and_carry_step_numbers():
    cfg, params, batch = _model()
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=0))
    state = {"params": params, "opt": adamw_init(params)}

    def two_steps():
        for _ in range(2):
            state["params"], state["opt"], _ = step(state["params"], state["opt"], batch)

    first = spans.counters()["train_step"]
    events = _recorded(two_steps)
    forwards = [e for e in events if _name(e) == "train_step.forward"]
    assert [e.kwinputs["step"] for e in forwards] == [first, first + 1]
    parents = {}
    for e in events:
        parents.setdefault(_name(e), set()).add(tuple(_ancestors(e)))
    # no span encloses the backward's wait on the main thread
    assert parents["train_step.forward"] == parents["optimizer"] == {()}
    assert parents["optimizer.norm"] == {("optimizer",)}
    moe = ("moe", "train_step.forward")
    assert parents["moe"] == {moe[1:]}
    for part in ("moe.route", "moe.dispatch", "moe.experts", "moe.combine"):
        assert parents[part] == {moe}, part
    assert parents["mla.expand"] == {("train_step.forward",)}
    assert parents["attention.kernel"] == {("train_step.forward",)}
    assert spans.counters()["train_step"] == first + 2


def test_serving_spans_nest_and_carry_batch_numbers():
    cfg, params, batch = _model()
    prefill = make_prefill_step(cfg)
    decode = get_model(cfg).decode_step
    tokens = batch["tokens"]

    def serve_two():
        for _ in range(2):
            logits, cache = prefill(params, {"tokens": tokens})
            cache = serve.pad_cache_to(cache, tokens.shape[1] + 1, cfg.window)
            tok = serve.sample(logits, 0.0, None)
        decode(cfg, params, cache, {"tokens": tok})

    first = spans.counters()["prefill_step"]
    events = _recorded(serve_two)
    batches = [e for e in events if _name(e) == "prefill_step"]
    assert [e.kwinputs["batch"] for e in batches] == [first, first + 1]
    parents = {}
    for e in events:
        parents.setdefault(_name(e), set()).add(tuple(_ancestors(e)))
    assert parents["serve.pad_cache"] == parents["serve.sample"] == {()}
    assert parents["moe.route"] == {("moe", "prefill_step"), ("moe",)}
    assert parents["attention.kernel"] == {("prefill_step",)}
    assert parents["attention.dense"] == {()}       # the decode step's


def test_step_has_the_same_bits_with_a_profiler_recording():
    cfg, params, batch = _model(seed=5)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=0)

    def run(recording: bool):
        p = _clone(params)
        opt = adamw_init(p)
        step = make_train_step(cfg, opt_cfg)
        ctx = (profile(activities=[ProfilerActivity.CPU]) if recording
               else contextlib.nullcontext())
        with ctx:
            loss, grads = loss_and_grads(cfg, p, batch)
            p, opt, out = step(p, opt, batch)
        return [loss, out["loss"], *grads, *tree_leaves(p), *tree_leaves(opt["m"])]

    for a, b in zip(run(False), run(True), strict=True):
        assert torch.equal(a, b)


def test_counters_is_a_snapshot_of_the_counts():
    spans.count("test.snapshot")
    before = spans.counters()
    spans.count("test.snapshot", 2)
    assert spans.counters()["test.snapshot"] == before["test.snapshot"] + 2
    before["test.snapshot"] = -1            # a copy: the count is untouched
    assert spans.counters()["test.snapshot"] > 0
    assert spans.counters()["test.never_counted"] == 0


def test_counts_from_several_threads_add_up():
    start = spans.counters()["test.threads"]
    threads = [threading.Thread(target=lambda: [spans.count("test.threads")
                                                for _ in range(1000)])
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert spans.counters()["test.threads"] == start + 4000


def test_count_adds_and_returns_the_total():
    start = spans.counters()["test.count"]
    assert spans.count("test.count") == start + 1
    assert spans.count("test.count", 4) == start + 5
    assert spans.counters()["test.count"] == start + 5


def _profile_script():
    path = Path(__file__).resolve().parents[1] / "scripts" / "profile_torch_serve.py"
    spec = importlib.util.spec_from_file_location("profile_torch_serve", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class _Evt:
    """What ``split_by_span`` reads of a ``torch.profiler`` event."""

    def __init__(self, name, start, end, parent=None, id=0, kernels=(), thread=1,
                 seq=-1, scope=0):
        self.name, self.device_type, self.id = name, DeviceType.CPU, id
        self.time_range = Interval(start, end)
        self.kernels = [types.SimpleNamespace(duration=d) for d in kernels]
        self.thread, self.fwd_thread, self.sequence_nr, self.scope = thread, 1, seq, scope
        self.cpu_parent = parent


def _step_events():
    """A forward with the router and an expert product, a ctypes kernel
    launched in its own span, a backward on the engine's thread, and an op
    whose launch waited for room in the queue: the runtime's event inside it
    shares its id, so the profiler hangs the op's kernel on both.  Kernels'
    durations in microseconds."""
    fwd = _Evt("repro_torch.train_step.forward", 0, 100, id=1)
    moe = _Evt("repro_torch.moe", 2, 60, fwd, id=2)
    route = _Evt("repro_torch.moe.route", 5, 20, moe, id=3)
    experts = _Evt("repro_torch.moe.experts", 25, 55, moe, id=4)
    mul = _Evt("aten::mul", 6, 9, route, id=5, kernels=[3], seq=7)
    bwd = _Evt("autograd::engine::evaluate_function: BmmBackward0", 110, 150,
               thread=2, seq=8, scope=1, id=8)
    return [fwd, moe, route, experts, mul,
            _Evt("Command Buffer Full", 7, 8, mul, id=5, kernels=[3]),
            _Evt("aten::bmm", 30, 40, experts, id=6, kernels=[6], seq=8),
            _Evt("repro_torch.kernel.fa_fwd", 70, 75, fwd, id=7, kernels=[5]),
            bwd, _Evt("aten::bmm", 112, 120, bwd, id=9, kernels=[8], thread=2),
            _Evt("aten::copy_", 160, 162, id=10, kernels=[1])]


def test_split_by_span_counts_each_device_operation_once():
    split = _profile_script().split_by_span(_step_events(), 0.023)
    assert split == pytest.approx({"moe.route": 0.003, "moe.experts": 0.006 + 0.008,
                                   "kernel.fa_fwd": 0.005, "rest": 0.001})
    assert split["rest"] >= 0


def test_split_by_span_leaves_ops_outside_every_span_to_the_rest():
    events = [e for e in _step_events() if e.name in ("aten::copy_", "aten::mul")]
    for e in events:
        e.cpu_parent = None
    assert _profile_script().split_by_span(events, 0.004) == pytest.approx({"rest": 0.004})
