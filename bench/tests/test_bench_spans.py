"""The program's own spans against the benchmark's reduction of a trace, on
the CPU: a synthetic trace with the program's host ranges (``repro_torch.*``)
reduces to the same device time, regions and operations as the same trace
without them, its idle gaps in the forward and the optimizer are named by
them, and a gap in the backward is still named by the autograd engine's op."""
from __future__ import annotations

import types

import pytest
from torch.autograd import DeviceType
from torch.autograd.profiler_util import Interval

from bench.tests.helpers import ROOT  # noqa: F401  (puts src/ on the path)
from bench.harness.trace import reduce_trace


class Evt:
    """What ``reduce_trace`` reads of a ``torch.profiler`` event."""

    def __init__(self, name, start, end, parent=None, device=DeviceType.CPU,
                 kernels=(), thread=1, fwd_thread=1, seq=-1, scope=0):
        self.name, self.device_type = name, device
        self.time_range = Interval(start, end)
        self.thread, self.fwd_thread = thread, fwd_thread
        self.sequence_nr, self.scope = seq, scope
        self.kernels = [types.SimpleNamespace(duration=d) for d in kernels]
        self.cpu_parent, self.cpu_children = parent, []
        if parent is not None:
            parent.cpu_children.append(self)


def trace(program: bool):
    """A training step's events (microseconds): the MoE layer's router in the
    forward and the optimizer, each inside the benchmark's range, and between
    them a backward on the autograd engine's thread while the main thread
    waits; with ``program`` the program's own ranges around the forward and
    inside the benchmark's."""
    out = []

    def cpu(name, start, end, parent=None, **kw):
        if name.startswith("repro_torch.") and not program:
            return parent
        out.append(Evt(name, start, end, parent, **kw))
        return out[-1]

    forward = cpu("repro_torch.train_step.forward", 0, 95)
    route = cpu("repro_torch.moe.route", 12, 88, cpu("bench:moe", 10, 90, forward))
    cpu("aten::mm", 15, 20, route, kernels=[8], seq=1)
    cpu("cudaMalloc", 30, 60, route)
    cpu("aten::add", 62, 65, route, kernels=[5], seq=2)
    bwd = cpu("autograd::engine::evaluate_function: MmBackward0", 96, 140,
              thread=2, seq=1, scope=1)
    cpu("aten::mm", 121, 125, bwd, kernels=[6], thread=2)
    opt = cpu("repro_torch.optimizer", 142, 199, cpu("bench:optimizer", 141, 200))
    cpu("aten::mul", 145, 150, opt, kernels=[10])
    for name, start, end in (("gemm", 20, 28), ("add", 65, 70), ("gemm", 125, 131),
                             ("mul", 150, 160)):
        out.append(Evt(name, start, end, device=DeviceType.CUDA))
    return out


def test_program_spans_leave_device_time_regions_and_operations_as_they_were():
    with_spans, without = reduce_trace(trace(True)), reduce_trace(trace(False))
    assert with_spans.busy_s == without.busy_s == pytest.approx(29e-6)
    assert with_spans.region_ms == without.region_ms
    assert without.region_ms == pytest.approx({"moe": 0.019, "optimizer": 0.010})
    assert with_spans.device_ops == without.device_ops
    assert with_spans.by_name == without.by_name
    assert with_spans.n_device_ops == without.n_device_ops == 4


def test_idle_gaps_are_named_by_the_program_span_the_host_was_in():
    gaps = dict(reduce_trace(trace(True)).idle_gaps)
    assert gaps["moe:repro_torch.moe.route"] == pytest.approx(92e-6)
    assert dict(reduce_trace(trace(False)).idle_gaps)["moe:python"] == pytest.approx(92e-6)


@pytest.mark.parametrize("program", [True, False])
def test_a_gap_in_the_backward_is_named_by_the_autograd_engine_op(program):
    """No program span is open on the main thread while it waits for the
    backward, so the gap goes to the op the engine's thread runs."""
    gaps = dict(reduce_trace(trace(program)).idle_gaps)
    assert gaps["autograd::engine::evaluate_function: MmBackward0"] == pytest.approx(19e-6)
    assert len(gaps) == 2
