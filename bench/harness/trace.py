"""Spans around the program's layers, recorded from the benchmark's side, and
the reduction of a profiler trace to device time.

A per-layer metric names its spans in its reader's ``SPANS``: region ->
``[(module, attribute), ...]``.  While ``Spans.active()`` is open, each of
those functions is replaced in its module by a wrapper that runs it inside
a ``torch.profiler`` range named after the region and records the shapes
of the call.  The program looks these functions up as module globals when it
calls them, so the wrapper sees every call; nothing in the program changes.

``reduce_trace`` turns the profiler's events into the device's busy time
(the union of its operations' intervals), the device time of each region
(the kernels launched inside its range and by the backward of every op that
ran inside it, matched as ``torch.profiler`` matches them, by the forward
op's sequence number and thread), the operations that took most time and
the longest idle gaps, each under what the host was doing when the device
went idle.  The port's own kernels, launched through ``ctypes``, are found
by their names: the profiler links them to no host op.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import importlib
import re
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

RANGE = "bench:"


def describe(value):
    """A call's argument as the spans record it: a tensor by its shape and
    dtype, a plain value as itself, anything else by its type's name."""
    if isinstance(value, torch.Tensor):
        return ("T", tuple(value.shape), str(value.dtype))
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    return type(value).__name__


class Spans:
    """The union of the cell's metrics' ``SPANS``."""

    def __init__(self, spans: Dict[str, Sequence[Tuple[str, str]]]):
        self.spans = {region: list(targets) for region, targets in spans.items()}
        self.calls: Dict[str, List[tuple]] = collections.defaultdict(list)

    @contextlib.contextmanager
    def active(self):
        from torch.profiler import record_function
        saved = []
        for region, targets in self.spans.items():
            for module_name, attr in targets:
                module = importlib.import_module(module_name)
                fn = getattr(module, attr)

                def ranged(*args, _fn=fn, _region=region, **kwargs):
                    self.calls[_region].append(
                        ([describe(a) for a in args],
                         {k: describe(v) for k, v in kwargs.items()}))
                    with record_function(RANGE + _region):
                        return _fn(*args, **kwargs)
                setattr(module, attr, ranged)
                saved.append((module, attr, fn))
        try:
            yield self
        finally:
            for module, attr, fn in reversed(saved):
                setattr(module, attr, fn)


def profiled(fn: Callable[[], None]):
    """Run ``fn`` under ``torch.profiler`` (host and device); return (events,
    seconds by the host clock, from before ``fn`` to the device's end)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    return prof.events(), window_s


@dataclass
class TraceSummary:
    busy_s: float
    region_ms: Dict[str, float]
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    n_device_ops: int = 0
    by_name: Dict[str, float] = field(default_factory=dict)


def _region_of(evt) -> Optional[str]:
    while evt is not None:
        if evt.name.startswith(RANGE):
            return evt.name[len(RANGE):]
        evt = evt.cpu_parent
    return None


def _backward_parent(evt):
    while evt is not None and not (
            evt.scope == 1 or evt.name.startswith("autograd::engine::evaluate_function")):
        evt = evt.cpu_parent
    return evt


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _open_op(roots, starts, t: float):
    """The innermost op of one thread open at time ``t`` and the innermost
    benchmark range around it, or None."""
    i = bisect.bisect_right(starts, t) - 1
    if i < 0 or roots[i].time_range.end < t:
        return None
    evt, region = roots[i], None
    while True:
        if evt.name.startswith(RANGE):
            region = evt.name[len(RANGE):]
        kids = evt.cpu_children
        j = bisect.bisect_right(kids, t, key=lambda c: c.time_range.start) - 1
        if j < 0 or kids[j].time_range.end < t:
            break
        evt = kids[j]
    name = evt.name if not evt.name.startswith(RANGE) else "python"
    return f"{region}:{name}" if region else name


def _host_activity(threads, t: float) -> str:
    """What the host was doing at time ``t`` (microseconds): the innermost op
    open on the busiest thread that has one open (the main thread, then the
    autograd engine's), under the innermost range of the benchmark."""
    for roots, starts in threads:
        found = _open_op(roots, starts, t)
        if found is not None:
            return found
    return "python, no op open"


def reduce_trace(events, top: int = 10) -> TraceSummary:
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.name.startswith(RANGE)]
    if not device:
        raise RuntimeError("the profiler recorded no device operation")
    spans = _union([(e.time_range.start, e.time_range.end) for e in device])
    busy_us = sum(b - a for a, b in spans)

    by_name = collections.Counter()
    for e in device:
        by_name[e.name] += e.time_range.elapsed_us() / 1e6

    cpu = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CPU),
                 key=lambda e: e.time_range.start)
    forward = {}
    for e in cpu:
        if e.sequence_nr >= 0 and _backward_parent(e) is None:
            forward[(e.sequence_nr, e.thread)] = _region_of(e)
    region_ms = collections.Counter()
    for e in cpu:
        if not e.kernels:
            continue
        region = _region_of(e)
        if region is None:
            bwd = _backward_parent(e)
            if bwd is not None:
                region = forward.get((bwd.sequence_nr, bwd.fwd_thread))
        if region is not None:
            region_ms[region] += sum(k.duration for k in e.kernels) / 1e3

    # idle gaps, each named by what the host was doing as it opened
    threads = []
    for thread, _ in collections.Counter(e.thread for e in cpu).most_common():
        roots = [e for e in cpu if e.thread == thread and e.cpu_parent is None]
        threads.append((roots, [e.time_range.start for e in roots]))
    gaps = collections.Counter()
    for (_, end), (nxt, _) in zip(spans, spans[1:]):
        gaps[_host_activity(threads, end)] += (nxt - end) / 1e6
    return TraceSummary(
        busy_s=busy_us / 1e6, region_ms=dict(region_ms),
        device_ops=[[n[:120], s] for n, s in by_name.most_common(top)],
        idle_gaps=[[n[:120], s] for n, s in gaps.most_common(top)],
        n_device_ops=len(device), by_name=dict(by_name))


@dataclass
class Reading:
    """What a per-layer metric's reader gets from a traced run."""
    mode: str                       # the traffic's mode: train, prefill
    window_s: float                 # the traced window by the host clock
    units: int                      # steps or batches completed in it
    model_flops: float              # the model's operations in it (analytic)
    summary: TraceSummary
    calls: Dict[str, List[tuple]]   # region -> the calls recorded in it

    @property
    def busy_s(self) -> float:
        return self.summary.busy_s

    def kernel_ms(self, pattern: str) -> float:
        """Device ms of the operations whose name matches ``pattern`` (a
        regular expression, searched)."""
        return 1e3 * sum(s for n, s in self.summary.by_name.items() if re.search(pattern, n))

    def region_ms(self, region: str) -> Optional[float]:
        """Device ms of ``region`` in the window, or None where no call of
        it was recorded."""
        if not self.calls.get(region):
            return None
        return self.summary.region_ms.get(region, 0.0)
