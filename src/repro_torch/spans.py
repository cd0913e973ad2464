"""The port's named spans and its counters, in one place.

``span(name, *tensors, **ids)`` marks a piece of the port's work.  While a
``torch.profiler`` session records, it opens the host range
``repro_torch.<name>`` with ``tensors`` as its inputs (their shapes, where the
profiler records shapes) and ``ids`` as its keyword arguments; the profiler puts
it on the timeline of the device's operations, so a device operation, or an
idle gap, lies under the spans that were open when the host launched it.
Otherwise it returns one shared null context: a bool read.  The range is a
function-scope one (not ``record_function``'s user scope), so the profiler
draws it on the host only and adds no annotation to the device's timeline.

``count(name, n)`` adds to one of the process-wide counters and is always
on; ``counters()`` is a snapshot of them all.  Counts only grow: what a piece of work
did is the difference of two readings.

``core.tracing`` is another thing: the scheduler simulator's bus of decisions
on simulated time, where this module marks the port's work on the host's clock.
"""
from __future__ import annotations

import collections
import contextlib
import threading

import torch
import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast

PREFIX = "repro_torch."

_OFF = contextlib.nullcontext()
_COUNTS: collections.Counter = collections.Counter()
# the autograd engine's thread counts too (a backward kernel's calls)
_LOCK = threading.Lock()


def span(name: str, *tensors: torch.Tensor, **ids):
    """The range ``repro_torch.<name>`` while a profiler records, else a null
    context.  ``ids`` are ints, floats, bools or strings."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _RecordFunctionFast(PREFIX + name, tensors, ids)


def count(name: str, n=1):
    """Add ``n`` to the counter ``name``; return its new value."""
    with _LOCK:
        _COUNTS[name] += n
        return _COUNTS[name]


def counters() -> collections.Counter:
    """A snapshot of the program's counts; a name never counted reads 0."""
    with _LOCK:
        return collections.Counter(_COUNTS)
