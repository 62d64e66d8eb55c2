"""Spans and counters of the batched phase 1, one record a solver.

`span(name)` times a block by the host's clock and adds its seconds to the
record of the solve in progress. While torch.profiler runs, the span also
enters `record_function(name)`, so that the block appears in the profiler's
trace on the trace's own clock, nested under the caller's spans.
`count(name, n)` adds n to a counter of the same record.

A BatchedPhase1Solver owns one Record (`solver.trace`) and makes it the
record in progress inside its constructor and its solve(). Code that has no
solver at hand (the K7 driver, kernels.py) adds to that record through the
same two calls. Outside a solver's constructor and solve() they add to no
record, and a span only enters the profiler's trace.

With no profiler running, a span costs one check and two clock reads; it
never synchronizes the device or allocates on it, traced or not. Its
seconds are host seconds: a block that reads a device value (a copy to the
host, a loop's stop flag) waits there for the device's work before it; a
block that only launches measures the launching.
"""
from __future__ import annotations

import threading
import time

from torch.autograd import _profiler_enabled
from torch.profiler import record_function

__all__ = ["Record", "recording", "span", "count"]


class Record:
    """A solver's spans (host seconds by span name) and counters, over its
    constructor and every solve() since."""

    def __init__(self):
        self.seconds: dict[str, float] = {}
        self.counts: dict[str, int] = {}


_local = threading.local()


def _active() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class recording:
    """Makes `record` the record in progress inside the block."""

    def __init__(self, record: Record):
        self.record = record

    def __enter__(self) -> Record:
        _active().append(self.record)
        return self.record

    def __exit__(self, *exc) -> bool:
        _active().pop()
        return False


class span:
    """Adds the block's host seconds to the record in progress under
    `name`; under a running profiler, also a record_function(name)."""

    __slots__ = ("name", "_rf", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "span":
        self._rf = None
        if _profiler_enabled():
            self._rf = record_function(self.name)
            self._rf.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        dt = time.perf_counter_ns() - self._t0
        if self._rf is not None:
            self._rf.__exit__(*exc)
        stack = _active()
        if stack:
            seconds = stack[-1].seconds
            seconds[self.name] = seconds.get(self.name, 0.0) + dt * 1e-9
        return False


def count(name: str, n: int = 1) -> None:
    """Adds n to the counter `name` of the record in progress."""
    stack = _active()
    if stack:
        counts = stack[-1].counts
        counts[name] = counts.get(name, 0) + n
