"""Spans and counters of the port's solvers, one record a solver.

`span(name)` times a block by the host's clock and adds its seconds to the
record of the solve in progress. While torch.profiler runs, the span also
enters `record_function(name)`, so that the block appears in the profiler's
trace on the trace's own clock, nested under the caller's spans.
`count(name, n)` adds n to a counter of the same record.

Two owners keep a Record (`solver.trace`) and make it the record in
progress:

* a BatchedPhase1Solver (parallel/batch.py), inside its constructor and
  its solve(), over both and every solve() since: the spans `ipxt.construct`,
  `ipxt.solve` and theirs, the counters of the batched CR;
* an LpSolver (lp_solver.py), inside its solve(), a new record each
  solve(): `ipxt.lp.ipm1` (the starting point and the initial IPM, around
  what Info.time_ipm1 times), `ipxt.lp.basis` (Info.time_starting_basis),
  `ipxt.lp.ipm2` (Info.time_ipm2) with `ipxt.lp.factorize` (DropPrimal,
  DropDual, maxvolume, LU, kkt/basis_precond.py) and `ipxt.lp.kkt2` (the
  phase-2 CR solves) inside it, `ipxt.lp.crossover` (the push phases that
  Info.time_crossover times); the counters `kkt1_trips` and `kkt2_trips`
  (Info.kktiter1, Info.kktiter2), `basis_updates` (Info.updates_ipm),
  `lu_factorizations` (the basis's, over the solve) and `host_syncs` (the
  phase-2 CR's N N' applies, each one host read of the product).

Code that has no solver at hand (the K7 driver, kernels.py, the phase-2
N N' plan) adds to the record in progress through the same two calls.
Outside a solver's constructor and solve() they add to no record, and a
span only enters the profiler's trace.

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
    """A solver's spans (host seconds by span name) and counters."""

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
