"""The spans and counters of LpSolver.solve() (ipx_tpu_torch/trace.py,
lp_solver.py, kkt/diag.py, kkt/basis_precond.py, ops/device_cr2.py): their
nesting, their seconds against Info's timers, the counters against Info's
counts, the spans in a profiler's trace, no record outside solve(), and the
batched solver's record as it was.

On "torch_cpu" (the plain versions) at a tiny transportation and a tiny
staircase LP, each solve under a second."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ipx_tpu_torch import LpSolver, Parameters, testgen, trace
from ipx_tpu_torch.parallel import batch

SPANS = {"ipxt.lp.ipm1", "ipxt.lp.basis", "ipxt.lp.ipm2",
         "ipxt.lp.factorize", "ipxt.lp.kkt2", "ipxt.lp.crossover"}
COUNTS = {"kkt1_trips", "kkt2_trips", "basis_updates", "lu_factorizations",
          "host_syncs"}
# each span and the Info timer that times the same block
TIMERS = {"ipxt.lp.ipm1": "time_ipm1",
          "ipxt.lp.basis": "time_starting_basis",
          "ipxt.lp.ipm2": "time_ipm2",
          "ipxt.lp.kkt2": "time_cr2",
          "ipxt.lp.crossover": "time_crossover"}
# a span's seconds beyond its timer's: the code between the two clock
# reads (the crossover's residuals and log lines, the CR's call)
SLACK_S = 0.05
# the batched phase 1's spans and counters on the CPU, where it copies no
# byte between host and card (tests/test_torch_trace.py)
BATCHED_SPANS = {"ipxt.construct", "ipxt.construct.operands",
                 "ipxt.construct.inputs", "ipxt.solve", "ipxt.start",
                 "ipxt.step", "ipxt.cr", "ipxt.cr.f32", "ipxt.cr.f64",
                 "ipxt.copy_out"}
BATCHED_COUNTS = {"cr_f32_trips", "cr_f64_trips", "host_syncs"}

LPS = {"transportation": lambda: testgen.transportation(30, 45, 0.3, 1),
       "staircase": lambda: testgen.staircase(6, 60, seed=1)}


def _solved(lp, **kw):
    s = LpSolver(Parameters(device="torch_cpu", display=0, **kw))
    assert testgen.load_into_solver(LPS[lp](), s) == 0
    assert s.solve() == 1000
    return s


@pytest.mark.parametrize("lp", sorted(LPS))
def test_spans_nest_as_named(lp):
    s = _solved(lp)
    sec = s.trace.seconds
    assert set(sec) == SPANS
    assert all(v > 0 for v in sec.values())
    assert sec["ipxt.lp.factorize"] + sec["ipxt.lp.kkt2"] \
        <= sec["ipxt.lp.ipm2"]
    top = ("ipxt.lp.ipm1", "ipxt.lp.basis", "ipxt.lp.ipm2",
           "ipxt.lp.crossover")
    assert sum(sec[k] for k in top) <= s.get_info().time_total


@pytest.mark.parametrize("lp", sorted(LPS))
def test_spans_agree_with_info(lp):
    s = _solved(lp)
    info = s.get_info()
    for name, timer in TIMERS.items():
        own, theirs = s.trace.seconds[name], getattr(info, timer)
        assert theirs > 0, timer
        assert theirs - 1e-6 <= own <= theirs + SLACK_S, (name, own, theirs)


@pytest.mark.parametrize("lp", sorted(LPS))
def test_counters_equal_info(lp):
    s = _solved(lp)
    c, info = s.trace.counts, s.get_info()
    assert set(c) == COUNTS
    assert c["kkt1_trips"] == info.kktiter1 > 0
    assert c["kkt2_trips"] == info.kktiter2 > 0
    assert c["basis_updates"] == info.updates_ipm
    assert c["lu_factorizations"] >= 1
    # one read of the N N' product an apply: at least one a CR trip
    assert c["host_syncs"] >= c["kkt2_trips"]


def _counts_match_info(s):
    c, info = s.trace.counts, s.get_info()
    return (set(c) == COUNTS and c["kkt1_trips"] == info.kktiter1
            and c["kkt2_trips"] == info.kktiter2
            and c["basis_updates"] == info.updates_ipm)


def test_the_profiler_sees_the_spans():
    """Under a profiler the spans are in its trace and the solve ends at
    the same vertex objective. (Two solves need not make the same trips:
    the native LU refactorizes by the clock.)"""
    s0 = _solved("staircase")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s1 = _solved("staircase")
    names = {e.name for e in prof.events()}
    assert SPANS <= names
    assert set(s1.trace.seconds) == SPANS and _counts_match_info(s1)
    o0, o1 = s0.get_info().objval, s1.get_info().objval
    assert abs(o0 - o1) <= 1e-9 * (1 + abs(o0))


def test_nothing_is_recorded_outside_solve():
    s = LpSolver(Parameters(device="torch_cpu", display=0))
    assert s.trace.seconds == {} and s.trace.counts == {}
    testgen.load_into_solver(LPS["transportation"](), s)
    assert s.trace.seconds == {} and s.trace.counts == {}
    s.solve()
    first = s.trace
    seconds, counts = dict(first.seconds), dict(first.counts)
    with trace.span("ipxt.lp.ipm1"):
        trace.count("kkt1_trips", 5)
    s.get_basic_solution()
    s.get_info()
    assert first.seconds == seconds and first.counts == counts
    # each solve() keeps a record of its own
    s.solve()
    assert s.trace is not first and _counts_match_info(s)


def test_the_batched_record_is_unchanged():
    d = testgen.transportation(30, 45, 0.3, 1)
    rng = np.random.default_rng(1)
    b = np.asarray(d["rhs"])[None, :] * rng.uniform(0.95, 1.05,
                                                    (4, d["num_constr"]))
    solver = batch.BatchedPhase1Solver(
        batch.BatchedScenarioSolver(d, b).blp, feasibility_tol=1e-4,
        optimality_tol=1e-4, cr_dtype="f32", device="torch_cpu")
    solver.solve(handoff="auto")
    assert set(solver.trace.seconds) == BATCHED_SPANS
    assert set(solver.trace.counts) == BATCHED_COUNTS
    seconds = dict(solver.trace.seconds)
    counts = dict(solver.trace.counts)
    # an LpSolver solved while the batched record is in progress adds to
    # its own record alone
    with trace.recording(solver.trace):
        lp = _solved("transportation")
    assert solver.trace.seconds == seconds and solver.trace.counts == counts
    assert set(lp.trace.seconds) == SPANS


def test_no_record_function_without_a_profiler(monkeypatch):
    entered = []

    class Fake:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False
    monkeypatch.setattr(trace, "record_function", Fake)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: entered.append("synchronize"))
    s = _solved("staircase")
    assert entered == [] and set(s.trace.seconds) == SPANS
