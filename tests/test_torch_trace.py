"""The spans and counters of the port's batched phase 1 (ipx_tpu_torch/
trace.py, parallel/batch.py): their nesting, the CR trips by precision, the
host reads counted against the reads the solve makes, that a span enters
the profiler's trace only while a profiler runs and changes nothing else,
and the device CR's matvec time reported as not measured.

The CPU tests run the plain versions on "torch_cpu" at a tiny size; the
one card test (marker ``cuda``) runs the kernels' path, where K7's loop
reads its stop flag every POLL trips."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ipx_tpu_torch import kernels, testgen, trace
from ipx_tpu_torch.ops import device_cr
from ipx_tpu_torch.parallel import batch

SPANS = {"ipxt.construct", "ipxt.construct.operands",
         "ipxt.construct.inputs", "ipxt.solve", "ipxt.start", "ipxt.step",
         "ipxt.cr", "ipxt.cr.f32", "ipxt.cr.f64", "ipxt.copy_out"}
# a parent span and its children, whose seconds sum to no more than its own
NESTING = {"ipxt.construct": ("ipxt.construct.operands",
                              "ipxt.construct.inputs"),
           "ipxt.solve": ("ipxt.start", "ipxt.step", "ipxt.copy_out"),
           "ipxt.cr": ("ipxt.cr.f32", "ipxt.cr.f64")}
# the host's waits in the solve's copy to the host on the CPU: none, its
# arrays are the state's own memory (on the card one, after every DMA)
COPIED = 0


def _lp(B=4, seed=1):
    d = testgen.transportation(30, 45, 0.3, seed)
    rng = np.random.default_rng(seed)
    b = np.asarray(d["rhs"])[None, :] * rng.uniform(0.95, 1.05,
                                                    (B, d["num_constr"]))
    return batch.BatchedScenarioSolver(d, b).blp


def _solver(cr_dtype, device="torch_cpu", cls=batch.BatchedPhase1Solver,
            **kw):
    return cls(_lp(), feasibility_tol=1e-4, optimality_tol=1e-4,
               cr_dtype=cr_dtype, device=device, **kw)


@pytest.mark.parametrize("cr_dtype", ["f32", "f64"])
def test_spans_nest_as_named(cr_dtype):
    s = _solver(cr_dtype)
    s.solve(handoff="auto")
    sec = s.trace.seconds
    want = SPANS - ({"ipxt.cr.f32"} if cr_dtype == "f64" else set())
    assert set(sec) == want
    assert all(v > 0 for v in sec.values())
    for parent, children in NESTING.items():
        assert sum(sec.get(c, 0.0) for c in children) <= sec[parent]
    # every CR solve runs inside the starting point or a step
    assert sec["ipxt.cr"] <= sec["ipxt.start"] + sec["ipxt.step"]


@pytest.mark.parametrize("cr_dtype", ["f32", "f64"])
def test_trips_by_precision_add_up_to_cr(cr_dtype):
    s = _solver(cr_dtype)
    out = s.solve(handoff="auto")
    c = s.trace.counts
    if cr_dtype == "f32":
        assert c["cr_f32_trips"] > 0 and c["cr_f64_trips"] > 0
        assert c["cr_f32_trips"] + c["cr_f64_trips"] == out["cr"]
    else:
        assert "cr_f32_trips" not in c
        assert c["cr_f64_trips"] == out["cr"]


def _count_reads(monkeypatch):
    """Counts each read of a tensor's value into Python: bool, float, int,
    item and the copy to the host, and each wait for a card's stream (the
    copy out's, after its DMAs)."""
    reads = []
    for cls, name in [(torch.Tensor, n) for n in ("__bool__", "__float__",
                                                   "__int__", "item", "cpu")
                      ] + [(torch.cuda.Stream, "synchronize")]:
        orig = getattr(cls, name)

        def wrapped(self, *a, _orig=orig, **k):
            reads.append(1)
            return _orig(self, *a, **k)
        monkeypatch.setattr(cls, name, wrapped)
    return reads


@pytest.mark.parametrize("cr_dtype", ["f32", "f64"])
def test_host_syncs_count_every_read(cr_dtype, monkeypatch):
    """host_syncs against the reads the solve makes, and, in float64 (one
    K7 loop a CR solve), against the sites' count from its steps and each
    loop's trips: the plain K7 reads its test once a trip and once more
    where it stops before its cap."""
    loops, steps = [], []

    def counted(nmd, W, invd, resscale, rhs, tol, maxiter):
        Y, t = batch.batched_cr_plain(nmd, W, invd, resscale, rhs, tol,
                                      maxiter)
        loops.append(t + (t < maxiter))
        return Y, t

    class Counted(batch.BatchedPhase1Solver):
        batched_cr = staticmethod(counted)

        def _ipm_step(self, S):
            steps.append(1)
            return super()._ipm_step(S)

    s = _solver(cr_dtype, cls=Counted)
    reads = _count_reads(monkeypatch)
    s.solve(handoff="auto")
    monkeypatch.undo()
    syncs = s.trace.counts["host_syncs"]
    assert syncs == len(reads)
    if cr_dtype == "f64":
        assert len(loops) == 2 + 2 * len(steps)
        assert syncs == sum(loops) + len(steps) + COPIED


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
    s = _solver("f32")
    s.solve(handoff="auto")
    assert entered == [] and s.trace.counts["host_syncs"] > 0
    with profile(activities=[ProfilerActivity.CPU]):
        _solver("f32", maxiter=2).solve(handoff="auto")
    assert set(entered) == SPANS


def _run(cr_dtype, profiled, device="torch_cpu"):
    """A solve of 3 steps (the profiler records every operation)."""
    launches = dict(kernels.LAUNCHES)
    s = _solver(cr_dtype, device=device, maxiter=3)
    if profiled:
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if s.device.type == "cuda" else [])
        with profile(activities=acts) as prof:
            out = s.solve(handoff="auto")
    else:
        prof, out = None, s.solve(handoff="auto")
    moved = {k: v - launches[k] for k, v in kernels.LAUNCHES.items()}
    return s, out, moved, prof


@pytest.mark.parametrize("cr_dtype", ["f32", "f64"])
def test_the_profiler_sees_the_spans_and_changes_nothing(cr_dtype):
    s0, out0, moved0, _ = _run(cr_dtype, False)
    s1, out1, moved1, prof = _run(cr_dtype, True)
    names = {e.name for e in prof.events()}
    # the solve's spans (the constructor ran before the profiler)
    assert set(s1.trace.seconds) - names == {
        "ipxt.construct", "ipxt.construct.operands", "ipxt.construct.inputs"}
    assert moved0 == moved1
    assert s0.trace.counts == s1.trace.counts
    assert set(out0) == set(out1)
    for k in out0:
        np.testing.assert_array_equal(out0[k], out1[k], err_msg=k)


def test_no_record_outside_a_solver():
    """Outside a solver's constructor and solve() the calls add nothing;
    a record in progress takes them, innermost first."""
    trace.count("host_syncs")
    with trace.span("ipxt.step"):
        pass
    outer, inner = trace.Record(), trace.Record()
    with trace.recording(outer):
        trace.count("n", 2)
        with trace.recording(inner), trace.span("s"):
            trace.count("n")
        trace.count("n")
    assert outer.counts == {"n": 3} and outer.seconds == {}
    assert inner.counts == {"n": 1} and set(inner.seconds) == {"s"}


def test_the_record_holds_what_a_request_would_read():
    """The five numbers of a request that its per-layer metrics would read
    (tools/torch_spans.request_numbers): the constructor's halves and the
    copy out in host seconds, the float64 trips and the host reads; and
    the bytes copied through page-locked and pageable memory, none on the
    CPU, where nothing is copied."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "torch_spans.py")
    spec = importlib.util.spec_from_file_location("torch_spans", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    s = _solver("f32")
    out = s.solve(handoff="auto")
    got = tool.request_numbers(s.trace)
    assert set(got) == {"construct_operands_s", "construct_inputs_s",
                        "copy_out_s", "cr_f64_trips", "host_syncs",
                        "copy_bytes_pinned", "copy_bytes_pageable"}
    assert got["construct_operands_s"] + got["construct_inputs_s"] \
        <= s.trace.seconds["ipxt.construct"]
    assert 0 < got["cr_f64_trips"] < out["cr"]
    assert got["host_syncs"] == s.trace.counts["host_syncs"]
    assert got["copy_out_s"] > 0
    assert got["copy_bytes_pinned"] == got["copy_bytes_pageable"] == 0


@pytest.mark.parametrize("mixed", [False, True])
def test_device_cr_reports_no_matvec_time(mixed):
    from ipx_tpu_torch.control import Control
    from ipx_tpu_torch.model import Model
    from ipx_tpu_torch.presolve import Presolver
    from ipx_tpu_torch.sparse import normal_diag
    from ipx_tpu_torch.user_model import UserModel
    d = testgen.transportation(20, 30, 0.3, 3)
    um = UserModel()
    assert um.load(d["num_constr"], d["num_var"], d["Ap"], d["Ai"], d["Ax"],
                   d["rhs"], d["constr_type"], d["obj"], d["lb"],
                   d["ub"]) == 0
    md, ctrl = Model(), Control()
    ctrl.parameters.display = 0
    Presolver(um, md).presolve_model(ctrl)
    m, n = md.num_rows, md.num_cols
    rng = np.random.default_rng(3)
    W = rng.uniform(0.5, 2.0, n + m)
    cls = (device_cr.MixedPrecisionDeviceCR if mixed
           else device_cr.DeviceNormalCR)
    cr = cls(md, W, normal_diag(md.A, W), 1.0 / np.sqrt(W[n:]),
             device=torch.device("cpu"))
    y, iters, err, total, matvec = cr.solve(rng.standard_normal(m), 1e-8,
                                            -1)
    assert err == 0 and iters > 0 and total > 0
    assert matvec == 0.0


@pytest.mark.cuda
def test_card_counts_and_spans(monkeypatch):
    """On the card: the trips add up, host_syncs equals the reads (K7's
    polls and its result among them), and under the profiler every span is
    a host event and none a device operation (as lpbench/tracing.py tells
    them apart), with the same counts, launches and answer as without."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    s = _solver("f32", device="cuda")
    # the constructor's one wait, for its limits, is not the solve's
    assert s.trace.counts["host_syncs"] == 1
    reads = _count_reads(monkeypatch)
    s.solve(handoff="auto")
    monkeypatch.undo()
    assert s.trace.counts["host_syncs"] == 1 + len(reads)
    s0, out0, moved0, _ = _run("f32", False, device="cuda")
    s1, out1, moved1, prof = _run("f32", True, device="cuda")
    c = s0.trace.counts
    assert c["cr_f32_trips"] + c["cr_f64_trips"] == out0["cr"]
    assert s0.trace.counts == s1.trace.counts and moved0 == moved1
    for k in out0:
        np.testing.assert_array_equal(out0[k], out1[k], err_msg=k)
    host, device = set(), set()
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("ipxt."):
            on_card = (e.device_type() == torch.autograd.DeviceType.CUDA
                       and not getattr(e, "is_user_annotation", bool)())
            (device if on_card else host).add(e.name())
    assert not device
    assert SPANS - {"ipxt.construct", "ipxt.construct.operands",
                    "ipxt.construct.inputs"} <= host
