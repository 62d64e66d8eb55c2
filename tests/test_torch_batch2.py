"""The shared-basis batched polish of ipx_tpu_torch (parallel/batch2.py) on
the CPU, with the plain versions of the step's kernels, against ipx_tpu:
test_batch2.py's polish tests ported to the port, at their tolerances.

The polish's CR (SharedBasisBatchedCR, with the low-rank correction) is
the port's copy of ipx_tpu's host code; its step is the port's, so its
iterates follow the reference's up to the rounding of the step's sums,
which the inexact CR lets grow. The objectives are compared as test_batch2.py compares them:
the polish pipeline to 1e-5 of the per-scenario solves' objectives, the
scenario solver's vertices to 1e-6.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import ipx_tpu
import ipx_tpu_torch
from ipx_tpu.parallel import batch as ref
from ipx_tpu_torch.testgen import load_into_solver, transportation
from ipx_tpu_torch.parallel import batch as port
from ipx_tpu_torch.parallel import batch2 as port2


def _transport_batch(data, B, lo, hi, seed):
    m, n = data["num_constr"], data["num_var"]
    A = sp.csc_matrix((data["Ax"], data["Ai"], data["Ap"]), shape=(m, n))
    ct = np.asarray(list(data["constr_type"]))
    lb = np.concatenate([data["lb"], np.where(ct == ">", -np.inf, 0.0)])
    ub = np.concatenate([data["ub"], np.where(ct == "<", np.inf, 0.0)])
    rng = np.random.default_rng(seed)
    b_batch = data["rhs"][None, :] * rng.uniform(lo, hi, size=(B, m))
    c = np.zeros((B, n + m))
    c[:, :n] = data["obj"]
    return port.BatchedLp(A=A, b=b_batch, c=c, lb=lb, ub=ub)


def _host_objval(data, rhs):
    p = ipx_tpu.Parameters()
    p.display = 0
    p.device = "cpu"
    s = ipx_tpu.LpSolver(p)
    assert load_into_solver(dict(data, rhs=rhs), s) == 0
    assert s.solve() == 1000
    return s.get_info().objval


def test_shared_basis_batched_polish_pipeline():
    """test_batch2.py's pipeline on the port: a loose batched phase 1, the
    mean-scenario basis, then the polish on device="torch_cpu" drives mu
    below 1e-5 on every lane and pobj within 1e-5 of each scenario's own
    solve. The low-rank correction engages on the lanes that stall, and
    no correction or refresh fails."""
    data = transportation(50, 100, 0.06, seed=12)
    blp = _transport_batch(data, 4, 0.98, 1.05, seed=6)
    state = port.BatchedPhase1Solver(
        blp, feasibility_tol=1e-3, optimality_tol=1e-3, maxiter=60,
        device="torch_cpu").solve()
    p = ipx_tpu_torch.Parameters(display=0, device="cpu", scale=0,
                                 dualize=0, crossover=0)
    s = ipx_tpu_torch.LpSolver(p)
    assert load_into_solver(dict(data, rhs=blp.b.mean(axis=0)), s) == 0
    assert s.solve() == 1000
    basis = s.basis
    if not basis.factorization_is_fresh:
        assert basis.factorize() == 0
    polish = port2.SharedBasisBatchedPolish(
        blp, basis, feasibility_tol=1e-8, optimality_tol=1e-8,
        device="torch_cpu")
    out = polish.run(state)
    assert out["done"].dtype == bool
    assert np.all(out["mu"] < 1e-5)
    for k in range(blp.batch):
        want = _host_objval(data, blp.b[k])
        assert abs(out["pobj"][k] - want) <= 1e-5 * max(1.0, abs(want)), k
    assert polish.corrected_solves > 0
    assert polish.correction_failures == polish.refresh_failures == 0
    assert 0 < len(polish.step_cr) <= polish.maxiter
    assert sum(polish.step_cr) == polish.total_cr_iters > 0


def test_scenario_solver_with_polish_enabled():
    """BatchedScenarioSolver(phase2_polish=True) on device="torch_cpu":
    every scenario at status 1000 with the reference's objective to 1e-6,
    through the polish."""
    data = transportation(40, 80, 0.08, seed=2)
    m = data["num_constr"]
    rng = np.random.default_rng(7)
    b_batch = data["rhs"][None, :] * rng.uniform(0.98, 1.04, size=(3, m))
    want = ref.BatchedScenarioSolver(
        data, b_batch, parameters=ipx_tpu.Parameters(display=0, device="cpu"),
        phase2_polish=True).solve()
    sv = port.BatchedScenarioSolver(
        data, b_batch,
        parameters=ipx_tpu_torch.Parameters(display=0, device="torch_cpu"),
        phase2_polish=True)
    got = sv.solve()
    assert sv.polish is not None and sv.polish.total_cr_iters > 0
    assert sv.polish.correction_failures == sv.polish.refresh_failures == 0
    for k, ((st, info, _), (_, info_r, _)) in enumerate(zip(got, want)):
        assert st == 1000, k
        assert abs(info.objval - info_r.objval) \
            <= 1e-6 * max(1.0, abs(info_r.objval)), k


def test_polish_keeps_the_state_when_the_mean_solve_fails(monkeypatch):
    """The reference's explicit fallback: a mean-scenario solve that does
    not reach status 1000 leaves the phase-1 state unpolished."""
    data = transportation(10, 15, 0.3, seed=3)
    b = data["rhs"][None, :] * np.array([[1.0], [1.02]])
    sv = port.BatchedScenarioSolver(data, b, phase2_polish=True)

    class Stopped:
        basis = None

        def solve(self):
            return 1005

    monkeypatch.setattr(sv, "_load", lambda p, k=None: Stopped())
    out = {"X": np.zeros(1)}
    assert sv._polish(out) is out
    assert sv.polish is None


def test_polish_on_cuda_raises_without_a_card(monkeypatch):
    """device="cuda" without a card raises on the polish path, from the
    polish itself and from BatchedScenarioSolver(phase2_polish=True)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = transportation(10, 15, 0.3, seed=3)
    b = data["rhs"][None, :] * np.array([[1.0], [1.02]])
    sv = port.BatchedScenarioSolver(
        data, b, parameters=ipx_tpu_torch.Parameters(display=0,
                                                     device="cuda"),
        phase2_polish=True)
    assert sv.phase2_polish
    with pytest.raises(RuntimeError, match="is_available"):
        port2.SharedBasisBatchedPolish(sv.blp, None, device="cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        sv.solve()


@pytest.mark.parametrize("fault", ["cholesky", "maxvolume"])
def test_polish_counts_what_the_reference_let_pass(monkeypatch, fault):
    """A low-rank correction whose Cholesky factorization fails, and a
    maxvolume refresh that returns an error code, were silent in the
    reference: the port counts them (correction_failures,
    refresh_failures) and the polish goes on without the correction or
    with the previous basis."""
    data = transportation(20, 30, 0.2, seed=4)
    blp = _transport_batch(data, 2, 0.98, 1.03, seed=5)
    state = port.BatchedPhase1Solver(
        blp, feasibility_tol=1e-3, optimality_tol=1e-3,
        device="torch_cpu").solve()
    p = ipx_tpu_torch.Parameters(display=0, device="cpu", scale=0,
                                 dualize=0, crossover=0)
    s = ipx_tpu_torch.LpSolver(p)
    assert load_into_solver(dict(data, rhs=blp.b.mean(axis=0)), s) == 0
    assert s.solve() == 1000
    polish = port2.SharedBasisBatchedPolish(blp, s.basis, maxiter=3,
                                            device="torch_cpu")
    if fault == "cholesky":
        def singular(G):
            raise np.linalg.LinAlgError("not positive definite")
        monkeypatch.setattr(port2.np.linalg, "cholesky", singular)
        polish._use_correction = True
        # a nonbasic weight far above the rest makes its column an outlier
        m, n = blp.A.shape
        W = torch.ones((n + m, 2), dtype=torch.float64)
        W[int(np.setdiff1d(np.arange(n), s.basis.basis)[0])] = 1e8
        ones = torch.ones((m, 2), dtype=torch.float64)
        Y, _ = polish._cr_solve(W, None, ones, ones,
                                torch.full((2,), 1e-8, dtype=torch.float64))
        assert polish.correction_failures == 1
        assert polish.corrected_solves == 0 and torch.isfinite(Y).all()
    else:
        monkeypatch.setattr(port2.Maxvolume, "run_heuristic",
                            lambda self, colscale, basis: 1)
        before = s.basis.basis.copy()
        out = polish.run(state)
        assert polish.refresh_failures == len(polish.step_cr) > 0
        assert np.array_equal(s.basis.basis, before)
        assert np.all(np.isfinite(out["mu"]))


def _polish_scaling_lane_0(monkeypatch, factor):
    """(polish, its input state, its output) of a 3-step polish of two
    lanes whose step scales lane 0's duals by `factor` after every step."""
    data = transportation(20, 30, 0.2, seed=4)
    blp = _transport_batch(data, 2, 0.98, 1.03, seed=5)
    state = port.BatchedPhase1Solver(
        blp, feasibility_tol=1e-3, optimality_tol=1e-3,
        device="torch_cpu").solve()
    p = ipx_tpu_torch.Parameters(display=0, device="cpu", scale=0,
                                 dualize=0, crossover=0)
    s = ipx_tpu_torch.LpSolver(p)
    assert load_into_solver(dict(data, rhs=blp.b.mean(axis=0)), s) == 0
    assert s.solve() == 1000
    polish = port2.SharedBasisBatchedPolish(blp, s.basis, maxiter=3,
                                            device="torch_cpu")
    step = polish._ph1._ipm_step

    def scaled(S):
        S = step(S)
        S["ZL"][:, 0] *= factor
        S["ZU"][:, 0] *= factor
        return S
    monkeypatch.setattr(polish._ph1, "_ipm_step", scaled)
    return polish, state, polish.run({k: v.copy() for k, v in state.items()})


def test_polish_hands_back_a_lane_it_made_worse(monkeypatch):
    """A lane whose mu the polish leaves more than DIVERGED times above
    where it started (here lane 0's duals scaled by 1e200 after every
    step, as a diverging lane's were on the card) comes back as it went
    in, not done, and is listed in reverted_lanes and mu_rise; the other
    lane keeps its polished iterate."""
    polish, state, out = _polish_scaling_lane_0(monkeypatch, 1e200)
    assert polish.reverted_lanes == [0]
    assert [lane for lane, _ in polish.mu_rise] == [0]
    assert polish.mu_rise[0][1] > polish.DIVERGED
    for k in ("X", "XL", "XU", "Y", "ZL", "ZU"):
        assert np.array_equal(out[k][:, 0], state[k][:, 0]), k
        assert not np.array_equal(out[k][:, 1], state[k][:, 1]), k
    assert out["iters"][0] == state["iters"][0] and not out["done"][0]
    start = polish.mu_history[0]
    assert out["mu"][0] == start[0] and out["mu"][1] <= start[1]


def test_polish_hands_on_a_lane_whose_mu_rose_less(monkeypatch):
    """A lane whose mu rose, but by DIVERGED or less (lane 0's duals
    scaled by 1e7 after every step: its mu ends about 1e3 times above
    where it started), is handed on polished, as the reference hands it,
    and listed in mu_rise only."""
    polish, state, out = _polish_scaling_lane_0(monkeypatch, 1e7)
    assert polish.reverted_lanes == []
    assert [lane for lane, _ in polish.mu_rise] == [0]
    assert 1.0 < polish.mu_rise[0][1] <= polish.DIVERGED
    assert not np.array_equal(out["ZL"][:, 0], state["ZL"][:, 0])
    assert out["mu"][0] == polish.mu_history[-1][0] > polish.mu_history[0][0]
