"""The batched scenario phase 1 of ipx_tpu_torch (parallel/batch.py, with
the plain versions of K5-K9 on the CPU) against ipx_tpu's
parallel/batch.py on jax's CPU backend, on the same seeded inputs.

Each test states its tolerance and why. Where the two packages follow the
same arithmetic the results agree to rounding. A whole solve is compared
by what its tolerances guarantee: its CR stops at a loose tolerance
(kkt_tol sqrt(mu)) or at its iteration cap, so the Newton directions are
inexact and rounding differences grow from step to step. The reference
drifts from itself in the same way: its jitted and eager runs of
test_batched's B = 4 setup end after [13, 14, 11, 12] and [11, 11, 11, 13]
steps, and at B = 1024 their pobj differ by 6e-15, 4e-9 and 1e-6 after
steps 1, 2 and 3, as the port's do from the jitted run.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import ipx_tpu
import ipx_tpu.testgen as tg
import ipx_tpu_torch
from ipx_tpu.ops import spmv as ref_spmv
from ipx_tpu.parallel import batch as ref
from ipx_tpu_torch import backend, kernels
from ipx_tpu_torch.ops import spmv
from ipx_tpu_torch.parallel import batch as port

from lp_fixtures import random_lp
from test_batched import make_batch    # ipx_tpu's BatchedLp: the port
                                        # gets port.as_batched_lp of it

CPU = torch.device("cpu")
RTOL = {"float64": 1e-12, "float32": 1e-5}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rel(got, want, axis=None):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return np.max(np.abs(got - want), axis=axis) / np.maximum(
        np.max(np.abs(want), axis=axis), 1e-300)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _matrix(m, n, seed):
    rng = np.random.default_rng(seed)
    A = sp.random(m, n, density=0.08, random_state=rng, format="csc",
                  data_rvs=rng.standard_normal)
    A.sort_indices()
    return A, rng


# -- K5 / K6 ----------------------------------------------------------------------
@pytest.mark.parametrize("B", [1, 3, 4])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_csr_spmm_matches_apply_csr_batched(dtype, B):
    """K5 against apply_csr_batched, for A U and A' V; 1e-12 relative in
    float64 and 1e-5 in float32 (the two sum each row in another order)."""
    A, rng = _matrix(60, 90, seed=B)
    np_dt = np.dtype(dtype).type
    A_csr = A.tocsr()
    U = rng.standard_normal((A.shape[1], B)).astype(np_dt)
    V = rng.standard_normal((A.shape[0], B)).astype(np_dt)
    for indptr, indices, data, rows, cols, X in (
            (A_csr.indptr, A_csr.indices, A_csr.data, A.shape[0],
             A.shape[1], U),
            (A.indptr, A.indices, A.data, A.shape[1], A.shape[0], V)):
        want = ref_spmv.apply_csr_batched(
            ref_spmv.SpmvOperand(indptr, indices, data, rows, np_dt),
            jnp.asarray(X))
        op = spmv.CsrOperand(indptr, indices, data, cols, CPU,
                             getattr(torch, dtype))
        got = spmv.csr_spmm(op, _t(X))
        assert got.shape == (rows, B) and got.dtype == getattr(torch, dtype)
        assert _rel(got, want) <= RTOL[dtype]


@pytest.mark.parametrize("B", [1, 3, 4])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_normal_apply_batched_matches_reference(dtype, B):
    """K6 against NormalMatrixDevice.apply_batched, and its column dots
    against jnp.sum(V * out, axis=0) of the reference's output; 1e-12
    relative in float64, 1e-5 in float32."""
    A, rng = _matrix(50, 80, seed=10 + B)
    m, n = A.shape
    np_dt = np.dtype(dtype).type
    W = rng.uniform(0.1, 3.0, size=(n + m, B)).astype(np_dt)
    V = rng.standard_normal((m, B)).astype(np_dt)
    want = ref_spmv.NormalMatrixDevice(A, dtype=np_dt).apply_batched(
        jnp.asarray(W), jnp.asarray(V))
    want_dots = np.sum(V.astype(np.float64) * np.asarray(want, np.float64),
                       axis=0)
    nmd = spmv.NormalMatrixDevice(A, CPU, getattr(torch, dtype))
    out, dots = nmd.apply_batched(_t(W), _t(V))
    assert out.shape == (m, B) and dots.shape == (B,)
    assert _rel(out, want) <= RTOL[dtype]
    assert np.all(np.abs(dots.double().numpy() - want_dots)
                  <= RTOL[dtype] * np.abs(want_dots))
    # the structural products of the same class
    U = rng.standard_normal((n, B)).astype(np_dt)
    assert _rel(nmd.apply_batched_struct(_t(U)), A @ U) <= RTOL[dtype]
    assert _rel(nmd.applyT_batched_struct(_t(V)), A.T @ V) <= RTOL[dtype]


# -- K7 ------------------------------------------------------------------------------
def _cr_system(B=4, seed=3):
    """Seeded weights, preconditioner, scaling and right-hand sides of one
    batched normal-equations solve over test_batched's LP."""
    _, blp = make_batch(B=B)
    m, n = blp.A.shape
    rng = np.random.default_rng(seed)
    W = 10.0 ** rng.uniform(-2, 2, size=(n + m, B))
    A2 = blp.A.copy()
    A2.data **= 2
    diag = A2 @ W[:n] + W[n:]
    resscale = 1.0 / np.sqrt(W[n:])
    rhs = rng.standard_normal((m, B))
    return blp, W, diag, resscale, rhs


def _scaled_residual(blp, W, resscale, rhs, Y):
    A = blp.A
    n = A.shape[1]
    res = rhs - (A @ (W[:n] * (A.T @ Y)) + W[n:] * Y)
    return np.max(np.abs(resscale * res), axis=0)


def test_cr_solve_f64_matches_reference():
    """_cr_solve in float64: the trips within 2 and each lane's Y within
    1e-8 of its largest entry (the SpMVs sum in another order, which can
    move a lane's last trip), at a tolerance of 1e-10."""
    blp, W, diag, resscale, rhs = _cr_system()
    tol = 1e-10 * np.max(np.abs(resscale * rhs), axis=0)
    r = ref.BatchedPhase1Solver(blp, cr_dtype="f64")
    Y_r, t_r = r._cr_solve(*(jnp.asarray(x) for x in
                             (W, diag, resscale, rhs, tol)))
    p = port.BatchedPhase1Solver(port.as_batched_lp(blp), cr_dtype="f64",
                                 device="torch_cpu")
    Y_p, t_p = p._cr_solve(*(_t(x) for x in (W, diag, resscale, rhs, tol)))
    assert t_p > 0 and abs(t_p - int(t_r)) <= 2
    assert np.all(_rel(Y_p, Y_r, axis=0) <= 1e-8)
    assert np.all(_scaled_residual(blp, W, resscale, rhs, _np(Y_p)) <= tol)


def test_cr_solve_f32_matches_reference_f32():
    """The mixed path (float32 chunks, float64 correction and finish)
    against the reference's cr_dtype="f32" path, which runs only with the
    jit operands in place, so the test sets them: both meet the float64
    tolerance on every lane and the trips agree within 10% (float32
    rounding moves the chunks)."""
    blp, W, diag, resscale, rhs = _cr_system(seed=4)
    tol = 1e-9 * np.max(np.abs(resscale * rhs), axis=0)
    r = ref.BatchedPhase1Solver(blp, cr_dtype="f32")
    assert r.cr_dtype == "f32"
    r._ops = r._ops_tree
    try:
        Y_r, t_r = r._cr_solve(*(jnp.asarray(x) for x in
                                 (W, diag, resscale, rhs, tol)))
    finally:
        r._ops = None
    p = port.BatchedPhase1Solver(port.as_batched_lp(blp), cr_dtype="f32",
                                 device="torch_cpu")
    Y_p, t_p = p._cr_solve(*(_t(x) for x in (W, diag, resscale, rhs, tol)))
    assert Y_p.dtype == torch.float64
    for Y in (np.asarray(Y_r), _np(Y_p)):
        assert np.all(_scaled_residual(blp, W, resscale, rhs, Y) <= tol)
    assert t_p > 0 and abs(t_p - int(t_r)) <= 0.1 * int(t_r)


def test_batched_cr_freezes_converged_lanes():
    """A lane whose tolerance is met takes no further update: a lane met
    at trip 0 keeps Y = 0 exactly, and a lane that converges early has the
    same Y, bit for bit, whether the loop stops one trip before the last
    lane converges or at it."""
    blp, W, diag, resscale, rhs = _cr_system()
    base = np.max(np.abs(resscale * rhs), axis=0)
    tol = base * np.array([10.0, 1e-2, 1e-6, 1e-10])
    nmd = spmv.NormalMatrixDevice(blp.A, CPU)
    args = (nmd, _t(W), _t(1.0 / diag), _t(resscale), _t(rhs), _t(tol))
    Y, trips = port.batched_cr(*args, 1000)
    Y1, trips1 = port.batched_cr(*args, trips - 1)
    assert trips1 == trips - 1
    assert torch.all(Y[:, 0] == 0) and torch.all(Y1[:, 0] == 0)
    assert torch.equal(Y[:, 1], Y1[:, 1])
    assert not torch.equal(Y[:, 3], Y1[:, 3])
    res = _scaled_residual(blp, W, resscale, rhs, _np(Y))
    assert np.all(res[1:] <= tol[1:])


# -- K8 / K9 ------------------------------------------------------------------------
def _step_state(seed=5, nm=70, B=4, infinite_steps=True):
    rng = np.random.default_rng(seed)
    finl = rng.random(nm) < 0.8
    finu = rng.random(nm) < 0.4
    arrays = {}
    for name, fin in (("XL", finl), ("XU", finu), ("ZL", finl),
                      ("ZU", finu)):
        x = rng.uniform(1e-3, 10.0, size=(nm, B))
        if name.startswith("X"):
            x[~fin] = np.inf     # an infinite bound holds inf, as in the IPM
        else:
            x[~fin] = 0.0
        arrays[name] = x
        arrays["D" + name] = rng.standard_normal((nm, B)) * 5.0
    if infinite_steps:    # ratios of +-0
        arrays["DXL"][:3] = -np.inf
    return arrays, finl, finu


def test_step_batch_bit_for_bit():
    """K8 (maxp, maxd) equal the reference's _step_batch minima exactly;
    muaff agrees to 1e-14 relative (its column sums run in another
    order)."""
    a, finl, finu = _step_state()
    fl, fu = jnp.asarray(finl)[:, None], jnp.asarray(finu)[:, None]
    J = {k: jnp.asarray(v) for k, v in a.items()}
    want_p = jnp.minimum(ref._step_batch(jax, J["XL"], J["DXL"], fl),
                         ref._step_batch(jax, J["XU"], J["DXU"], fu))
    want_d = jnp.minimum(ref._step_batch(jax, J["ZL"], J["DZL"], fl),
                         ref._step_batch(jax, J["ZU"], J["DZU"], fu))
    T = {k: _t(v) for k, v in a.items()}
    order = ("XL", "XU", "ZL", "ZU", "DXL", "DXU", "DZL", "DZU")
    maxp, maxd = port.step_batch(*(T[k] for k in order), _t(finl),
                                 _t(finu))
    assert np.array_equal(_np(maxp), np.asarray(want_p))
    assert np.array_equal(_np(maxd), np.asarray(want_d))
    assert np.any(_np(maxp) < 1.0) and np.any(_np(maxd) < 1.0)

    # muaff, on finite directions as the IPM's are
    a, finl, finu = _step_state(infinite_steps=False)
    fl, fu = jnp.asarray(finl)[:, None], jnp.asarray(finu)[:, None]
    J = {k: jnp.asarray(v) for k, v in a.items()}
    T = {k: _t(v) for k, v in a.items()}
    maxp, maxd = port.step_batch(*(T[k] for k in order), _t(finl),
                                 _t(finu))
    want_p, want_d = jnp.asarray(_np(maxp)), jnp.asarray(_np(maxd))
    num_fin = int(finl.sum() + finu.sum())
    want_mu = (jnp.sum(jnp.where(fl, (J["XL"] + want_p * J["DXL"])
                                 * (J["ZL"] + want_d * J["DZL"]), 0.0),
                       axis=0)
               + jnp.sum(jnp.where(fu, (J["XU"] + want_p * J["DXU"])
                                   * (J["ZU"] + want_d * J["DZU"]), 0.0),
                         axis=0)) / max(num_fin, 1)
    got_mu = port.muaff(*(T[k] for k in order), _t(finl), _t(finu), maxp,
                        maxd, num_fin)
    assert _rel(got_mu, want_mu) <= 1e-14


def test_ipm_update_bit_for_bit():
    """K9 equals the reference's masked update (batch.py:534-545) exactly,
    a done lane included, in place."""
    a, finl, finu = _step_state(seed=6)
    rng = np.random.default_rng(7)
    nm, B = a["XL"].shape
    m = 30
    X, DX = rng.standard_normal((nm, B)), rng.standard_normal((nm, B))
    Y, DY = rng.standard_normal((m, B)), rng.standard_normal((m, B))
    # some steps cross the barrier floor
    a["DXL"][5] = -a["XL"][5] / 0.5
    alphap, alphad = rng.uniform(0.1, 1.0, B), rng.uniform(0.1, 1.0, B)
    done = np.array([False, True, False, False])
    upd = ~done
    fl, fu = finl[:, None], finu[:, None]
    BMIN = 1e-30
    want = dict(
        X=jnp.where(upd, X + alphap * DX, X),
        XL=jnp.where(upd & fl, jnp.maximum(a["XL"] + alphap * a["DXL"],
                                           BMIN), a["XL"]),
        XU=jnp.where(upd & fu, jnp.maximum(a["XU"] + alphap * a["DXU"],
                                           BMIN), a["XU"]),
        Y=jnp.where(upd, Y + alphad * DY, Y),
        ZL=jnp.where(upd & fl, jnp.maximum(a["ZL"] + alphad * a["DZL"],
                                           BMIN), a["ZL"]),
        ZU=jnp.where(upd & fu, jnp.maximum(a["ZU"] + alphad * a["DZU"],
                                           BMIN), a["ZU"]))
    got = dict(X=_t(X.copy()), XL=_t(a["XL"].copy()), XU=_t(a["XU"].copy()),
               Y=_t(Y.copy()), ZL=_t(a["ZL"].copy()), ZU=_t(a["ZU"].copy()))
    port.ipm_update(got["X"], got["XL"], got["XU"], got["Y"], got["ZL"],
                    got["ZU"], _t(DX), _t(a["DXL"]), _t(a["DXU"]), _t(DY),
                    _t(a["DZL"]), _t(a["DZU"]), _t(alphap), _t(alphad),
                    _t(done), _t(finl), _t(finu))
    for k, v in want.items():
        assert np.array_equal(_np(got[k]), np.asarray(v)), k
    assert np.any(_np(got["XL"]) == BMIN)


# -- the stage -----------------------------------------------------------------------
def _state_to_torch(S):
    return {k: (torch.from_numpy(np.array(v)) if np.ndim(v) else int(v))
            for k, v in S.items()}


def _close(got, want, rtol):
    """Equal infinities, finite entries within rtol of the largest."""
    got, want = _np(got), np.asarray(want)
    fin = np.isfinite(want)
    assert np.array_equal(fin, np.isfinite(got))
    assert np.array_equal(got[~fin], want[~fin])
    return _rel(got[fin], want[fin]) <= rtol


def test_starting_point_and_one_step():
    """The starting point and one _ipm_step from the same state agree
    within 1e-8 of each array's largest entry (measured: 1e-15)."""
    _, blp = make_batch(B=4)
    r = ref.BatchedPhase1Solver(blp, maxiter=60)
    p = port.BatchedPhase1Solver(port.as_batched_lp(blp), maxiter=60,
                                 device="torch_cpu")
    S_r = r._start_fn(r._ops_tree, 0)
    S_p = p._starting_point()
    assert S_p["cr"] == int(S_r["cr"])
    for k in ("X", "XL", "XU", "Y", "ZL", "ZU"):
        assert _close(S_p[k], S_r[k], 1e-8), k
    S_np = {k: np.asarray(v) for k, v in S_r.items()}
    out_r = r._step_fn(r._ops_tree, S_r)
    out_p = p._ipm_step(_state_to_torch(S_np))
    assert out_p["cr"] == int(out_r["cr"])
    for k in ("X", "XL", "XU", "Y", "ZL", "ZU", "mu"):
        assert _close(out_p[k], out_r[k], 1e-8), k
    assert np.array_equal(_np(out_p["done"]), np.asarray(out_r["done"]))
    assert np.array_equal(_np(out_p["iters"]), np.asarray(out_r["iters"]))


def test_batched_matches_reference():
    """test_batched_matches_sequential's setup: every lane converges, its
    pobj within 1e-8 of the reference's, and its step count within 3
    (see the module docstring: the reference's own jitted and eager runs
    differ by up to 3)."""
    _, blp = make_batch(B=4)
    want = ref.BatchedPhase1Solver(blp, maxiter=60).solve()
    got = port.BatchedPhase1Solver(port.as_batched_lp(blp), maxiter=60,
                                   device="torch_cpu").solve()
    assert np.all(got["done"])
    assert np.all(np.abs(got["pobj"] - want["pobj"])
                  <= 1e-8 * np.abs(want["pobj"]))
    assert np.all(np.abs(got["iters"] - want["iters"]) <= 3)


def test_handoff_stops_at_cr_saturation():
    """test_batch2.py's handoff test on the port: with a starved CR budget
    every step saturates, so handoff="auto" stops after about 2 steps while
    the default runs to maxiter."""
    data = tg.transportation(60, 90, 0.05, seed=2)
    m, n = data["num_constr"], data["num_var"]
    A = sp.csc_matrix((data["Ax"], data["Ai"], data["Ap"]), shape=(m, n))
    ct = np.asarray(list(data["constr_type"]))
    lb = np.concatenate([data["lb"], np.where(ct == ">", -np.inf, 0.0)])
    ub = np.concatenate([data["ub"], np.where(ct == "<", np.inf, 0.0)])
    rng = np.random.default_rng(1)
    B = 4
    b_batch = data["rhs"][None, :] * rng.uniform(0.97, 1.03, size=(B, m))
    c = np.zeros((B, n + m))
    c[:, :n] = data["obj"]
    blp = port.BatchedLp(A=A, b=b_batch, c=c, lb=lb, ub=ub)
    kw = dict(feasibility_tol=1e-10, optimality_tol=1e-12, maxiter=8,
              cr_maxiter=4, cr64_maxiter=2, device="torch_cpu")
    auto = port.BatchedPhase1Solver(blp, **kw).solve(handoff="auto")
    full = port.BatchedPhase1Solver(blp, **kw).solve()
    assert int(auto["iters"].max()) <= 3
    assert int(full["iters"].max()) == 8


def test_batched_scenario_solver_matches_reference():
    """Batched phase 1 plus the port's warm-started finishes, on the
    device path with the plain kernels: the same statuses as ipx_tpu's
    BatchedScenarioSolver and pobjval within 1e-7."""
    a = random_lp(25, 35, density=0.3, seed=11)
    rng = np.random.default_rng(12)
    b_batch = a["rhs"][None, :] * rng.uniform(0.9, 1.1, size=(3, 25))
    want = ref.BatchedScenarioSolver(
        a, b_batch, parameters=ipx_tpu.Parameters(display=0, device="cpu")
    ).solve()
    got = port.BatchedScenarioSolver(
        a, b_batch,
        parameters=ipx_tpu_torch.Parameters(display=0, device="torch_cpu")
    ).solve()
    assert len(got) == len(want) == 3
    for k, ((st, info, _), (st_r, info_r, _)) in enumerate(zip(got, want)):
        assert st == st_r, k
        assert info.pobjval == pytest.approx(info_r.pobjval, rel=1e-7,
                                             abs=1e-7), k


def test_phase1_1024_scenarios():
    """B = 1024 scenarios of test_batched's feasibility-preserving
    transportation batch through phase 1 alone, at the pipeline's
    tolerance 1e-4: every lane converges within 15 steps, as in the
    reference, with a finite state and mu below its starting value, and
    pobj within 2e-4 relative of the reference's (both meet the 1e-4
    optimality tolerance; see the module docstring for the drift)."""
    data = tg.transportation(20, 30, 0.2, seed=7)
    m = data["num_constr"]
    rng = np.random.default_rng(1)
    B = 1024
    fac = np.empty((B, m))
    fac[:, :20] = rng.uniform(1.0, 1.1, size=(B, 20))
    fac[:, 20:] = rng.uniform(0.9, 1.0, size=(B, m - 20))
    b_batch = data["rhs"][None, :] * fac
    sv = port.BatchedScenarioSolver(data, b_batch, phase1_maxiter=15)
    kw = dict(feasibility_tol=sv.phase1_tol, optimality_tol=sv.phase1_tol,
              maxiter=15)
    p = port.BatchedPhase1Solver(sv.blp, device="torch_cpu", **kw)
    mu0 = _np(p._mu_of(p._starting_point()))
    got = p.solve()
    want = ref.BatchedPhase1Solver(sv.blp, **kw).solve()
    assert got["X"].shape == (data["num_var"] + m, B)
    assert np.all(got["done"]) and np.all(want["done"])
    for k in ("X", "Y", "ZL", "ZU", "mu", "pobj"):
        assert np.all(np.isfinite(got[k])), k
    assert np.all(_np(p._mu_of(_state_to_torch(got))) < mu0)
    assert np.all(np.abs(got["pobj"] - want["pobj"])
                  <= 2e-4 * np.abs(want["pobj"]))


# -- the device contract -------------------------------------------------------------
def test_batched_device_choice(monkeypatch):
    """"cuda" raises without a card, "cpu" and "torch_cpu" are the plain
    versions on the CPU, "auto" is the CPU without a card; cr_dtype "auto"
    is float64 there; phase2_polish=True is accepted, "auto" is off."""
    blp = port.as_batched_lp(make_batch(B=2)[1])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        port.BatchedPhase1Solver(blp, device="cuda")
    for device in ("auto", "cpu", "torch_cpu"):
        p = port.BatchedPhase1Solver(blp, device=device)
        assert p.device == CPU and p.cr_dtype == "f64"
        assert p.bT.device == CPU and p.nmd32 is None
    assert port.BatchedPhase1Solver(blp, cr_dtype="f32",
                                    device="torch_cpu").nmd32 is not None
    with pytest.raises(ValueError, match="unknown device"):
        backend.resolve_batched("tpu")
    with pytest.raises(ValueError, match="cr_dtype"):
        port.BatchedPhase1Solver(blp, cr_dtype="bf16", device="torch_cpu")
    a = random_lp(10, 12, density=0.3, seed=1)
    for polish, want in ((True, True), ("auto", False), (False, False)):
        sv = port.BatchedScenarioSolver(a, a["rhs"][None, :],
                                        phase2_polish=polish)
        assert sv.phase2_polish is want


def test_batched_wrappers_refuse_a_device_they_cannot_run_on():
    """A tensor on neither the CPU nor a card makes a wrapper raise; no
    kernel is counted."""
    A, _ = _matrix(8, 5, seed=3)
    csr = A.tocsr()
    op = spmv.CsrOperand(csr.indptr, csr.indices, csr.data, 5, CPU,
                         torch.float64)
    U = torch.zeros((5, 3), dtype=torch.float64, device="meta")
    X = torch.zeros((5, 3), dtype=torch.float64, device="meta")
    fin = torch.ones(5, dtype=torch.bool, device="meta")
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        spmv.csr_spmm(op, U)
    with pytest.raises(ValueError, match="CUDA"):
        port.step_batch(*([X] * 8), fin, fin)
    assert kernels.LAUNCHES == before


def test_batch_module_imports_no_jax():
    code = (
        "import sys\n"
        "sys.path.insert(0, 'tests')\n"
        "import numpy as np\n"
        "from ipx_tpu_torch.parallel.batch import BatchedScenarioSolver\n"
        "import ipx_tpu_torch.parallel.batch2\n"
        "from lp_fixtures import random_lp\n"
        "a = random_lp(12, 16, density=0.3, seed=2)\n"
        "b = a['rhs'][None, :] * np.array([[1.0], [1.05]])\n"
        "from ipx_tpu_torch import Parameters\n"
        "for polish in (False, True):\n"
        "    sv = BatchedScenarioSolver(a, b, parameters=Parameters(\n"
        "        display=0, device='torch_cpu'), phase2_polish=polish)\n"
        "    res = sv.solve()\n"
        "    assert [r[0] for r in res] == [1000, 1000], res\n"
        "assert sv.polish is not None\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


def test_plain_solver_is_the_cpu_path():
    """PlainBatchedPhase1Solver, the reference of the card tests, computes
    on the CPU exactly what BatchedPhase1Solver does there."""
    blp = port.as_batched_lp(make_batch(B=2)[1])
    got = port.PlainBatchedPhase1Solver(blp, maxiter=5, device="cpu").solve()
    want = port.BatchedPhase1Solver(blp, maxiter=5, device="cpu").solve()
    for k in ("X", "Y", "ZL", "ZU", "iters", "pobj"):
        assert np.array_equal(got[k], want[k]), k
    assert got["cr"] == want["cr"]
