"""K3: the port's phase-1 device CR (ipx_tpu_torch.ops.device_cr, plain
version on the CPU) against ipx_tpu.ops.device_cr on jax's CPU backend,
on the same seeded LP and weights.

Tolerances: in float64 the iteration counts agree within 2 and the
solutions within 1e-8 relative (the SpMVs sum in another order, which moves
the last CR iterations); with mixed precision both meet the f64 residual
tolerance and the total iteration counts agree within 10%, because float32
rounding moves the refinement passes.

Each package gets its own presolved Model of the same LP, built from the
same numpy arrays.
"""
import importlib

import numpy as np
import pytest
import torch

from ipx_tpu.ops import device_cr as ref
from ipx_tpu_torch.ops import device_cr as port
from ipx_tpu_torch.sparse import normal_diag
from ipx_tpu_torch.status import Errflag

from lp_fixtures import random_lp

CPU = torch.device("cpu")


def presolved_model(pkg: str, a: dict):
    """The presolved Model of LP data `a` (random_lp's dict), built by the
    host modules of package `pkg` ("ipx_tpu" or "ipx_tpu_torch")."""
    mod = {name: importlib.import_module(f"{pkg}.{name}")
           for name in ("control", "model", "presolve", "user_model")}
    um = mod["user_model"].UserModel()
    assert um.load(a["num_constr"], a["num_var"], a["Ap"], a["Ai"], a["Ax"],
                   a["rhs"], a["constr_type"], a["obj"], a["lb"],
                   a["ub"]) == 0
    md = mod["model"].Model()
    ctrl = mod["control"].Control()
    ctrl.parameters.display = 0
    mod["presolve"].Presolver(um, md).presolve_model(ctrl)
    return md


def _system(m=50, n=70, seed=5):
    """(the reference's model, the port's, W, diag, resscale, rhs)."""
    a = random_lp(m, n, density=0.2, seed=seed)
    md_ref = presolved_model("ipx_tpu", a)
    md = presolved_model("ipx_tpu_torch", a)
    assert (md.A != md_ref.A).nnz == 0
    m, n = md.num_rows, md.num_cols
    rng = np.random.default_rng(0)
    W = rng.uniform(0.5, 2.0, size=n + m)
    diag = normal_diag(md.A, W)
    resscale = 1.0 / np.sqrt(W[n:])
    rhs = rng.standard_normal(m)
    return md_ref, md, W, diag, resscale, rhs


def _scaled_residual(md, W, resscale, rhs, y):
    n = md.num_cols
    res = rhs - (md.A @ (W[:n] * (y @ md.A_csr)) + W[n:] * y)
    return np.max(np.abs(resscale * res))


def test_device_cr_direct():
    md_ref, md, W, diag, resscale, rhs = _system()
    y_r, it_r, err_r, _, _ = ref.DeviceNormalCR(
        md_ref, W, diag, resscale).solve(rhs, 1e-10, -1)
    y, it, err, _, _ = port.DeviceNormalCR(
        md, W, diag, resscale, CPU).solve(rhs, 1e-10, -1)
    assert err == err_r == 0
    assert it > 0 and abs(it - it_r) <= 2
    assert _scaled_residual(md, W, resscale, rhs, y) <= 1e-9
    assert np.max(np.abs(y - y_r)) <= 1e-8 * np.max(np.abs(y_r))


def test_mixed_precision_cr_reaches_f64_tolerance():
    md_ref, md, W, diag, resscale, rhs = _system()
    _, it_r, err_r, _, _ = ref.MixedPrecisionDeviceCR(
        md_ref, W, diag, resscale).solve(rhs, 1e-11, -1)
    y, it, err, _, _ = port.MixedPrecisionDeviceCR(
        md, W, diag, resscale, device=CPU).solve(rhs, 1e-11, -1)
    assert err == err_r == 0
    assert _scaled_residual(md, W, resscale, rhs, y) <= 1e-11
    assert it > 0 and abs(it - it_r) <= 0.1 * it_r


def test_mixed_precision_cr_in_full_solve():
    """device="torch_cpu" routes phase 1 through the port's mixed-precision
    solver and reaches the same optimum as ipx_tpu on device="tpu"."""
    import ipx_tpu
    import ipx_tpu_torch
    from ipx_tpu_torch.ops.device_cr import MixedPrecisionDeviceCR

    a = random_lp(80, 120, density=0.15, seed=9)
    infos = {}
    calls = []
    orig = MixedPrecisionDeviceCR.solve

    def counted(self, *args):
        out = orig(self, *args)
        calls.append(out[1])
        return out

    for pkg, device in ((ipx_tpu, "tpu"), (ipx_tpu_torch, "torch_cpu")):
        p = pkg.Parameters()
        p.display = 0
        p.device = device
        s = pkg.LpSolver(p)
        assert s.load_model(a["num_var"], a["obj"], a["lb"], a["ub"],
                            a["num_constr"], a["Ap"], a["Ai"], a["Ax"],
                            a["rhs"], a["constr_type"]) == 0
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(MixedPrecisionDeviceCR, "solve", counted)
            s.solve()
        infos[device] = s.get_info()
    assert infos["torch_cpu"].status == infos["tpu"].status == 1000
    assert infos["torch_cpu"].objval == pytest.approx(infos["tpu"].objval,
                                                      rel=1e-8)
    assert calls and sum(calls) > 0


@pytest.mark.parametrize("case", ["iter_limit", "not_posdef",
                                  "precond_not_posdef", "converged_first"])
def test_error_priority_and_keep_on_stop(case):
    """Same error code and the same kept state as the reference when the
    loop stops before its update."""
    md_ref, md, W, diag, resscale, rhs = _system()
    tol, maxiter = 1e-14, -1
    if case == "iter_limit":
        maxiter = 3
    elif case == "not_posdef":
        # negative definite C and a negative preconditioner: both cdot and
        # pdot are negative, and "not posdef" outranks "precond not posdef"
        W = -W
        diag = -diag
        resscale = np.ones_like(resscale)
    elif case == "precond_not_posdef":
        diag = -diag
    else:
        # a zero rhs has converged at trip 0, which outranks the limit
        rhs = np.zeros_like(rhs)
        maxiter = 0
    y_r, it_r, err_r, _, _ = ref.DeviceNormalCR(
        md_ref, W, diag, resscale).solve(rhs, tol, maxiter)
    y, it, err, _, _ = port.DeviceNormalCR(
        md, W, diag, resscale, CPU).solve(rhs, tol, maxiter)
    want = {"iter_limit": Errflag.CR_ITER_LIMIT,
            "not_posdef": Errflag.CR_MATRIX_NOT_POSDEF,
            "precond_not_posdef": Errflag.CR_PRECOND_NOT_POSDEF,
            "converged_first": 0}[case]
    assert err == err_r == int(want)
    assert it == it_r
    np.testing.assert_allclose(y, y_r, rtol=1e-12, atol=1e-300)
