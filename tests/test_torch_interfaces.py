"""The port's C-API layer and MPS reader (ipx_tpu_torch/capi.py, mps.py)
against ipx_tpu's, on the inputs of tests/test_interfaces.py: the same
statuses and objval to 1e-8 relative (the port on "torch_cpu", the device
path with the plain kernels; the reference on "cpu"), and equal arrays from
read_mps."""
import numpy as np
import pytest

import ipx_tpu
import ipx_tpu_torch
from ipx_tpu import capi as ref_capi
from ipx_tpu.mps import read_mps as ref_read_mps
from ipx_tpu_torch import capi as port_capi
from ipx_tpu_torch.mps import read_mps as port_read_mps

from lp_fixtures import afiro, AFIRO_OBJECTIVE
from test_interfaces import AFIRO_MPS, RANGES_MPS

PACKAGES = [pytest.param(ref_capi, "cpu", id="ipx_tpu"),
            pytest.param(port_capi, "torch_cpu", id="ipx_tpu_torch")]


def _capi_solve(capi, device):
    """test_capi_roundtrip's calls; returns (status, objval, the lengths
    of the basis arrays, the KKT matrix's shape, status after
    clear_model)."""
    h = capi.ipx_new()
    try:
        p = capi.ipx_get_parameters(h)
        p.display = 0
        p.device = device
        capi.ipx_set_parameters(h, p)
        a = afiro().arrays()
        assert capi.ipx_load_model(h, a["num_var"], a["obj"], a["lb"],
                                   a["ub"], a["num_constr"], a["Ap"],
                                   a["Ai"], a["Ax"], a["rhs"],
                                   a["constr_type"]) == 0
        status = capi.ipx_solve(h)
        info = capi.ipx_get_info(h)
        assert capi.ipx_get_interior_solution(h) is not None
        assert capi.ipx_get_basic_solution(h) is not None
        assert capi.ipx_get_iterate(h) is not None
        cbasis, vbasis = capi.ipx_get_basis(h)
        AI, _ = capi.ipx_get_kktmatrix(h)
        capi.ipx_clear_model(h)
        return (status, info.objval, (len(cbasis), len(vbasis)), AI.shape,
                capi.ipx_solve(h))
    finally:
        capi.ipx_free(h)


def test_capi_roundtrip_matches_reference():
    """afiro through both C APIs: status 1000 in both, objval within 1e-8
    relative and of afiro's optimum, basis arrays of the same lengths (the
    vertex is degenerate, so the two paths may end at different bases of
    it), and NO_MODEL after clear_model."""
    want = _capi_solve(ref_capi, "cpu")
    got = _capi_solve(port_capi, "torch_cpu")
    assert got[0] == want[0] == int(ipx_tpu_torch.Status.SOLVED)
    assert got[1] == pytest.approx(want[1], rel=1e-8)
    assert got[1] == pytest.approx(AFIRO_OBJECTIVE, abs=1e-6)
    assert got[2] == want[2] == (9, 12)
    assert got[3] == want[3] == (9, 21)
    assert got[4] == want[4] == int(ipx_tpu_torch.Status.NO_MODEL)


def test_capi_version_matches_reference():
    assert port_capi.ipx_version() == ref_capi.ipx_version()
    assert (port_capi.ipx_version_major(), port_capi.ipx_version_minor(),
            port_capi.ipx_version_patch()) == (
        ref_capi.ipx_version_major(), ref_capi.ipx_version_minor(),
        ref_capi.ipx_version_patch())


def test_capi_defaults_to_the_card():
    """A new port solver asks for the card, as Parameters() does."""
    h = port_capi.ipx_new()
    try:
        assert port_capi.ipx_get_parameters(h).device == "cuda"
        assert isinstance(port_capi.ipx_default_parameters(),
                          ipx_tpu_torch.Parameters)
    finally:
        port_capi.ipx_free(h)


@pytest.mark.parametrize("capi, device", PACKAGES)
def test_capi_parameter_file(tmp_path, capi, device):
    """test_capi_parameter_file through each package, and a file written by
    one package read by the other."""
    h = capi.ipx_new()
    try:
        path = str(tmp_path / "p.txt")
        p = capi.ipx_get_parameters(h)
        p.ipm_maxiter = 55
        p.device = device
        capi.ipx_set_parameters(h, p)
        assert capi.ipx_write_parameters(h, path) == 0
        for other in (ref_capi, port_capi):
            h2 = other.ipx_new()
            try:
                assert other.ipx_read_parameters(h2, path) == 0
                q = other.ipx_get_parameters(h2)
                assert q.ipm_maxiter == 55 and q.device == device
            finally:
                other.ipx_free(h2)
    finally:
        capi.ipx_free(h)


@pytest.mark.parametrize("text, name", [(AFIRO_MPS, "TESTLP"),
                                        (RANGES_MPS, "RANGETEST")],
                         ids=["afiro_mps", "ranges_mps"])
def test_read_mps_matches_reference(tmp_path, text, name):
    """Both readers give equal arrays, and both solvers the same status and
    objval to 1e-8 relative."""
    path = str(tmp_path / "lp.mps")
    with open(path, "w") as f:
        f.write(text)
    want, got = ref_read_mps(path), port_read_mps(path)
    assert got.name == want.name == name
    for k in ("num_var", "num_constr", "constr_type", "maximize", "c0"):
        assert getattr(got, k) == getattr(want, k), k
    for k in ("obj", "lb", "ub", "Ap", "Ai", "Ax", "rhs"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    results = []
    for pkg, data, device in ((ipx_tpu, want, "cpu"),
                              (ipx_tpu_torch, got, "torch_cpu")):
        s = pkg.LpSolver(pkg.Parameters(display=0, device=device))
        assert data.load_into(s) == 0
        results.append((s.solve(), s.get_info().objval))
    (st_r, obj_r), (st, obj) = results
    assert st == st_r == int(ipx_tpu_torch.Status.SOLVED)
    assert obj == pytest.approx(obj_r, rel=1e-8, abs=1e-8)
