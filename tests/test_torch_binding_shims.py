"""Machine-check of the Julia/MATLAB shims over the port's C API
(bindings/julia/IpxTpuTorch.jl, bindings/matlab/ipx_tpu_torch_solve.m),
the counterpart of tests/test_binding_shims.py for ipx_tpu_torch.

Neither Julia nor MATLAB exists here, so the shims' sources are parsed:
every `capi.*` entry point and every parameter they name must exist on
ipx_tpu_torch.capi and ipx_tpu_torch.parameters.Parameters, the solution
fields they expose must exist on the port's solution objects, their
checkpoint pair must round-trip, and each must load ipx_tpu_torch.capi and
never ipx_tpu.capi. The solves run on "torch_cpu", the device path with the
kernels' plain versions."""
import os
import re

import numpy as np
import pytest

import ipx_tpu_torch.capi as capi
from ipx_tpu_torch.parameters import Parameters
from ipx_tpu_torch.status import Status

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JULIA = os.path.join(REPO, "bindings", "julia", "IpxTpuTorch.jl")
MATLAB = os.path.join(REPO, "bindings", "matlab", "ipx_tpu_torch_solve.m")
SHIMS = [pytest.param(JULIA, id="julia"), pytest.param(MATLAB, id="matlab")]


def _source(path):
    with open(path) as f:
        return f.read()


@pytest.mark.parametrize("path", SHIMS)
def test_every_capi_entry_the_shim_calls_exists(path):
    calls = set(re.findall(r"capi\.(ipx_\w+)", _source(path)))
    assert calls, "shim references no capi entry points"
    for fn in sorted(calls):
        assert callable(getattr(capi, fn, None)), \
            f"{os.path.basename(path)} calls capi.{fn}, which the port lacks"


@pytest.mark.parametrize("path", SHIMS)
def test_shim_parameter_examples_are_real_parameters(path):
    """Every parameter the shim's documentation or code names
    (`crossover=0`, `params.ipm_maxiter`, `device`, `*_tol`) exists on the
    port's Parameters; `device` is among them."""
    names = set(re.findall(
        r"[`.](crossover|ipm_maxiter|device|[a-z_]+_tol)\b", _source(path)))
    assert "device" in names
    p = Parameters()
    for name in names:
        assert hasattr(p, name), f"shim mentions unknown parameter {name}"


@pytest.mark.parametrize("path", SHIMS)
def test_shim_loads_the_port(path):
    src = _source(path)
    assert re.search(r"""['"]ipx_tpu_torch\.capi['"]""", src)
    assert not re.search(r"ipx_tpu\.capi", src)


@pytest.mark.parametrize("path", SHIMS)
def test_shim_documents_the_default_device(path):
    """The shims say that `device` defaults to the card and that a solve
    there without one ends at 1004, and show "cpu" for such a machine: the
    port's default and status."""
    src = _source(path)
    assert Parameters().device == "cuda"
    assert int(Status.INTERNAL_ERROR) == 1004
    assert re.search(r"""defaults\s+to\s+['"]cuda['"]""", src)
    assert "1004" in src
    assert re.search(r"""device\s*=\s*['"]cpu['"]""", src)


def _one_variable_lp():
    """min x s.t. x + s = 1, 0 <= x <= 1, on "torch_cpu"; the handle."""
    h = capi.ipx_new()
    p = capi.ipx_get_parameters(h)
    p.display = 0
    p.device = "torch_cpu"
    capi.ipx_set_parameters(h, p)
    rc = capi.ipx_load_model(
        h, 1, np.array([1.0]), np.array([0.0]), np.array([1.0]),
        1, np.array([0, 1]), np.array([0]), np.array([1.0]),
        np.array([1.0]), "<")
    assert rc == 0
    return h


def test_shim_solution_fields_exist():
    """The solution fields the shims expose (x, xl, xu, slack, y, zl, zu /
    x, slack, y, z, vbasis, cbasis) exist on the port's solution
    objects."""
    h = _one_variable_lp()
    try:
        assert capi.ipx_solve(h) == 1000
        interior = capi.ipx_get_interior_solution(h)
        basic = capi.ipx_get_basic_solution(h)
        for f in ("x", "xl", "xu", "slack", "y", "zl", "zu"):
            assert hasattr(interior, f), f"interior solution lacks {f}"
        for f in ("x", "slack", "y", "z", "vbasis", "cbasis"):
            assert hasattr(basic, f), f"basic solution lacks {f}"
    finally:
        capi.ipx_free(h)


def test_checkpoint_entries_used_by_shims_roundtrip(tmp_path):
    """Both shims expose resume_from/checkpoint_to through
    ipx_load_checkpoint / ipx_save_checkpoint: the pair round-trips, and
    the resumed solve ends at the same status and objective."""
    path = str(tmp_path / "ck.npz")
    h = _one_variable_lp()
    try:
        assert capi.ipx_solve(h) == 1000
        objval = capi.ipx_get_info(h).objval
        capi.ipx_save_checkpoint(h, path)
        assert os.path.exists(path)
        assert capi.ipx_load_checkpoint(h, path) == 0
        assert capi.ipx_solve(h) == 1000
        assert capi.ipx_get_info(h).objval == pytest.approx(objval,
                                                            abs=1e-12)
    finally:
        capi.ipx_free(h)
