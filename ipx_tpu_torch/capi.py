"""Flat C-API-style interface.

Function-for-function counterpart of the reference C API (reference:
include/ipx_c.h:13-62 and src/ipx_c.cc): every LpSolver method is reachable
through a flat function set operating on solver handles. This is the
stable-ABI surface bindings build against (ipx_tpu's equivalents of the
Julia/MATLAB bindings use it).

The port's copy of ipx_tpu/capi.py, over the port's LpSolver, Parameters,
Info and version. A new solver's parameters are Parameters(), so it solves
on the card ("cuda") unless ipx_set_parameters names another device. The
Julia and MATLAB shims bindings/julia/IpxTpuTorch.jl and
bindings/matlab/ipx_tpu_torch_solve.m load this module; IpxTpu.jl and
ipx_tpu_solve.m load ipx_tpu.capi.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .info import Info
from .lp_solver import LpSolver
from .parameters import Parameters
from .version import VERSION_MAJOR, VERSION_MINOR, VERSION_PATCH

_handles: Dict[int, LpSolver] = {}
_next_handle = [1]


def ipx_version_major() -> int:
    return VERSION_MAJOR


def ipx_version_minor() -> int:
    return VERSION_MINOR


def ipx_version_patch() -> int:
    return VERSION_PATCH


def ipx_version() -> str:
    """Semver string (reference: include/ipx_version.h)."""
    return f"{VERSION_MAJOR}.{VERSION_MINOR}.{VERSION_PATCH}"


def ipx_default_parameters() -> Parameters:
    return Parameters()


def ipx_new() -> int:
    """Allocates a new solver; returns an opaque handle."""
    h = _next_handle[0]
    _next_handle[0] += 1
    _handles[h] = LpSolver()
    return h


def ipx_free(handle: int) -> None:
    _handles.pop(handle, None)


def _solver(handle: int) -> LpSolver:
    return _handles[handle]


def ipx_load_model(handle, num_var, obj, lb, ub, num_constr, Ap, Ai, Ax,
                   rhs, constr_type) -> int:
    return _solver(handle).load_model(num_var, obj, lb, ub, num_constr,
                                      Ap, Ai, Ax, rhs, constr_type)


def ipx_load_ipm_starting_point(handle, x, xl, xu, slack, y, zl, zu) -> int:
    return _solver(handle).load_ipm_starting_point(x, xl, xu, slack, y,
                                                   zl, zu)


def ipx_solve(handle) -> int:
    return _solver(handle).solve()


def ipx_get_info(handle) -> Info:
    return _solver(handle).get_info()


def ipx_get_interior_solution(handle):
    """Returns the InteriorSolution or None."""
    return _solver(handle).get_interior_solution()


def ipx_get_basic_solution(handle):
    return _solver(handle).get_basic_solution()


def ipx_get_parameters(handle) -> Parameters:
    return _solver(handle).get_parameters()


def ipx_set_parameters(handle, parameters: Parameters) -> None:
    _solver(handle).set_parameters(parameters)


def ipx_read_parameters(handle, filename) -> int:
    try:
        p = _solver(handle).get_parameters()
        p.update_from_file(filename)
        _solver(handle).set_parameters(p)
        return 0
    except Exception:
        return -1


def ipx_write_parameters(handle, filename) -> int:
    try:
        _solver(handle).get_parameters().write(filename)
        return 0
    except Exception:
        return -1


def ipx_clear_model(handle) -> None:
    _solver(handle).clear_model()


def ipx_get_iterate(handle):
    """Returns (x, y, zl, zu, xl, xu) or None (debug accessor)."""
    return _solver(handle).get_iterate()


def ipx_get_basis(handle):
    """Returns (cbasis, vbasis) or None."""
    return _solver(handle).get_basis()


def ipx_get_kktmatrix(handle):
    """Returns (AI, g) or None."""
    return _solver(handle).get_kkt_matrix()


def ipx_symbolic_invert(handle):
    """Returns (rowcounts, colcounts) or None."""
    return _solver(handle).symbolic_invert()


def ipx_save_checkpoint(handle, filename) -> int:
    """Writes the last pre-postsolve IPM state to an .npz checkpoint
    (capability beyond the reference C API; see ipx_tpu/checkpoint.py)."""
    return _solver(handle).save_checkpoint(filename)


def ipx_load_checkpoint(handle, filename) -> int:
    """Arms the next ipx_solve to resume from an .npz checkpoint."""
    return _solver(handle).load_checkpoint(filename)
