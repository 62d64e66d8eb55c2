"""ctypes bindings of the fused IPM vector kernels in ipxlu.cc.

Single-pass C versions of the per-iteration masked-vector chains of the
Newton solve / step-size / iterate-update path (reference:
src/ipm.cc:319-339,438-531,551-631; src/iterate.cc:96-139). Callers fall
back to the numpy formulation when the native library is unavailable
(`available()` returns False).

The port's copy of ipx_tpu/native/veckernels.py.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

_lib = None
_failed = False


def _get() -> Optional[ctypes.CDLL]:
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    try:
        from ..basis.lu import _load_lib
        lib = _load_lib()
        I = ctypes.c_int64
        D = ctypes.c_double
        IA = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        DA = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        SA = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
        lib.ipxlu_newton_rhs1.argtypes = [I, SA] + [DA] * 10
        lib.ipxlu_newton_recover.argtypes = [I, SA] + [DA] * 15
        lib.ipxlu_step_boundary.restype = I
        lib.ipxlu_step_boundary.argtypes = [I, DA, DA,
                                            ctypes.POINTER(D)]
        lib.ipxlu_compl_products.argtypes = \
            [I, SA] + [DA] * 8 + [D, D, ctypes.POINTER(D),
                                  ctypes.POINTER(I)]
        lib.ipxlu_iterate_update.argtypes = \
            [I, SA, D, D] + [DA] * 10
        lib.ipxlu_iterate_eval.argtypes = [I, SA, I] + [DA] * 13
        _lib = lib
    except Exception:
        _failed = True
        _lib = None
    return _lib


def available() -> bool:
    return _get() is not None


def _c(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float64)


def newton_rhs1(state, rc, rl, ru, sl, su, xl, xu, zl, zu) -> np.ndarray:
    lib = _get()
    nm = state.shape[0]
    rhs1 = np.empty(nm)
    lib.ipxlu_newton_rhs1(nm, state, _c(rc), _c(rl), _c(ru), _c(sl),
                          _c(su), _c(xl), _c(xu), _c(zl), _c(zu), rhs1)
    return rhs1


def newton_recover(state, dx, atdy, rc, rl, ru, sl, su, xl, xu, zl, zu):
    lib = _get()
    nm = state.shape[0]
    dxl = np.empty(nm)
    dxu = np.empty(nm)
    dzl = np.empty(nm)
    dzu = np.empty(nm)
    lib.ipxlu_newton_recover(nm, state, _c(dx), _c(atdy), _c(rc), _c(rl),
                             _c(ru), _c(sl), _c(su), _c(xl), _c(xu),
                             _c(zl), _c(zu), dxl, dxu, dzl, dzu)
    return dxl, dxu, dzl, dzu


def step_boundary(x, dx) -> Tuple[float, int]:
    lib = _get()
    alpha = ctypes.c_double(1.0)
    j = int(lib.ipxlu_step_boundary(x.shape[0], _c(x), _c(dx),
                                    ctypes.byref(alpha)))
    return float(alpha.value), j


def compl_products(state, xl, zl, xu, zu, dxl, dzl, dxu, dzu, maxp, maxd
                   ) -> Tuple[float, int]:
    lib = _get()
    s = ctypes.c_double(0.0)
    cnt = ctypes.c_int64(0)
    lib.ipxlu_compl_products(state.shape[0], state, _c(xl), _c(zl), _c(xu),
                             _c(zu), _c(dxl), _c(dzl), _c(dxu), _c(dzu),
                             maxp, maxd, ctypes.byref(s), ctypes.byref(cnt))
    return float(s.value), int(cnt.value)


def iterate_update(state, sp, sd, x, xl, xu, zl, zu, dx, dxl, dxu, dzl, dzu
                   ) -> None:
    """In-place update; x/xl/xu/zl/zu must be contiguous float64."""
    lib = _get()
    lib.ipxlu_iterate_update(state.shape[0], state, sp, sd, x, xl, xu, zl,
                             zu, _c(dx), _c(dxl), _c(dxu), _c(dzl), _c(dzu))


def iterate_eval(state, postproc, x, xl, xu, zl, zu, lb, ub, c, aty):
    """Returns (rl, ru, rc, scalars[12]) — see ipxlu_iterate_eval."""
    lib = _get()
    nm = state.shape[0]
    rl = np.empty(nm)
    ru = np.empty(nm)
    rc = np.empty(nm)
    scal = np.zeros(12)
    lib.ipxlu_iterate_eval(nm, state, int(postproc), _c(x), _c(xl), _c(xu),
                           _c(zl), _c(zu), _c(lb), _c(ub), _c(c), _c(aty),
                           rl, ru, rc, scal)
    return rl, ru, rc, scal
