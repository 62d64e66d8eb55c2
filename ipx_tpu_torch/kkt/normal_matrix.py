"""Normal-matrix operator C = AI * diag(W) * AI'.

Counterpart of the reference normal matrix operator (reference:
src/normal_matrix.{h,cc}). With the slack identity implicit, the apply is

    C v = A (W_struct ⊙ (A' v)) + W_slack ⊙ v,

two CSR/CSC SpMVs plus elementwise work on host (scipy native code), or one
fused device kernel (ipx_tpu.ops). The curvature dot product rhs·lhs is fused
with the matvec as in the reference (src/normal_matrix.cc:123-124).

The port's copy of ipx_tpu/kkt/normal_matrix.py.
"""
from __future__ import annotations

from time import perf_counter
from typing import Optional

import numpy as np

from ..model import Model
from .cr import LinearOperator


class NormalMatrix(LinearOperator):
    def __init__(self, model: Model):
        self.model = model
        self.W: Optional[np.ndarray] = None
        self.time = 0.0
        self._native = _native_apply_handle(model)

    def prepare(self, W: Optional[np.ndarray]) -> None:
        self.W = np.ascontiguousarray(W) if W is not None else None

    def reset_time(self) -> None:
        self.time = 0.0

    def apply_vec(self, rhs: np.ndarray) -> np.ndarray:
        """Plain matvec without the fused dot (refinement residuals)."""
        lhs, _ = self._apply(rhs, False)
        return lhs

    def _apply(self, rhs: np.ndarray, want_dot: bool):
        t0 = perf_counter()
        md = self.model
        n = md.num_cols
        if self._native is not None and self.W is not None:
            lib, Ap, Ai, Ax = self._native
            lhs = np.empty(md.num_rows)
            rhs = np.ascontiguousarray(rhs)
            dot = lib.ipxlu_normal_apply(md.num_rows, n, Ap, Ai, Ax,
                                         self.W, rhs, lhs)
            self.time += perf_counter() - t0
            return lhs, (float(dot) if want_dot else None)
        if self.W is not None:
            u = (rhs @ md.A_csr) * self.W[:n]      # W_struct ⊙ (A' v)
            lhs = md.A @ u
            lhs += self.W[n:] * rhs                # slack block
        else:
            u = rhs @ md.A_csr
            lhs = md.A @ u                         # A A' v (zero slack weight)
        dot = float(rhs @ lhs) if want_dot else None
        self.time += perf_counter() - t0
        return lhs, dot


def _native_apply_handle(model: Model):
    """Returns (lib, Ap, Ai, Ax) with int64/f64 contiguous CSC arrays of A,
    or None if the native kernel is unavailable."""
    try:
        import ctypes
        from ..basis.lu import _load_lib
        lib = _load_lib()
        if not hasattr(lib, "_normal_ready"):
            I = ctypes.c_int64
            IA = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            IA32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            DA = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
            lib.ipxlu_normal_apply.restype = ctypes.c_double
            lib.ipxlu_normal_apply.argtypes = [I, I, IA, IA32, DA, DA, DA,
                                               DA]
            lib._normal_ready = True
        # int32 row indices: halves the index traffic of the
        # bandwidth-bound SpMV kernels
        if not hasattr(model, "_native_csc32"):
            A = model.A
            model._native_csc32 = (
                np.ascontiguousarray(A.indptr, dtype=np.int64),
                np.ascontiguousarray(A.indices, dtype=np.int32),
                np.ascontiguousarray(A.data, dtype=np.float64))
        Ap, Ai, Ax = model._native_csc32
        return lib, Ap, Ai, Ax
    except Exception:
        return None
