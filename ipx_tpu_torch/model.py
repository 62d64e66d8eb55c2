"""Computational-form LP model.

Counterpart of the reference solver model (reference: src/model.{h,cc}):

    minimize   c'x
    subject to AI*x = b,            (dual: y)
               x-xl = lb, xl >= 0,  (dual: zl >= 0)
               x+xu = ub, xu >= 0,  (dual: zu >= 0)

with AI = [A I], m rows and n+m columns. TPU-first difference from the
reference: the slack identity block is NEVER materialized. The model stores
only the structural matrix A (CSC and CSR); every product with AI handles the
identity part implicitly, which both halves memory traffic and keeps the
device kernels free of trivially-structured nonzeros.

The port's copy of ipx_tpu/model.py; its clear() also drops the caches
that other modules keep on the model.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sp

from .info import Info
from .sparse import DeviceMatrix

INF = np.inf


class Model:
    """Immutable computational form (populated by the presolver)."""

    def __init__(self):
        self.clear()

    def clear(self) -> None:
        self.dualized = False
        self.num_rows = 0
        self.num_cols = 0                  # structural columns (n)
        self.num_dense_cols = 0
        self.nz_dense = 0
        self.A: Optional[sp.csc_matrix] = None    # m x n structural part
        self.A_csr: Optional[sp.csr_matrix] = None
        self.b = np.empty(0)
        self.c = np.empty(0)               # length n+m
        self.lb = np.empty(0)              # length n+m
        self.ub = np.empty(0)              # length n+m
        self.norm_bounds = 0.0
        self.norm_c = 0.0
        self._device: Optional[DeviceMatrix] = None
        # What other modules cache on the model belongs to the matrix of the
        # LP it held: the native handles and arrays (_native_mul here,
        # kkt/normal_matrix.py:_native_apply_handle, basis/crossover.py,
        # basis/basis.py), the device operands (ops/spmv.py) and the
        # sharded solvers (kkt/diag.py, kkt/basis_precond.py). A second LP
        # that reused them crashed in a native kernel, so they go.
        for name in self._CACHES:
            self.__dict__.pop(name, None)

    _CACHES = ("_native_mul_h", "_native_csc32", "_native_csr32",
               "_native_csc", "_native_csr", "_basis_BiBx", "_torch_normal",
               "_sharded_cr", "_sharded_nnt")

    # -- dimensions ----------------------------------------------------
    @property
    def rows(self) -> int:
        return self.num_rows

    @property
    def cols(self) -> int:
        return self.num_cols

    @property
    def num_var_all(self) -> int:
        """Total variables n+m (structural + slack)."""
        return self.num_cols + self.num_rows

    def empty(self) -> bool:
        return self.num_cols == 0

    def entries(self) -> int:
        """nnz of AI including the implicit identity."""
        return (self.A.nnz if self.A is not None else 0) + self.num_rows

    def get_info(self, info: Info) -> None:
        info.num_rows_solver = self.num_rows
        info.num_cols_solver = self.num_cols + self.num_rows
        info.num_entries_solver = self.entries()
        info.dense_cols = self.num_dense_cols

    # -- finalization (called by presolver after loading) ---------------
    def finalize(self) -> None:
        self.A = self.A.tocsc()
        self.A.sort_indices()
        self.A_csr = self.A.tocsr()
        self._find_dense_columns()
        self._compute_norms()
        self._device = None

    def _find_dense_columns(self) -> None:
        """Classify the max number of structural columns as dense which have
        >40 nnz and >10x the nnz of any non-dense column; if more than 1000
        would qualify, classify none (reference: src/model.cc:34-56)."""
        self.num_dense_cols = 0
        self.nz_dense = self.num_rows + 1
        counts = np.sort(np.diff(self.A.indptr))
        n = self.num_cols
        if n > 1:
            prev = counts[:-1].astype(np.int64)
            mask = counts[1:] > np.maximum(40, 10 * prev)
            hits = np.nonzero(mask)[0]
            if hits.size:
                j = int(hits[0]) + 1
                self.num_dense_cols = n - j
                self.nz_dense = int(counts[j])
        if self.num_dense_cols > 1000:
            self.num_dense_cols = 0
            self.nz_dense = self.num_rows + 1

    def is_dense_column(self, j: int) -> bool:
        if j >= self.num_cols:
            return False                   # slack columns have 1 entry
        return self.A.indptr[j + 1] - self.A.indptr[j] >= self.nz_dense

    def dense_column_indices(self) -> np.ndarray:
        counts = np.diff(self.A.indptr)
        return np.nonzero(counts >= self.nz_dense)[0]

    def _compute_norms(self) -> None:
        self.norm_c = float(np.max(np.abs(self.c))) if self.c.size else 0.0
        vals = [np.abs(self.b)] if self.b.size else []
        for v in (self.lb, self.ub):
            finite = np.abs(v[np.isfinite(v)])
            if finite.size:
                vals.append(finite)
        self.norm_bounds = float(max((v.max() for v in vals if v.size),
                                     default=0.0))

    # -- device layout ---------------------------------------------------
    @property
    def device(self) -> DeviceMatrix:
        if self._device is None:
            self._device = DeviceMatrix(self.A)
        return self._device

    # -- products with AI = [A I] (slack identity implicit) --------------
    def _native_mul(self):
        """(lib, Ap, Ai, Ax) for the native SpMV kernels, or None."""
        h = getattr(self, "_native_mul_h", False)
        if h is not False:
            return h
        h = None
        try:
            import ctypes
            from .basis.lu import _load_lib
            lib = _load_lib()
            if not hasattr(lib, "_aimul_ready"):
                I = ctypes.c_int64
                IA = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
                IA32 = np.ctypeslib.ndpointer(np.int32,
                                              flags="C_CONTIGUOUS")
                DA = np.ctypeslib.ndpointer(np.float64,
                                            flags="C_CONTIGUOUS")
                lib.ipxlu_ai_mul.argtypes = [I, I, IA, IA32, DA, DA, DA]
                lib.ipxlu_ai_mul_csr.argtypes = [I, I, IA, IA32, DA, DA,
                                                 DA]
                lib.ipxlu_ait_mul.argtypes = [I, I, IA, IA32, DA, DA, DA]
                lib.ipxlu_diag_rhs.argtypes = [I, I, IA, IA32, DA, DA, DA,
                                               DA, DA]
                lib.ipxlu_diag_recover.argtypes = [I, I, IA, IA32, DA, IA,
                                                   IA32, DA, DA, DA, DA,
                                                   DA, DA]
                lib._aimul_ready = True
            if not hasattr(self, "_native_csc32"):
                A = self.A
                self._native_csc32 = (
                    np.ascontiguousarray(A.indptr, dtype=np.int64),
                    np.ascontiguousarray(A.indices, dtype=np.int32),
                    np.ascontiguousarray(A.data, dtype=np.float64))
            if not hasattr(self, "_native_csr32"):
                AT = self.A_csr
                self._native_csr32 = (
                    np.ascontiguousarray(AT.indptr, dtype=np.int64),
                    np.ascontiguousarray(AT.indices, dtype=np.int32),
                    np.ascontiguousarray(AT.data, dtype=np.float64))
            h = (lib,) + self._native_csc32 + self._native_csr32
        except Exception:
            h = None
        self._native_mul_h = h
        return h

    def AI_mul(self, x: np.ndarray) -> np.ndarray:
        """AI @ x for x of length n+m."""
        n = self.num_cols
        h = self._native_mul()
        if h is not None and x.dtype == np.float64:
            lib, Ap, Ai, Ax, ATp, ATi, ATx = h
            out = np.empty(self.num_rows)
            lib.ipxlu_ai_mul_csr(self.num_rows, n, ATp, ATi, ATx,
                                 np.ascontiguousarray(x), out)
            return out
        return self.A @ x[:n] + x[n:]

    def AIt_mul(self, y: np.ndarray) -> np.ndarray:
        """AI' @ y, returns length n+m."""
        h = self._native_mul()
        if h is not None and y.dtype == np.float64:
            lib, Ap, Ai, Ax = h[:4]
            out = np.empty(self.num_var_all)
            lib.ipxlu_ait_mul(self.num_rows, self.num_cols, Ap, Ai, Ax,
                              np.ascontiguousarray(y), out)
            return out
        out = np.empty(self.num_var_all)
        out[:self.num_cols] = y @ self.A_csr
        out[self.num_cols:] = y
        return out

    def AI_col(self, j: int):
        """(indices, values) of column j of AI."""
        if j < self.num_cols:
            sl = slice(self.A.indptr[j], self.A.indptr[j + 1])
            return self.A.indices[sl], self.A.data[sl]
        i = j - self.num_cols
        return (np.array([i], dtype=self.A.indices.dtype),
                np.array([1.0]))

    # -- residuals (reference: src/model.cc:69-124) -----------------------
    def primal_infeasibility(self, x: np.ndarray) -> float:
        infeas = np.maximum(self.lb - x, x - self.ub)
        return float(max(np.max(infeas), 0.0)) if x.size else 0.0

    def dual_infeasibility(self, x: np.ndarray, z: np.ndarray) -> float:
        infeas = np.maximum(np.where(x > self.lb, z, -INF),
                            np.where(x < self.ub, -z, -INF))
        return float(max(np.max(infeas), 0.0)) if x.size else 0.0

    def primal_residual(self, x: np.ndarray) -> float:
        r = self.b - self.AI_mul(x)
        return float(np.max(np.abs(r))) if r.size else 0.0

    def dual_residual(self, y: np.ndarray, z: np.ndarray) -> float:
        r = self.c - z - self.AIt_mul(y)
        return float(np.max(np.abs(r))) if r.size else 0.0
