"""Basis-preconditioned normal matrix operator.

Counterpart of the reference splitted normal matrix (reference:
src/splitted_normal_matrix.{h,cc}): matrix-vector products with

    C = inv(B~) AI~ AI~' inv(B~') = I + inv(B~) N~ N~' inv(B~'),

where [B N] is the basic/nonbasic column partition of AI, ~ denotes scaling
by the interior point scaling factors. BASIC_FREE variables' rows/columns of
C are unit vectors; NONBASIC_FIXED columns are dropped from N.

Re-architected vs the reference: the operator is expressed in BASIS-SLOT
space and the B/B' solves go through the eta-aware FTRAN/BTRAN, so it is
exact for the CURRENT basis on a stale factorization plus product-form
updates. The reference instead extracts fresh L/U factors and works in
pivot-position space, which forces a refactorization every IPM iteration
(reference: src/kkt_solver_basis.cc:58-66, src/splitted_normal_matrix.cc:
18-66); here refactorization is purely cost-driven (LuUpdate.need_fresh).

The solves run in the native kernel; the N N' product is two scipy SpMVs in
the fallback path. Timers mirror the reference (time_B/Bt/NNt, reference:
src/splitted_normal_matrix.cc:72-88).

The port's copy of ipx_tpu/kkt/splitted_normal.py.
"""
from __future__ import annotations

from time import perf_counter

import numpy as np
import scipy.sparse as sp

from ..model import Model
from .cr import LinearOperator



class SplittedNormalMatrix(LinearOperator):
    def __init__(self, model: Model):
        self.model = model
        self.prepared = False
        self.time_B = 0.0
        self.time_Bt = 0.0
        self.time_NNt = 0.0

    def reset_time(self) -> None:
        self.time_B = 0.0
        self.time_Bt = 0.0
        self.time_NNt = 0.0

    def prepare(self, basis, colscale: np.ndarray) -> None:
        """reference: src/splitted_normal_matrix.cc:18-66 (re-architected:
        basis-slot space, eta-aware solves, no fresh factors required)."""
        md = self.model
        m, n = md.num_rows, md.num_cols
        self.prepared = False

        lu = basis.lu
        self._lu = lu
        self._basis = basis

        # per-slot scale factors of the basic columns (1 at BASIC_FREE)
        free_pos_mask = basis.basic_free_mask()
        s = np.where(free_pos_mask, 1.0, colscale[basis.basis])
        assert np.all(np.isfinite(s)) and np.all(s > 0)
        self.uscale = s
        self.free_positions = np.nonzero(free_pos_mask)[0]

        # N: nonbasic (status NONBASIC, not FIXED) columns of AI in original
        # row space, columns scaled.
        nb = np.nonzero(basis.map2basis == -1)[0]
        struct_nb = nb[nb < n]
        slack_nb = nb[nb >= n]
        Nstruct = md.A[:, struct_nb] if struct_nb.size else \
            sp.csc_matrix((m, 0))
        if slack_nb.size:
            Nslack = sp.csc_matrix(
                (np.ones(slack_nb.size),
                 (slack_nb - n, np.arange(slack_nb.size))),
                shape=(m, slack_nb.size))
            N = sp.hstack([Nstruct, Nslack], format="csc")
            scales = np.concatenate([colscale[struct_nb],
                                     colscale[slack_nb]])
        else:
            N = Nstruct.tocsc()
            scales = colscale[struct_nb]
        N = N.tocsc()
        N = sp.csc_matrix(
            (N.data * scales.repeat(np.diff(N.indptr)),
             N.indices, N.indptr), shape=(m, N.shape[1]))
        self.N = N
        self.NT = None          # built lazily for the non-native path
        self._prepare_native(lu)
        if self._native is None:
            self.NT = N.T.tocsr()
        self.prepared = True

    def _prepare_native(self, lu) -> None:
        """Registers the operator with the native kernel so the whole
        phase-2 CR loop can run without Python crossings."""
        self._native = None
        lib = getattr(lu, "lib", None)
        handle = getattr(lu, "handle", None)
        if lib is None or not handle:
            return
        try:
            import ctypes as ct
            if not hasattr(lib, "_splitted_ready"):
                I = ct.c_int64
                D = ct.c_double
                P_ = ct.c_void_p
                IA = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
                IA32 = np.ctypeslib.ndpointer(np.int32,
                                              flags="C_CONTIGUOUS")
                DA = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
                lib.ipxlu_splitted_prepare.argtypes = [P_, I, IA, IA32, DA,
                                                       DA, I, IA]
                lib.ipxlu_cr_basis.restype = I
                lib.ipxlu_cr_basis.argtypes = [P_, DA, D, I, D, DA,
                                               ct.POINTER(I), DA,
                                               ct.c_void_p]
                lib._splitted_ready = True
            N = self.N
            Np = np.ascontiguousarray(N.indptr, dtype=np.int64)
            Ni = np.ascontiguousarray(N.indices, dtype=np.int32)
            Nx = np.ascontiguousarray(N.data, dtype=np.float64)
            us = np.ascontiguousarray(self.uscale, dtype=np.float64)
            fp = np.ascontiguousarray(self.free_positions, dtype=np.int64)
            if fp.size == 0:
                fp = np.zeros(1, dtype=np.int64)     # valid pointer
            lib.ipxlu_splitted_prepare(handle, N.shape[1], Np, Ni, Nx, us,
                                       self.free_positions.size, fp)
            self._native = (lib, handle)
        except Exception:
            self._native = None

    def native_cr(self, rhs: np.ndarray, tol: float, maxiter: int,
                  deadline: float, warm: np.ndarray = None):
        """Whole CR loop in the native kernel. `warm` optionally supplies a
        slot-space starting solution (valid for the SAME prepared operator
        only); the kernel falls back to the zero start whenever the warm
        residual is not smaller. Returns (lhs, iters, errflag)."""
        import ctypes as ct
        lib, handle = self._native
        m = self.model.num_rows
        lhs = np.zeros(m)
        iters = ct.c_int64(0)
        times = np.zeros(3)
        if warm is not None:
            warm = np.ascontiguousarray(warm, dtype=np.float64)
            wptr = warm.ctypes.data_as(ct.c_void_p)
        else:
            wptr = None
        err = int(lib.ipxlu_cr_basis(
            handle, np.ascontiguousarray(rhs, dtype=np.float64), tol,
            maxiter, deadline, lhs, ct.byref(iters), times, wptr))
        self.time_B += times[0]
        self.time_Bt += times[1]
        self.time_NNt += times[2]
        return lhs, iters.value, err

    def _apply(self, rhs: np.ndarray, want_dot: bool):
        """reference: src/splitted_normal_matrix.cc:90-117 (slot space,
        eta-aware solves)"""
        assert self.prepared
        s = self.uscale

        # work(rows) = inv(B') (rhs / s)
        t0 = perf_counter()
        w = self._basis.solve_dense(rhs / s, "T")
        self.time_Bt += perf_counter() - t0

        # lhs = N N' w
        t0 = perf_counter()
        if self.NT is None:
            self.NT = self.N.T.tocsr()
        u = self.NT @ w
        lhs = self.N @ u
        self.time_NNt += perf_counter() - t0

        # lhs(slots) := inv(B) lhs(rows) / s
        t0 = perf_counter()
        lhs = self._basis.solve_dense(lhs, "N") / s
        self.time_B += perf_counter() - t0

        lhs = lhs + rhs
        if self.free_positions.size:
            lhs[self.free_positions] = 0.0
        dot = float(rhs @ lhs) if want_dot else None
        return lhs, dot
