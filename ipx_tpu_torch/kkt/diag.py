"""Phase-1 KKT solver: normal equations + CR with diagonal preconditioner.

Counterpart of the reference diag KKT solver (reference:
src/kkt_solver_diag.{h,cc}). The KKT system

    [ W^{-1}  AI' ] (x) = (a)
    [ AI       0  ] (y)   (b)

is reduced to normal equations (AI W AI') y = AI W a - b, solved by CR, and
x is recovered so the residual sits only in rows of the slack basis; the
residual-scaling vector 1/sqrt(W_slack) makes the CR termination test match
the KKT-solver contract (reference: src/kkt_solver_diag.cc:67-81).

For free variables W[j] = 1/regval with regval = min(mu, smallest nonzero g)
(reference: src/kkt_solver_diag.cc:24-49).

The CR loop runs on the host (native or numpy), on the row blocks of
parallel/sharding.py when Parameters.shards > 1, or as the whole loop on a
torch device through the hand-written CUDA kernels (ops/device_cr.py),
selected by Parameters.device.

The port's copy of ipx_tpu/kkt/diag.py. Its device branches are the
port's: _prepare_sharded builds the port's ShardedDiagCR on the device that
backend.resolve_sharded picks, _prepare_device the port's device CR in the
precision Parameters.precision names; neither falls back when a
constructor raises.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..control import Control
from ..info import Info
from .. import backend
from ..model import Model
from ..ops.device_cr import DeviceNormalCR, MixedPrecisionDeviceCR
from ..parallel.sharding import ShardedDiagCR
from .base import KKTSolver
from .cr import ConjugateResiduals
from .diagonal_precond import DiagonalPrecond
from .normal_matrix import NormalMatrix


def _monotonic_s() -> float:
    """Monotonic clock matching the C++ side's steady_clock (both are
    CLOCK_MONOTONIC on Linux)."""
    import time
    return time.monotonic()


class KKTSolverDiag(KKTSolver):
    def __init__(self, control: Control, model: Model):
        self.control = control
        self.model = model
        self.normal_matrix = NormalMatrix(model)
        self.precond = DiagonalPrecond(model)
        nm = model.num_var_all
        self.W = np.ones(nm)
        self.resscale = np.ones(model.num_rows)
        self.maxiter = -1
        self._iters = 0
        self.factorized = False
        self._device_cr = None
        self._sharded = None        # row-sharded mesh CR (shards > 1)
        self._nrm_handle = None     # explicit normal-matrix native handle
        self._nrm_failed = False

    def _factorize(self, iterate, info: Info) -> None:
        md = self.model
        m, n = md.num_rows, md.num_cols
        self._iters = 0
        self.factorized = False

        if iterate is not None:
            with np.errstate(divide="ignore"):
                g = np.where(iterate.barrier_lb_mask,
                             iterate.zl / iterate.xl, 0.0) \
                    + np.where(iterate.barrier_ub_mask,
                               iterate.zu / iterate.xu, 0.0)
            # regularization for free variables: min(mu, min nonzero g)
            nz = g[g != 0.0]
            regval = min(iterate.mu(), float(nz.min()) if nz.size
                         else iterate.mu())
            with np.errstate(divide="ignore"):
                W = 1.0 / g
            W[~np.isfinite(W)] = 1.0 / regval
            self.W = W
        else:
            self.W = np.ones(n + m)

        self.resscale = np.ascontiguousarray(1.0 / np.sqrt(self.W[n:]))
        self.W = np.ascontiguousarray(self.W)
        self.normal_matrix.prepare(self.W)
        self.precond.factorize(self.W,
                               bool(self.control.parameters.precond_dense_cols),
                               info)
        if info.errflag:
            return
        self._prepare_sharded()
        self._prepare_device()
        self._prepare_native_cr()
        self.factorized = True

    def _prepare_sharded(self) -> None:
        """Row-blocked CR when Parameters.shards > 1 (SURVEY §2.3: the
        model-parallel axis, reachable from LpSolver). The blocks live on
        the ranks of backend.resolve_mesh's mesh, one block a rank, or
        without one on the device of backend.resolve_sharded; the solver is
        built once per model and device (or mesh) and kept on the model.
        Errors raise: there is no unsharded fallback."""
        self._sharded = None
        params = self.control.parameters
        if params.shards is None or params.shards <= 1:
            return
        if self.precond.Adense is not None:
            return      # dense-column SMW runs on host
        P = int(params.shards)
        mesh, device, key = backend.sharded_place(params.device, P)
        cached = getattr(self.model, "_sharded_cr", None)
        if cached is not None and cached[0] == key:
            self._sharded = cached[1]
            return
        cr = ShardedDiagCR(self.model.A, P, device, mesh)
        where = device if mesh is None else mesh.describe()
        self.control.log(f" sharded phase-1 CR: {P} row blocks on {where}"
                         f"\n")
        self.model._sharded_cr = (key, cr)
        self._sharded = cr

    def _prepare_native_cr(self) -> None:
        """Whole-CR-loop native path (diag precond, no dense columns)."""
        self._native_cr = None
        if self._device_cr is not None or self._sharded is not None:
            return
        if self.precond.Adense is not None:
            return      # dense-column SMW runs through the Python CR
        try:
            import ctypes as ct
            from .normal_matrix import _native_apply_handle
            handle = _native_apply_handle(self.model)
            if handle is None:
                return
            lib, Ap, Ai, Ax = handle
            if not hasattr(lib, "_cr_ready"):
                I = ct.c_int64
                D = ct.c_double
                IA = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
                IA32 = np.ctypeslib.ndpointer(np.int32,
                                              flags="C_CONTIGUOUS")
                DA = np.ctypeslib.ndpointer(np.float64,
                                            flags="C_CONTIGUOUS")
                PD = ct.POINTER(ct.c_double)
                lib.ipxlu_cr_diag_warm.restype = I
                lib.ipxlu_cr_diag_warm.argtypes = [I, I, IA, IA32, DA, DA,
                                                   DA, DA, DA, D, I, D, DA,
                                                   ct.POINTER(I), I, PD]
                lib.ipxlu_nrm_new.restype = ct.c_void_p
                lib.ipxlu_nrm_new.argtypes = [I, I, IA, IA32, DA, I]
                lib.ipxlu_nrm_nnz.restype = I
                lib.ipxlu_nrm_nnz.argtypes = [ct.c_void_p]
                lib.ipxlu_nrm_values.restype = None
                lib.ipxlu_nrm_values.argtypes = [ct.c_void_p, DA]
                lib.ipxlu_nrm_free.restype = None
                lib.ipxlu_nrm_free.argtypes = [ct.c_void_p]
                lib.ipxlu_cr_diag_explicit_warm.restype = I
                lib.ipxlu_cr_diag_explicit_warm.argtypes = [
                    ct.c_void_p, DA, DA, DA, D, I, D, DA, ct.POINTER(I), I,
                    PD]
                lib.ipxlu_cr_diag_explicit_mixed.restype = I
                lib.ipxlu_cr_diag_explicit_mixed.argtypes = [
                    ct.c_void_p, DA, DA, DA, D, I, D, DA, ct.POINTER(I), I,
                    PD]
                lib.ipxlu_nrm_ic_factorize.restype = I
                lib.ipxlu_nrm_ic_factorize.argtypes = [ct.c_void_p]
                lib.ipxlu_cr_diag_explicit_ic.restype = I
                lib.ipxlu_cr_diag_explicit_ic.argtypes = [
                    ct.c_void_p, DA, DA, D, I, D, DA, ct.POINTER(I), I, PD]
                lib._cr_ready = True
            self._native_cr = (lib, Ap, Ai, Ax, ct)
            self._prepare_explicit_normal(lib, Ap, Ai, Ax, ct)
        except Exception:
            self._native_cr = None

    def _prepare_explicit_normal(self, lib, Ap, Ai, Ax, ct) -> None:
        """Explicit S = AI W AI' in CSR, rebuilt numerically per factorize.

        The weights are constant across a whole CR solve, so when fill(S)
        is small a sequential CSR SpMV beats the one-pass gather/scatter
        product per iteration. Symbolic build happens once per solver (the
        pattern depends only on A); skipped when nnz(S) > 4 nnz(AI) or the
        symbolic build failed once.
        """
        m, n = self.model.num_rows, self.model.num_cols
        if self._nrm_handle is None and not self._nrm_failed:
            import weakref
            cap = 4 * (int(Ap[n]) + m)
            ptr = lib.ipxlu_nrm_new(m, n, Ap, Ai, Ax, cap)
            if not ptr:
                self._nrm_failed = True
                return
            self._nrm_handle = ptr
            # the handle borrows Ap/Ai/Ax; keep them alive with it
            self._nrm_keepalive = (Ap, Ai, Ax)
            self._nrm_finalizer = weakref.finalize(
                self, lib.ipxlu_nrm_free, ptr)
        if self._nrm_handle is not None:
            lib.ipxlu_nrm_values(self._nrm_handle, self.W)
            # IC(0) on S: a much stronger phase-1 preconditioner than the
            # diagonal when the pattern admits it (shift ladder inside);
            # falls back to the diag/mixed path when factorization fails
            # measured across testgen families: IC(0) cuts phase-1 CR
            # iterations by only ~20% on transportation and can be worse
            # than the diagonal on staircase patterns, while doubling the
            # per-iteration cost — so it stays opt-in
            self._ic_ok = False
            if self.control.parameters.kkt_precond == "ic":
                self._ic_ok = (
                    int(lib.ipxlu_nrm_ic_factorize(self._nrm_handle)) == 0)

    def _prepare_device(self) -> None:
        """The device CR solver when Parameters.device asks for one
        (backend.resolve): the f64 DeviceNormalCR when Parameters.precision
        is "f64", else mixed precision. The reference builds the mixed
        solver whatever Parameters.precision says; the port honours the
        parameter on purpose, as the host path does (ROADMAP, Queue 3). The
        reference falls back to its f64 solver, and then to the host, when
        a constructor raises (a failed jax compile); here the error
        propagates."""
        self._device_cr = None
        if self._sharded is not None:
            return      # the row-blocked CR is the device path
        params = self.control.parameters
        device = backend.resolve(params.device, self.model)
        if device is None:
            return
        if self.precond.Adense is not None:
            return      # dense-column SMW precond runs on host
        if params.precision == "f64":
            self._device_cr = DeviceNormalCR(
                self.model, self.W, self.precond.diagonal, self.resscale,
                device)
        else:
            self._device_cr = MixedPrecisionDeviceCR(
                self.model, self.W, self.precond.diagonal, self.resscale,
                host_apply=self.normal_matrix.apply_vec, device=device)

    def _solve(self, a: np.ndarray, b: np.ndarray, tol: float, info: Info,
               y0: Optional[np.ndarray] = None):
        md = self.model
        m, n = md.num_rows, md.num_cols
        assert self.factorized

        # rhs = AI*W*a - b (single fused gather pass when native)
        mulh = md._native_mul()
        if mulh is not None and a.dtype == np.float64:
            lib_m, _, _, _, ATp, ATi, ATx = mulh
            rhs = np.empty(m)
            lib_m.ipxlu_diag_rhs(m, n, ATp, ATi, ATx, self.W,
                                 np.ascontiguousarray(a),
                                 np.ascontiguousarray(b), rhs)
        else:
            wa = self.W * a
            rhs = md.AI_mul(wa) - b

        warm = 0
        if y0 is not None and self._device_cr is None \
                and self._native_cr is not None and np.all(np.isfinite(y0)):
            y = np.ascontiguousarray(y0, dtype=np.float64)
            warm = 1
        else:
            y = np.zeros(m)
        self.normal_matrix.reset_time()
        self.precond.reset_time()

        if getattr(self, "_sharded", None) is not None:
            from time import perf_counter
            n_cols = self.model.num_cols
            t0 = perf_counter()
            y, iters, errflag = self._sharded.solve(
                self.W[:n_cols], self.W[n_cols:], self.precond.diagonal,
                self.resscale, rhs, tol, self.maxiter)
            dt = perf_counter() - t0
            info.errflag = errflag
            info.kktiter1 += iters
            info.time_cr1 += dt
            self._iters += iters
        elif self._device_cr is not None:
            y, iters, errflag, cr_time, mv_time = self._device_cr.solve(
                rhs, tol, self.maxiter)
            info.errflag = errflag
            info.kktiter1 += iters
            info.time_cr1 += cr_time
            info.time_cr1_AAt += mv_time
            self._iters += iters
        elif self._native_cr is not None:
            from time import perf_counter
            lib, Ap, Ai, Ax, ct = self._native_cr
            deadline = 0.0
            tl = self.control.parameters.time_limit
            if tl >= 0:
                import time as _t
                remaining = tl - self.control.elapsed()
                deadline = _monotonic_s() + max(remaining, 0.0)
            iters = ct.c_int64(0)
            mvtime = ct.c_double(0.0)
            t0 = perf_counter()
            if self._nrm_handle is not None and getattr(self, "_ic_ok",
                                                        False):
                err = int(lib.ipxlu_cr_diag_explicit_ic(
                    self._nrm_handle, self.resscale,
                    np.ascontiguousarray(rhs), tol, self.maxiter, deadline,
                    y, ct.byref(iters), warm, ct.byref(mvtime)))
            elif self._nrm_handle is not None:
                # mixed precision (f32 inner CR + f64 defect correction,
                # f64 finish on stall) unless precision="f64"
                fn = (lib.ipxlu_cr_diag_explicit_warm
                      if self.control.parameters.precision == "f64"
                      else lib.ipxlu_cr_diag_explicit_mixed)
                err = int(fn(
                    self._nrm_handle, self.precond.diagonal, self.resscale,
                    np.ascontiguousarray(rhs), tol, self.maxiter, deadline,
                    y, ct.byref(iters), warm, ct.byref(mvtime)))
            else:
                err = int(lib.ipxlu_cr_diag_warm(
                    m, n, Ap, Ai, Ax, self.W, self.precond.diagonal,
                    self.resscale, np.ascontiguousarray(rhs), tol,
                    self.maxiter, deadline, y, ct.byref(iters), warm,
                    ct.byref(mvtime)))
            dt = perf_counter() - t0
            info.errflag = 999 if err == 999 else err
            info.kktiter1 += iters.value
            info.time_cr1 += dt
            info.time_cr1_AAt += mvtime.value
            self._iters += iters.value
        else:
            cr = ConjugateResiduals(self.control)
            cr.solve(self.normal_matrix, rhs, tol, self.resscale,
                     self.maxiter, y, P=self.precond)
            info.errflag = cr.errflag
            info.kktiter1 += cr.iter
            info.time_cr1 += cr.time
            info.time_cr1_AAt += self.normal_matrix.time
            info.time_cr1_pre += self.precond.time
            self._iters += cr.iter

        # Recover solution to the KKT system: x = W*(a - AI'y) for structural
        # part; x_slack = b - A*x_struct keeps residual in the slack rows.
        x = np.empty(n + m)
        if mulh is not None and a.dtype == np.float64:
            lib_m, Ap, Ai, Ax, ATp, ATi, ATx = mulh
            lib_m.ipxlu_diag_recover(m, n, Ap, Ai, Ax, ATp, ATi, ATx,
                                     self.W, np.ascontiguousarray(a), y,
                                     np.ascontiguousarray(b), x)
        else:
            aty = md.AIt_mul(y)
            x[:n] = self.W[:n] * (a[:n] - aty[:n])
            x[n:] = b - md.A @ x[:n]
        return x, y

    def _iter(self) -> int:
        return self._iters
