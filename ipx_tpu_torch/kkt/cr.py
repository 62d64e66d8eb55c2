"""Conjugate Residuals method for SPD systems.

Host implementation of preconditioned and unpreconditioned CR
(reference: src/conjugate_residuals.{h,cc}; Saad Alg. 6.20). Operators are
callables `apply(rhs) -> (lhs, rhs_dot_lhs)` so the curvature dot product is
fused with the matvec (reference: src/linear_operator.h:16-19).

Safeguards kept from the reference:
 - scaled inf-norm termination on the TRUE residual;
 - posdef checks via the fused dot products;
 - every 5 iterations the preconditioned residual is recomputed from its
   definition and required to decrease monotonically (round-off stagnation
   detection, reference: src/conjugate_residuals.cc:183-207).

A fully on-device jitted variant of the same recurrence lives in
ipx_tpu.ops.device_cr; this host version is the correctness reference and the
driver for operators that involve host triangular solves (basis precond).

The port's copy of ipx_tpu/kkt/cr.py.
"""
from __future__ import annotations

from time import perf_counter
from typing import Callable, Optional, Tuple

import numpy as np

from ..control import Control
from ..status import Errflag


class LinearOperator:
    """Base class: subclasses implement _apply(rhs) -> (lhs, dot)."""

    def apply(self, rhs: np.ndarray, want_dot: bool = True):
        return self._apply(rhs, want_dot)

    def _apply(self, rhs, want_dot):
        raise NotImplementedError


class ConjugateResiduals:
    def __init__(self, control: Control):
        self.control = control
        self.errflag = 0
        self.iter = 0
        self.time = 0.0

    def solve(self, C: LinearOperator, rhs: np.ndarray, tol: float,
              resscale: Optional[np.ndarray], maxiter: int,
              lhs: np.ndarray, P: Optional[LinearOperator] = None
              ) -> np.ndarray:
        t0 = perf_counter()
        if P is None:
            out = self._solve_unpre(C, rhs, tol, resscale, maxiter, lhs)
        else:
            out = self._solve_pre(C, P, rhs, tol, resscale, maxiter, lhs)
        self.time = perf_counter() - t0
        return out

    # -- unpreconditioned (reference: src/conjugate_residuals.cc:14-88) --
    def _solve_unpre(self, C, rhs, tol, resscale, maxiter, lhs):
        m = rhs.shape[0]
        self.errflag = 0
        self.iter = 0
        if maxiter < 0:
            maxiter = m + 100

        if not np.any(lhs):
            residual = rhs.copy()
        else:
            clhs, _ = C.apply(lhs, want_dot=False)
            residual = rhs - clhs
        Cresidual, cdot = C.apply(residual)
        step = residual.copy()
        Cstep = Cresidual.copy()

        while True:
            resnorm = _scaled_infnorm(residual, resscale)
            if resnorm <= tol:
                break
            if self.iter == maxiter:
                self.errflag = int(Errflag.CR_ITER_LIMIT)
                break
            if cdot <= 0.0:
                self.errflag = int(Errflag.CR_MATRIX_NOT_POSDEF)
                break
            denom = float(Cstep @ Cstep)
            alpha = cdot / denom
            if not np.isfinite(alpha):
                self.errflag = int(Errflag.CR_INF_OR_NAN)
                break
            lhs += alpha * step
            residual -= alpha * Cstep
            Cresidual, cdotnew = C.apply(residual)
            beta = cdotnew / cdot
            step = residual + beta * step
            Cstep = Cresidual + beta * Cstep
            cdot = cdotnew
            self.iter += 1
            try:
                self.control.interrupt_check()
            except Exception:
                self.errflag = int(Errflag.INTERRUPT_TIME)
                break
        return lhs

    # -- preconditioned (reference: src/conjugate_residuals.cc:90-213) ---
    def _solve_pre(self, C, P, rhs, tol, resscale, maxiter, lhs):
        m = rhs.shape[0]
        self.errflag = 0
        self.iter = 0
        if maxiter < 0:
            maxiter = m + 100

        if not np.any(lhs):
            residual = rhs.copy()
        else:
            clhs, _ = C.apply(lhs, want_dot=False)
            residual = rhs - clhs
        sresidual, resnorm_precond = P.apply(residual)
        Csresidual, cdot = C.apply(sresidual)
        step = sresidual.copy()
        Cstep = Csresidual.copy()

        while True:
            resnorm = _scaled_infnorm(residual, resscale)
            if resnorm <= tol:
                break
            if self.iter == maxiter:
                self.errflag = int(Errflag.CR_ITER_LIMIT)
                break
            if cdot <= 0.0:
                self.errflag = int(Errflag.CR_MATRIX_NOT_POSDEF)
                break

            precond_Cstep, pdot = P.apply(Cstep)
            if pdot <= 0.0:
                self.errflag = int(Errflag.CR_PRECOND_NOT_POSDEF)
                break
            alpha = cdot / pdot
            if not np.isfinite(alpha):
                self.errflag = int(Errflag.CR_INF_OR_NAN)
                break
            lhs += alpha * step
            residual -= alpha * Cstep
            sresidual -= alpha * precond_Cstep
            Csresidual, cdotnew = C.apply(sresidual)

            beta = cdotnew / cdot
            step = sresidual + beta * step
            Cstep = Csresidual + beta * Cstep
            cdot = cdotnew

            self.iter += 1
            if self.iter % 5 == 0:
                # Recompute preconditioned residual from definition; require
                # monotone decrease of residual'*P*residual.
                sresidual, rsdot = P.apply(residual)
                if rsdot >= resnorm_precond:
                    self.errflag = int(Errflag.CR_NO_PROGRESS)
                    break
                resnorm_precond = rsdot
            try:
                self.control.interrupt_check()
            except Exception:
                self.errflag = int(Errflag.INTERRUPT_TIME)
                break
        return lhs


def _scaled_infnorm(residual: np.ndarray, resscale: Optional[np.ndarray]
                    ) -> float:
    if residual.size == 0:
        return 0.0
    if resscale is not None:
        return float(np.max(np.abs(resscale * residual)))
    return float(np.max(np.abs(residual)))
