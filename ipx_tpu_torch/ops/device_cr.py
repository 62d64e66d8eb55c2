"""Preconditioned Conjugate Residuals on the normal equations, on a torch
device (port of ipx_tpu/ops/device_cr.py).

The kernel here is K3 ``cr_solve``: the Jacobi-preconditioned CR loop of
``ipx_tpu/ops/device_cr.py:_build_cr_fn.cr``, where the TPU runs the whole
loop as one ``lax.while_loop``. On the card the whole loop, its K2 applies
inside, is one cooperative launch of the hand-written ``cr_step`` kernel
(csrc/cr.cu) per solve, and the host reads the loop's state once after it.
What bounds a trip on the H100 is latency: at m = 20 000 each pass moves
well under a megabyte, and the grid barriers between the passes take the
place of the host-issued form's five launches a trip. That form (the host
issues each trip's passes and two K2 launches and reads the stop flag every
few trips) stays at the kernel layer, ``kernels.CrStep.solve(...,
cooperative=False)``, which the solvers never ask for: the card tests and
chip_smoke.py hold the two bit for bit. The plain version,
``cr_solve_plain``, is the same loop in PyTorch operations with the scalar
tests on the host.

Termination, error codes and their priority, and keep-on-stop follow the
reference exactly: converged > iteration limit > not posdef > precond not
posdef > inf/nan > stagnated, and every stop but stagnation keeps the state
from before the trip's update.
"""
from __future__ import annotations

from time import perf_counter
from typing import Tuple

import numpy as np
import torch

from .. import kernels
from ..model import Model
from ..status import Errflag
from .spmv import NP_DTYPE, NormalMatrixDevice, normal_apply_plain

# error codes inside the device loop (ipx_tpu/ops/device_cr.py:51-66)
_OK = 0
_ITER_LIMIT = 1
_NOT_POSDEF = 2
_PRECOND_NOT_POSDEF = 3
_NO_PROGRESS = 4
_INF_NAN = 5

_ERRFLAG_MAP = {
    _OK: 0,
    _ITER_LIMIT: int(Errflag.CR_ITER_LIMIT),
    _NOT_POSDEF: int(Errflag.CR_MATRIX_NOT_POSDEF),
    _PRECOND_NOT_POSDEF: int(Errflag.CR_PRECOND_NOT_POSDEF),
    _NO_PROGRESS: int(Errflag.CR_NO_PROGRESS),
    _INF_NAN: int(Errflag.CR_INF_OR_NAN),
}

RECHECK_EVERY = 5   # monotonicity recheck of the preconditioned residual


def cr_solve_plain(nmd: NormalMatrixDevice, W, invd, resscale, rhs,
                   tol: float, maxiter: int):
    """Plain version of K3. Returns (lhs, iterations, loop error code)."""
    tol = torch.tensor(tol, dtype=rhs.dtype)

    def C(v):
        return normal_apply_plain(nmd, W, v)

    def P(v):
        out = v * invd
        return out, torch.dot(v, out)

    lhs = torch.zeros_like(rhs)
    residual = rhs.clone()
    sres, rpn = P(residual)
    Csres, cdot = C(sres)
    step, Cstep = sres, Csres
    it = 0
    while True:
        resnorm = torch.max(torch.abs(resscale * residual))
        pCstep, pdot = P(Cstep)
        alpha = cdot / pdot
        if bool(resnorm <= tol):
            return lhs, it, _OK
        if it >= maxiter:
            return lhs, it, _ITER_LIMIT
        if bool(cdot <= 0):
            return lhs, it, _NOT_POSDEF
        if bool(pdot <= 0):
            return lhs, it, _PRECOND_NOT_POSDEF
        if not bool(torch.isfinite(alpha)):
            return lhs, it, _INF_NAN
        lhs = lhs + alpha * step
        residual = residual - alpha * Cstep
        sres = sres - alpha * pCstep
        Csres, cdot_n = C(sres)
        beta = cdot_n / cdot
        step = sres + beta * step
        Cstep = Csres + beta * Cstep
        cdot = cdot_n
        it += 1
        if it % RECHECK_EVERY == 0:
            sres, rsdot = P(residual)
            Csres, cdot = C(sres)
            stagnated = bool(rsdot >= rpn)
            rpn = rsdot
            if stagnated:       # the update of this trip stands
                return lhs, it, _NO_PROGRESS


def cr_solve(nmd: NormalMatrixDevice, W, invd, resscale, rhs, tol: float,
             maxiter: int):
    """K3: CR on (A W A') y = rhs with preconditioner 1/invd, on the device
    of `rhs`; on the card one cooperative launch. Returns (lhs, iterations,
    loop error code)."""
    if rhs.device.type == "cpu":
        return cr_solve_plain(nmd, W, invd, resscale, rhs, tol, maxiter)
    return kernels.CrStep(nmd.op_At, nmd.op_A, W, invd, resscale,
                          rhs).solve(maxiter, tol)


def _upload(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A host array as a contiguous tensor on `device`. The dtype is
    converted by numpy, so that no torch kernel runs on either side."""
    return torch.from_numpy(
        np.ascontiguousarray(x, dtype=NP_DTYPE[dtype])).to(device)


class DeviceNormalCR:
    """Per-factorization f64 device CR solver.

    KKTSolverDiag builds it when Parameters.precision is "f64". The
    reference builds it only when its mixed solver's constructor fails (a
    failed jax compile), whatever the parameter says."""

    inner_solve = staticmethod(cr_solve)

    def __init__(self, model: Model, W: np.ndarray, diag: np.ndarray,
                 resscale: np.ndarray, device: torch.device):
        self.model = model
        self.m = model.num_rows
        f64 = torch.float64
        self._nmd = NormalMatrixDevice.from_model(model, device, f64)
        self.device = device
        self._W = _upload(W, f64, device)
        self._invd = _upload(1.0 / np.asarray(diag, dtype=np.float64), f64,
                             device)
        self._resscale = _upload(resscale, f64, device)

    def solve(self, rhs: np.ndarray, tol: float, maxiter: int
              ) -> Tuple[np.ndarray, int, int, float, float]:
        """Returns (y, iters, errflag, total_time, matvec_time): the
        matvec time is not measured, since the applies run inside K3's
        launch, and is 0.0."""
        if maxiter < 0:
            maxiter = self.m + 100
        t0 = perf_counter()
        lhs, iters, err = self.inner_solve(
            self._nmd, self._W, self._invd, self._resscale,
            _upload(rhs, torch.float64, self.device), tol, maxiter)
        lhs = lhs.cpu().numpy()
        dt = perf_counter() - t0
        return lhs, iters, _ERRFLAG_MAP[err], dt, 0.0


class MixedPrecisionDeviceCR:
    """f32 device CR with f64 iterative refinement: each pass solves
    C dy = r with the whole CR loop on the device in float32, then the true
    residual r = rhs - C y is recomputed in float64 on the host, until the
    scaled infinity norm meets the f64 tolerance."""

    MAX_REFINEMENTS = 30
    # one f32 pass cannot reduce the scaled residual below ~1e-6 relative
    F32_FLOOR = 1e-5

    inner_solve = staticmethod(cr_solve)

    def __init__(self, model: Model, W: np.ndarray, diag: np.ndarray,
                 resscale: np.ndarray, host_apply=None, *,
                 device: torch.device):
        self.model = model
        self.m, self.n = model.num_rows, model.num_cols
        f32 = torch.float32
        self._nmd = NormalMatrixDevice.from_model(model, device, f32)
        self.device = device
        self._W32 = _upload(W, f32, device)
        # 1/diag taken in f32, as the reference does inside its program
        self._invd32 = _upload(
            1.0 / np.asarray(diag, dtype=np.float32), f32, device)
        self._resscale32 = _upload(resscale, f32, device)
        # f64 host-side data for the refinement residual
        self._W = np.asarray(W, dtype=np.float64)
        self._resscale = np.asarray(resscale, dtype=np.float64)
        self._host_apply = host_apply or self._default_host_apply

    def _default_host_apply(self, y: np.ndarray) -> np.ndarray:
        md = self.model
        return md.AI_mul(self._W * md.AIt_mul(y))

    def _snorm(self, r: np.ndarray) -> float:
        return float(np.max(np.abs(self._resscale * r), initial=0.0))

    def solve(self, rhs: np.ndarray, tol: float, maxiter: int
              ) -> Tuple[np.ndarray, int, int, float, float]:
        """Returns (y, iters, errflag, total_time, matvec_time): the
        matvec time is not measured, since the applies run inside K3's
        launch, and is 0.0."""
        if maxiter < 0:
            maxiter = self.m + 100
        t0 = perf_counter()
        rhs = np.asarray(rhs, dtype=np.float64)
        y = np.zeros(self.m)
        r = rhs.copy()
        iters_total = 0
        err = 0
        snorm = self._snorm(r)
        best_snorm = snorm
        for _ in range(self.MAX_REFINEMENTS):
            if snorm <= tol:
                break
            if iters_total >= maxiter:
                err = int(Errflag.CR_ITER_LIMIT)
                break
            inner_tol = max(tol, self.F32_FLOOR * snorm)
            dy, it, inner_err = self.inner_solve(
                self._nmd, self._W32, self._invd32, self._resscale32,
                _upload(r, torch.float32, self.device),
                float(np.float32(inner_tol)), maxiter - iters_total)
            iters_total += it
            y = y + dy.cpu().numpy().astype(np.float64)
            r = rhs - self._host_apply(y)
            new_snorm = self._snorm(r)
            if not np.isfinite(new_snorm):
                err = int(Errflag.CR_INF_OR_NAN)
                break
            if new_snorm > tol and new_snorm >= 0.9 * best_snorm:
                # refinement stalled above tolerance: no further f32 pass
                # can make progress
                err = _ERRFLAG_MAP[inner_err] or int(Errflag.CR_NO_PROGRESS)
                break
            best_snorm = min(best_snorm, new_snorm)
            snorm = new_snorm
        else:
            err = int(Errflag.CR_NO_PROGRESS)
        if snorm <= tol:
            err = 0
        dt = perf_counter() - t0
        return y, iters_total, err, dt, 0.0
