"""Shared-basis batched polish on a torch device (port of
ipx_tpu/parallel/batch2.py).

After the batched phase 1 (batch.py) has brought B scenarios to a loose
tolerance, the polish continues their IPM with the KKT solves
preconditioned by ONE basis shared across the batch: the basis of the mean
scenario, refreshed by maxvolume against the batch's central scaling
before every step.

What runs where:

* the IPM step is the port's BatchedPhase1Solver._ipm_step on the device
  that `device` names, with its kernels (K5, K8-K12 on the card) and its
  iterate kept on that device between steps;
* the normal-equations solve, SharedBasisBatchedCR with the optional
  per-scenario low-rank correction SharedBasisLowRank, runs on the host,
  imported from ipx_tpu: its blocked B / B' solves are native host code.
  Each solve copies W, resscale, the right-hand side and tol to the host
  and the float64 solution back;
* maxvolume refreshes the basis on the host, from K10's weights.

The reference ran the whole step on the host next to the native solves,
and so replaced the step's products by scipy ones; here the products stay
K5 on the device.
"""
from __future__ import annotations

import numpy as np
import torch

from ipx_tpu.basis.maxvolume import Maxvolume
from ipx_tpu.control import Control
from ipx_tpu.parallel.batch2 import SharedBasisBatchedCR, SharedBasisLowRank

from .batch import BatchedPhase1Solver

__all__ = ["SharedBasisBatchedCR", "SharedBasisLowRank",
           "SharedBasisBatchedPolish"]


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class SharedBasisBatchedPolish:
    """Batched phase-2 polish: continues a batch of scenario IPMs with
    basis-preconditioned KKT solves sharing one basis.

    device: where the step runs, with BatchedPhase1Solver's rule ("cuda"
    is the card or raises). solver_cls: the class of the inner batched
    solver; PlainBatchedPhase1Solver runs the same polish through the
    kernels' plain versions, as the reference of the card checks.

    Counters: correction_failures counts the CR solves whose low-rank
    correction failed its Cholesky factorization, refresh_failures the
    refreshes whose maxvolume or refactorization returned an error code;
    the reference let both pass silently. Either leaves the solve without
    the correction or the previous basis in place. The reference's bare
    excepts around the two are not carried over: any exception raises.
    corrected_solves
    counts the solves that ran with an active correction, step_cr the
    shared-basis CR iterations of each step, and mu_history the per-lane
    mu of the state run() starts from and after each step.
    """

    def __init__(self, blp, basis, feasibility_tol=1e-6,
                 optimality_tol=1e-8, kkt_tol=0.3, cr_maxiter=500,
                 maxiter=60, device="auto",
                 solver_cls=BatchedPhase1Solver):
        # cr_dtype "f64": the inner solver's own CR is never called, so no
        # float32 operands are built
        self._ph1 = solver_cls(
            blp, feasibility_tol=feasibility_tol,
            optimality_tol=optimality_tol, kkt_tol=kkt_tol,
            cr_maxiter=cr_maxiter, maxiter=maxiter, cr_dtype="f64",
            device=device)
        self._ph1._cr_solve = self._cr_solve
        self.device = self._ph1.device
        self.basis = basis
        self.maxiter = maxiter
        self.cr_maxiter = cr_maxiter
        self.total_cr_iters = 0
        self.step_cr = []
        self.mu_history = []
        self.correction_failures = 0
        self.refresh_failures = 0
        self.corrected_solves = 0
        self._use_correction = False
        # the shared basis must follow the batch's weight trajectory (the
        # single-LP phase 2 re-runs maxvolume every IPM iteration,
        # reference: src/kkt_solver_basis.cc:44-57)
        self._ctrl = Control()
        self._ctrl.parameters.display = 0
        self.basis_updates = 0

    # -- the KKT solve on the host ----------------------------------------------
    def _cr_solve(self, W, diag, resscale, RHS, tol):
        """SharedBasisBatchedCR in place of the inner solver's CR; `diag`
        (the Jacobi diagonal) is not used. Returns (Y on W's device,
        iterations)."""
        W_h = _host(W)
        cr = SharedBasisBatchedCR(self.basis, W_h, _host(resscale))
        if self._use_correction:
            corr = SharedBasisLowRank(self.basis, W_h, cr._D2)
            if corr.active:
                cr.correction = corr
                self.corrected_solves += 1
            elif hasattr(corr, "PU"):
                # its Cholesky factorization failed, and it switched
                # itself off
                self.correction_failures += 1
        Y, _, iters = cr.solve(_host(RHS), _host(tol), self.cr_maxiter)
        self.total_cr_iters += iters
        return torch.from_numpy(Y).to(W.device), iters

    def _weights_of(self, S) -> torch.Tensor:
        """Per-scenario KKT weights of a batched state: K10's W, the
        formula of BatchedPhase1Solver._ipm_step."""
        return self._ph1._prologue(S).W

    def _refresh_basis(self, S) -> None:
        """Maxvolume refresh of the shared basis against the batch's
        central scaling (the geometric mean of the per-scenario weights
        over the lanes not done), then a refactorization when the update
        machinery asks for one. An error code leaves the previous basis in
        place and is counted in refresh_failures."""
        active = ~_host(S["done"])
        if not active.any():
            return
        Wa = np.clip(_host(self._weights_of(S))[:, active], 1e-150, 1e150)
        colscale = np.sqrt(np.exp(np.mean(np.log(Wa), axis=1)))
        mv = Maxvolume(self._ctrl)
        if mv.run_heuristic(colscale, self.basis):
            self.refresh_failures += 1
            return
        self.basis_updates += mv.updates
        if (not self.basis.factorization_is_fresh
                and self.basis.lu.need_fresh_factorization()
                and self.basis.factorize() != 0):
            self.refresh_failures += 1

    # -------------------------------------------------------------------------
    def run(self, state):
        """Polishes a batched IPM state dict (X, XL, XU, Y, ZL, ZU, done,
        iters; numpy arrays or tensors) to the tolerances; returns numpy,
        with pobj and mu."""
        ph = self._ph1
        dev = self.device
        S = {k: torch.as_tensor(_host(state[k])).to(dev, copy=True)
             for k in ("X", "XL", "XU", "Y", "ZL", "ZU", "iters")}
        # the incoming done flags reflect the phase-1 tolerances; every
        # scenario is judged anew against this polish's tolerances
        B = S["X"].shape[1]
        S["done"] = torch.zeros(B, dtype=torch.bool, device=dev)
        # masked host arithmetic over infinite bounds, as in the reference
        with np.errstate(invalid="ignore", divide="ignore"):
            best_mu = _host(ph._mu_of(S)).copy()
            self.mu_history.append(best_mu.copy())
            since_improve = np.zeros(B, dtype=np.int64)   # per-lane stall
            for _ in range(self.maxiter):
                self._refresh_basis(S)
                before = self.total_cr_iters
                S = ph._ipm_step(S)
                self.step_cr.append(self.total_cr_iters - before)
                mu = _host(ph._mu_of(S)).copy()
                self.mu_history.append(mu)
                done = _host(S["done"])
                if bool(np.all(done)):
                    break
                # lanes stall one by one: an off-mean lane can plateau
                # while the rest still improve, so each is judged against
                # its own best complementarity
                active = ~done
                improved = mu < 0.9 * best_mu
                best_mu = np.minimum(best_mu, mu)
                since_improve = np.where(improved, 0, since_improve + 1)
                stalled = active & (since_improve >= 3)
                # first response to a stalling lane: the per-scenario
                # low-rank correction, and a fresh window for the lane
                if stalled.any() and not self._use_correction:
                    self._use_correction = True
                    since_improve[stalled] = 0
                # exit once every active lane has been flat for 15 steps
                # (the per-scenario finishes take those lanes)
                if active.any() and bool(
                        np.all(since_improve[active] >= 15)):
                    break
            out = {k: _host(v) for k, v in S.items()}
            out["pobj"] = np.sum(ph.lp.c.T * out["X"], axis=0)
            out["mu"] = self.mu_history[-1]
        return out
