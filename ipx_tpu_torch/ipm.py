"""Interior point method: Mehrotra predictor-corrector driver.

Counterpart of the reference IPM (reference: src/ipm.{h,cc}), a variant of
Mehrotra's predictor-corrector method [S. Mehrotra, SIAM J. Optim. 2 (1992)]
with two KKT solves per iteration:

 - starting-point procedure: two least-squares KKT solves plus positivity
   shifts (reference: src/ipm.cc:125-259);
 - predictor step from the affine-scaling direction, corrector with centering
   sigma = (muaff/mu)^3 (reference: src/ipm.cc:341-436);
 - Gondzio-style boundary buffer in the step sizes with gammaf = 0.9
   (reference: src/ipm.cc:438-518), steps capped at 1-1e-6;
 - divergence/no-progress detection: 5 consecutive bad steps (<0.05) or
   complementarity > 1e6 x best (reference: src/ipm.cc:66-99 and
   src/ipm.h:50-55);
 - adaptive CR tolerance kkt_tol * sqrt(mu) (reference: src/ipm.cc:572).

Everything is dense vector arithmetic over the iterate, vectorized numpy on
host; the heavy lifting (KKT solves) happens in the KKT solver which may run
on device.

The port's copy of ipx_tpu/ipm.py.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .control import Control
from .info import Info
from .iterate import Iterate
from .kkt.base import KKTSolver
from .status import Errflag, InterruptError, SolveStatus

try:
    from .native import veckernels as _VK
    if not _VK.available():
        _VK = None
except Exception:
    _VK = None

INF = np.inf

# IPM terminates when the complementarity gap exceeds kDivergeTol times the
# smallest gap of all iterates so far (reference: src/ipm.h:50-55).
DIVERGE_TOL = 1e6


@dataclasses.dataclass
class Step:
    x: np.ndarray
    xl: np.ndarray
    xu: np.ndarray
    y: np.ndarray
    zl: np.ndarray
    zu: np.ndarray

    @classmethod
    def zeros(cls, m: int, nm: int) -> "Step":
        return cls(x=np.zeros(nm), xl=np.zeros(nm), xu=np.zeros(nm),
                   y=np.zeros(m), zl=np.zeros(nm), zu=np.zeros(nm))


class IPM:
    def __init__(self, control: Control):
        self.control = control
        self.maxiter = -1
        self.kkt: Optional[KKTSolver] = None
        self.iterate: Optional[Iterate] = None
        self.info: Optional[Info] = None
        self.step_primal = 0.0
        self.step_dual = 0.0
        self.num_bad_iter = 0
        self.best_complementarity = 0.0
        # Phase-1-only trend switch (beyond-reference tuning): when set by
        # the orchestrator in auto switch mode, end phase 1 once the CR
        # iteration count per IPM iteration is large and has grown for
        # three consecutive iterations — the diag preconditioner is losing
        # and each further iteration roughly doubles in cost, while the
        # basis-preconditioned phase solves the same systems in O(10) iters.
        # (The reference waits for a hard per-solve cap of min(500, 10+m/20),
        # reference: src/lp_solver.cc:388-397, which with this framework's
        # cheap native matvec switches later than optimal.)
        self.phase1_trend_switch = False
        self._kkt_iter_hist: list = []
        self._prev_y = None
        # Called after each completed IPM iteration, at a point where the
        # (iterate, basis) pair is consistent; used by LpSolver for periodic
        # checkpoint writes (ipx_tpu/checkpoint.py).
        self.iteration_callback = None

    # ------------------------------------------------------------------
    def compute_starting_point(self, kkt: KKTSolver, iterate: Iterate,
                               info: Info) -> None:
        """reference: src/ipm.cc:25-41"""
        self.kkt = kkt
        self.iterate = iterate
        self.info = info
        self._print_header()
        try:
            self._compute_starting_point()
        except InterruptError as e:
            info.errflag = int(e.errflag)
        if info.errflag == 0:
            self._print_output()
        if info.errflag == int(Errflag.INTERRUPT_TIME):
            info.errflag = 0
            info.status_ipm = int(SolveStatus.TIME_LIMIT)
        elif info.errflag:
            info.status_ipm = int(SolveStatus.FAILED)
        else:
            info.status_ipm = int(SolveStatus.NOT_RUN)

    def load_starting_point(self, x, xl, xu, y, zl, zu, iterate: Iterate,
                            info: Info) -> None:
        """Repairs and loads a user-given starting point
        (reference: src/ipm.cc:261-316)."""
        self.kkt = None
        self.iterate = iterate
        self.info = info
        self._print_header()

        lb, ub = iterate.model.lb, iterate.model.ub
        xl = np.asarray(xl, dtype=float).copy()
        xu = np.asarray(xu, dtype=float).copy()
        zl = np.asarray(zl, dtype=float).copy()
        zu = np.asarray(zu, dtype=float).copy()

        finl0 = np.isfinite(lb)
        finu0 = np.isfinite(ub)
        prods_l = finl0 & (xl > 0.0) & (zl > 0.0)
        prods_u = finu0 & (xu > 0.0) & (zu > 0.0)
        num = int(prods_l.sum() + prods_u.sum())
        with np.errstate(invalid="ignore"):
            total = float((xl * zl)[prods_l].sum()
                          + (xu * zu)[prods_u].sum())
        mu = total / num if num else 1.0

        finl = np.isfinite(lb)
        both0 = finl & (xl == 0.0) & (zl == 0.0)
        xl[both0] = np.sqrt(mu)
        zl[both0] = np.sqrt(mu)
        x0 = finl & (xl == 0.0)
        xl[x0] = mu / zl[x0]
        z0 = finl & (zl == 0.0)
        zl[z0] = mu / xl[z0]

        finu = np.isfinite(ub)
        both0 = finu & (xu == 0.0) & (zu == 0.0)
        xu[both0] = np.sqrt(mu)
        zu[both0] = np.sqrt(mu)
        x0 = finu & (xu == 0.0)
        xu[x0] = mu / zu[x0]
        z0 = finu & (zu == 0.0)
        zu[z0] = mu / xu[z0]

        iterate.initialize(x, xl, xu, y, zl, zu)
        self.best_complementarity = iterate.complementarity()
        self._print_output()
        info.status_ipm = int(SolveStatus.NOT_RUN)

    # ------------------------------------------------------------------
    def driver(self, kkt: KKTSolver, iterate: Iterate, info: Info) -> None:
        """Main loop (reference: src/ipm.cc:56-123)."""
        md = iterate.model
        m, nm = md.num_rows, md.num_var_all
        self.kkt = kkt
        self.iterate = iterate
        self.info = info
        self.num_bad_iter = 0
        self._prev_y = None
        if self.best_complementarity == 0.0:
            self.best_complementarity = iterate.complementarity()

        while True:
            if iterate.term_crit_reached():
                info.status_ipm = int(SolveStatus.OPTIMAL)
                break
            if (self.num_bad_iter >= 5 or iterate.complementarity()
                    > DIVERGE_TOL * self.best_complementarity):
                # No progress in reducing the complementarity gap; classify
                # as infeasible via objective divergence, else no_progress.
                dualized = md.dualized
                pobj = iterate.pobjective_after_postproc()
                dobj = iterate.dobjective_after_postproc()
                if dobj > max(10.0 * abs(pobj), 1.0):
                    info.status_ipm = int(
                        SolveStatus.DUAL_INFEAS if dualized
                        else SolveStatus.PRIMAL_INFEAS)
                elif pobj < -max(10.0 * abs(dobj), 1.0):
                    info.status_ipm = int(
                        SolveStatus.PRIMAL_INFEAS if dualized
                        else SolveStatus.DUAL_INFEAS)
                else:
                    info.status_ipm = int(SolveStatus.NO_PROGRESS)
                break
            if self.maxiter >= 0 and info.iter >= self.maxiter:
                info.status_ipm = int(SolveStatus.ITER_LIMIT)
                break
            try:
                self.control.interrupt_check()
                kkt.factorize(iterate, info)
                if info.errflag:
                    break
                step = self._predictor()
                if info.errflag:
                    break
                self._add_corrector(step)
                if info.errflag:
                    break
            except InterruptError as e:
                info.errflag = int(e.errflag)
                break
            self._make_step(step)
            info.iter += 1
            self._print_output()
            if self.iteration_callback is not None:
                self.iteration_callback()
            if self.phase1_trend_switch:
                hist = self._kkt_iter_hist
                hist.append(kkt.iter)   # CR iters since this factorize
                # Fire once the count is large for the problem size AND has
                # grown >= 1.5x over the last three iterations AND is still
                # growing. (Strict 4-term monotonicity never fired on real
                # wobbly sequences; measured on transportation m=20k this
                # switches ~3 iterations earlier, saving ~45% of kktiter1
                # for a few extra cheap phase-2 iterations.)
                if (len(hist) >= 4 and hist[-1] > max(150, m // 96)
                        and hist[-1] > hist[-2]
                        and hist[-1] > 1.5 * hist[-4]):
                    info.status_ipm = int(SolveStatus.NO_PROGRESS)
                    break

        if info.errflag:
            if info.errflag == int(Errflag.INTERRUPT_TIME):
                info.errflag = 0
                info.status_ipm = int(SolveStatus.TIME_LIMIT)
            else:
                info.status_ipm = int(SolveStatus.FAILED)

    # ------------------------------------------------------------------
    def _compute_starting_point(self) -> None:
        """reference: src/ipm.cc:125-259"""
        iterate = self.iterate
        md = iterate.model
        m, n = md.num_rows, md.num_cols
        nm = n + m
        lb, ub, b, c = md.lb, md.ub, md.b, md.c
        info = self.info

        self.kkt.factorize(None, info)
        if info.errflag:
            return

        # x within bounds; dx = min-norm solution of AI dx = b - AI x.
        x = np.clip(0.0, lb, ub)
        rb = b - md.AI_mul(x)
        tol = 0.1 * _infnorm(rb)
        zeros = np.zeros(nm)
        dx, y = self.kkt.solve(zeros, rb, tol, info)
        if info.errflag:
            return
        x = x + dx

        # xl, xu shifted positive
        xl = x - lb
        xu = ub - x
        xinfeas = max(float(np.max(-xl, initial=0.0)),
                      float(np.max(-xu, initial=0.0)))
        xshift1 = 1.0 + 1.5 * xinfeas
        xl = xl + xshift1
        xu = xu + xshift1

        finl = np.isfinite(lb)
        finu = np.isfinite(ub)
        cnorm = float(np.linalg.norm(c))
        if cnorm == 0.0:
            # zero objective: unit duals at finite bounds; y keeps the value
            # from the min-norm primal solve above
            zl = np.where(finl, 1.0, 0.0)
            zu = np.where(finu, 1.0, 0.0)
        else:
            # y = least-squares solution of AI'y = c; zl = c - AI'y.
            rb0 = np.zeros(m)
            tol = 0.1 * _infnorm(c)
            _, y = self.kkt.solve(c, rb0, tol, info)
            if info.errflag:
                return
            zall = c - md.AIt_mul(y)

            # Keep the point away from near-complementarity when c is (close
            # to) in range(AI').
            znorm = float(np.linalg.norm(zall))
            rho = 0.05
            if znorm < rho * cnorm:
                zall = zall + rho * c
                y = (1.0 - rho) * y

            zl = np.zeros(nm)
            zu = np.zeros(nm)
            boxed = finl & finu
            zl[boxed] = 0.5 * zall[boxed]
            zu[boxed] = -0.5 * zall[boxed]
            onlyl = finl & ~finu
            zl[onlyl] = zall[onlyl]
            onlyu = ~finl & finu
            zu[onlyu] = -zall[onlyu]
            zinfeas = max(float(np.max(-zl, initial=0.0)),
                          float(np.max(-zu, initial=0.0)))
            zshift1 = 1.0 + 1.5 * zinfeas
            zl[finl] += zshift1
            zu[finu] += zshift1

        # Level pairwise complementarity products.
        xsum = 1.0 + float(xl[finl].sum() + xu[finu].sum())
        zsum = 1.0 + float(zl[finl].sum() + zu[finu].sum())
        with np.errstate(invalid="ignore"):
            mu = 1.0 + float((xl * zl)[finl].sum() + (xu * zu)[finu].sum())
        xshift2 = 0.5 * mu / zsum
        zshift2 = 0.5 * mu / xsum
        xl = xl + xshift2
        xu = xu + xshift2
        zl[finl] += zshift2
        zu[finu] += zshift2

        # variables without finite bound get xl/xu = inf, zl/zu = 0
        xl[~finl] = INF
        xu[~finu] = INF
        zl[~finl] = 0.0
        zu[~finu] = 0.0

        iterate.initialize(x, xl, xu, y, zl, zu)
        self.best_complementarity = iterate.complementarity()

    # ------------------------------------------------------------------
    def _predictor(self) -> Step:
        """reference: src/ipm.cc:341-371"""
        it = self.iterate
        blb = it.barrier_lb_mask
        bub = it.barrier_ub_mask
        with np.errstate(invalid="ignore"):
            sl = np.where(blb, -it.xl * it.zl, 0.0)
            su = np.where(bub, -it.xu * it.zu, 0.0)
        # Warm start from the previous iteration's combined direction: the
        # KKT matrix changes only through the barrier weights, so late
        # iterations' duals are strongly correlated (no reference
        # counterpart — the reference always starts CR from zero).
        y0 = -self._prev_y if self._prev_y is not None else None
        return self._solve_newton_system(it.rb(), it.rc(), it.rl(), it.ru(),
                                         sl, su, y0=y0)

    def _add_corrector(self, step: Step) -> None:
        """reference: src/ipm.cc:373-436"""
        it = self.iterate
        blb = it.barrier_lb_mask
        bub = it.barrier_ub_mask
        mu = it.mu()

        maxp = min(_step_to_boundary(it.xl, step.xl),
                   _step_to_boundary(it.xu, step.xu))
        maxd = min(_step_to_boundary(it.zl, step.zl),
                   _step_to_boundary(it.zu, step.zu))

        if _VK is not None:
            psum, num_finite = _VK.compl_products(
                it.state, it.xl, it.zl, it.xu, it.zu, step.xl, step.zl,
                step.xu, step.zu, maxp, maxd)
        else:
            with np.errstate(invalid="ignore"):
                prods_l = ((it.xl + maxp * step.xl)
                           * (it.zl + maxd * step.zl))[blb]
                prods_u = ((it.xu + maxp * step.xu)
                           * (it.zu + maxd * step.zu))[bub]
            num_finite = prods_l.size + prods_u.size
            psum = float(prods_l.sum() + prods_u.sum())
        # With no barrier terms left (all variables free/fixed) the centering
        # quantities are unused; guard the division.
        muaff = psum / max(num_finite, 1)
        ratio = muaff / mu if mu > 0.0 else 0.0
        sigma = ratio ** 3

        with np.errstate(invalid="ignore"):
            sl = np.where(blb, -it.xl * it.zl + sigma * mu
                          - step.xl * step.zl, 0.0)
            su = np.where(bub, -it.xu * it.zu + sigma * mu
                          - step.xu * step.zu, 0.0)
        # The corrector system is solved from the same residuals with the
        # centered complementarity rhs, yielding the FULL combined direction
        # which replaces the predictor step (Mehrotra's method).
        # Warm start the corrector from the predictor direction (they share
        # the KKT matrix and correlated right-hand sides; step.y holds the
        # negated KKT dual solution).
        corr = self._solve_newton_system(it.rb(), it.rc(), it.rl(), it.ru(),
                                         sl, su, y0=-step.y)
        if self.info.errflag:
            return
        step.x, step.xl, step.xu = corr.x, corr.xl, corr.xu
        step.y, step.zl, step.zu = corr.y, corr.zl, corr.zu

    def _step_sizes(self, step: Step) -> None:
        """reference: src/ipm.cc:438-518"""
        it = self.iterate
        blb = it.barrier_lb_mask
        bub = it.barrier_ub_mask
        gammaf = 0.9
        gammaa = 1.0 / (1.0 - gammaf)

        step_xl, block_xl = _step_to_boundary_idx(it.xl, step.xl)
        step_xu, block_xu = _step_to_boundary_idx(it.xu, step.xu)
        step_zl, block_zl = _step_to_boundary_idx(it.zl, step.zl)
        step_zu, block_zu = _step_to_boundary_idx(it.zu, step.zu)
        maxp = min(step_xl, step_xu)
        maxd = min(step_zl, step_zu)

        if _VK is not None:
            psum, num_finite = _VK.compl_products(
                it.state, it.xl, it.zl, it.xu, it.zu, step.xl, step.zl,
                step.xu, step.zu, maxp, maxd)
        else:
            with np.errstate(invalid="ignore"):
                prods_l = ((it.xl + maxp * step.xl)
                           * (it.zl + maxd * step.zl))[blb]
                prods_u = ((it.xu + maxp * step.xu)
                           * (it.zu + maxd * step.zu))[bub]
            num_finite = prods_l.size + prods_u.size
            psum = float(prods_l.sum() + prods_u.sum())
        mufull = psum / max(num_finite, 1)
        mufull /= gammaa

        alphap = 1.0
        alphad = 1.0
        if maxp < 1.0:
            if step_xl <= step_xu:
                j = block_xl
                buffer = mufull / (it.zl[j] + maxd * step.zl[j])
                alphap = (it.xl[j] - buffer) / (-step.xl[j])
            else:
                j = block_xu
                buffer = mufull / (it.zu[j] + maxd * step.zu[j])
                alphap = (it.xu[j] - buffer) / (-step.xu[j])
            alphap = min(max(alphap, gammaf * maxp), 1.0)
        if maxd < 1.0:
            if step_zl <= step_zu:
                j = block_zl
                buffer = mufull / (it.xl[j] + maxp * step.xl[j])
                alphad = (it.zl[j] - buffer) / (-step.zl[j])
            else:
                j = block_zu
                buffer = mufull / (it.xu[j] + maxp * step.xu[j])
                alphad = (it.zu[j] - buffer) / (-step.zu[j])
            alphad = min(max(alphad, gammaf * maxd), 1.0)
        self.step_primal = min(alphap, 1.0 - 1e-6)
        self.step_dual = min(alphad, 1.0 - 1e-6)

    def _make_step(self, step: Step) -> None:
        """reference: src/ipm.cc:520-531"""
        self._step_sizes(step)
        it = self.iterate
        self._prev_y = step.y      # warm start for the next predictor
        it.update(self.step_primal, step.x, step.xl, step.xu,
                  self.step_dual, step.y, step.zl, step.zu)
        if min(self.step_primal, self.step_dual) < 0.05:
            self.num_bad_iter += 1
        else:
            self.num_bad_iter = 0
        self.best_complementarity = min(self.best_complementarity,
                                        it.complementarity())

    # ------------------------------------------------------------------
    def _solve_newton_system(self, rb, rc, rl, ru, sl, su,
                             y0=None) -> Step:
        """Reduce the 6-block Newton system to KKT form, solve, recover, and
        shift the residual into the last two block equations
        (reference: src/ipm.cc:532-645)."""
        it = self.iterate
        md = it.model
        m, n = md.num_rows, md.num_cols
        nm = n + m
        info = self.info
        blb = it.barrier_lb_mask
        bub = it.barrier_ub_mask
        fixed = it.fixed_mask
        free = it.free_mask

        rlv = rl if rl is not None else np.zeros(nm)
        ruv = ru if ru is not None else np.zeros(nm)
        rcv0 = rc if rc is not None else np.zeros(nm)
        if _VK is not None:
            rhs1 = _VK.newton_rhs1(it.state, rcv0, rlv, ruv, sl, su,
                                   it.xl, it.xu, it.zl, it.zu)
        else:
            rhs1 = -rcv0.copy()
            with np.errstate(invalid="ignore"):
                rhs1 = np.where(blb, rhs1 + (sl + it.zl * rlv) / it.xl,
                                rhs1)
                rhs1 = np.where(bub, rhs1 - (su - it.zu * ruv) / it.xu,
                                rhs1)
            rhs1[fixed] = 0.0
        rhs2 = rb.copy() if rb is not None else np.zeros(m)

        tol = self.control.parameters.kkt_tol * np.sqrt(it.mu())
        dx, dy = self.kkt.solve(rhs1, rhs2, tol, info, y0)
        step = Step.zeros(m, nm)
        if info.errflag:
            return step
        dy = -dy
        step.x = dx
        step.y = dy

        atdy = md.AIt_mul(dy)
        if _VK is not None:
            dxl, dxu, dzl, dzu = _VK.newton_recover(
                it.state, dx, atdy, rcv0, rlv, ruv, sl, su,
                it.xl, it.xu, it.zl, it.zu)
        else:
            barrier = ~fixed & ~free
            dxl = np.where(barrier, dx - rlv, 0.0)
            with np.errstate(invalid="ignore"):
                dzl = np.where(barrier, (sl - it.zl * dxl) / it.xl, 0.0)
            dxu = np.where(barrier, ruv - dx, 0.0)
            with np.errstate(invalid="ignore"):
                dzu = np.where(barrier, (su - it.zu * dxu) / it.xu, 0.0)

            # Shift residual of the first KKT block into dzl/dzu.
            rcv = rcv0
            finxl = np.isfinite(it.xl)
            finxu = np.isfinite(it.xu)
            with np.errstate(invalid="ignore"):
                lower_side = it.zl * it.xu >= it.zu * it.xl
            use_l = barrier & finxl & (~finxu | lower_side)
            use_u = barrier & finxu & ~use_l
            dzl = np.where(use_l, rcv + dzu - atdy, dzl)
            dzu = np.where(use_u, -rcv + dzl + atdy, dzu)

        step.xl = dxl
        step.xu = dxu
        step.zl = dzl
        step.zu = dzu
        return step

    # ------------------------------------------------------------------
    def _print_header(self) -> None:
        self.control.log(
            " Iter   P.res    D.res           P.obj           D.obj"
            "        mu     Time\n")

    def _print_output(self) -> None:
        it = self.iterate
        info = self.info
        opt = "*" if (it.feasible() and it.optimal()) else " "
        self.control.log(
            f" {info.iter:3d}{opt} "
            f" {it.presidual():8.2e} {it.dresidual():8.2e} "
            f" {it.pobjective_after_postproc():15.8e} "
            f"{it.dobjective_after_postproc():15.8e} "
            f" {it.mu():8.2e} {self.control.elapsed():6.0f}s\n")
        if self.control.parameters.debug >= 1:
            kkt = self.kkt
            self.control.debug(
                f"   steps {self.step_primal:4.2f} {self.step_dual:4.2f}"
                f"  pivots {kkt.basis_changes if kkt else 0:7d}"
                f"  kktiter {kkt.iter if kkt else 0:7d}"
                f"  P.fixed {info.dual_dropped:7d}"
                f"  D.fixed {info.primal_dropped:7d}\n")
        if (self.control.parameters.debug >= 4 and self.kkt is not None
                and self.kkt.basis is not None):
            # svdmin(B) and structural density of inv(B)
            # (reference: src/ipm.cc:676-689)
            from time import perf_counter
            basis = self.kkt.basis
            svdmin = basis.min_singular_value()
            t0 = perf_counter()
            density = basis.density_inverse()
            info.time_symb_invert += perf_counter() - t0
            self.control.debug(
                f"   svdmin(B) {svdmin:9.2e}  density {density:8.2e}\n", 4)


def _step_to_boundary(x: np.ndarray, dx: np.ndarray) -> float:
    """Max alpha <= 1 with x + alpha*dx >= 0 (reference: src/ipm.cc:319-339).
    Entries with x == inf never block."""
    alpha, _ = _step_to_boundary_idx(x, dx)
    return alpha


def _step_to_boundary_idx(x: np.ndarray, dx: np.ndarray):
    if _VK is not None and x.size:
        alpha, j = _VK.step_boundary(x, dx)
        return alpha, j
    damp = 1.0 - np.finfo(float).eps
    with np.errstate(invalid="ignore", divide="ignore"):
        cand = np.where(dx < 0.0, -(x * damp) / dx, INF)
    cand = np.where(np.isfinite(x), cand, INF)
    if cand.size == 0:
        return 1.0, -1
    j = int(np.argmin(cand))
    alpha = float(cand[j])
    if alpha >= 1.0:
        return 1.0, -1
    return alpha, j


def _infnorm(v: np.ndarray) -> float:
    return float(np.max(np.abs(v))) if v.size else 0.0
