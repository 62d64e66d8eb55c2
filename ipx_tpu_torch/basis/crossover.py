"""Crossover to a vertex (basic) solution.

Counterpart of the reference crossover (reference: src/crossover.{h,cc}):
dual push phase followed by primal push phase (push_all), ordering pushes by
the IPM scaling factors (dual increasing, primal decreasing, reference:
src/lp_solver.cc:478-488). Each push runs a two-pass ratio test — first pass
expands the step by the feasibility tolerance, second pass maximizes the
pivot among blocking candidates (reference: src/crossover.cc:359-465).

The port's copy of ipx_tpu/basis/crossover.py.
"""
from __future__ import annotations

from time import perf_counter
from typing import List, Optional

import numpy as np

from ..control import Control
from ..info import Info
from ..status import Errflag, InterruptError, SolveStatus
from .basis import Basis
from .indexed_vector import IndexedVector

PIVOT_ZERO_TOL = 1e-5      # reference: src/crossover.h:137
INF = np.inf


def _xover_native_ctx(basis: Basis):
    """Binds the model to the native kernel for the whole-push-loop driver.
    Returns (lib, handle) or None when the native kernel is unavailable."""
    lu = basis.lu
    lib = getattr(lu, "lib", None)
    handle = getattr(lu, "handle", None)
    if lib is None or not handle:
        return None
    md = basis.model
    try:
        import ctypes as ct
        I = ct.c_int64
        D = ct.c_double
        P_ = ct.c_void_p
        IA = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        DA = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        if not hasattr(lib, "_xover_ready"):
            lib.ipxlu_model_bind.argtypes = [P_, I, IA, IA, DA, IA, IA, DA]
            common = [D, D, IA, IA, DA, DA, I, IA]
            lib.ipxlu_xover_dual.restype = I
            lib.ipxlu_xover_dual.argtypes = \
                [P_, IA, IA, DA, DA, IA, IA, I, IA] + common
            lib.ipxlu_xover_primal.restype = I
            lib.ipxlu_xover_primal.argtypes = \
                [P_, IA, IA, DA, DA, DA, DA, DA, DA, IA, I, IA] + common
            lib._xover_ready = True
        if not hasattr(md, "_native_csc"):
            A = md.A
            md._native_csc = (
                np.ascontiguousarray(A.indptr, dtype=np.int64),
                np.ascontiguousarray(A.indices, dtype=np.int64),
                np.ascontiguousarray(A.data, dtype=np.float64))
        if not hasattr(md, "_native_csr"):
            R = md.A_csr
            md._native_csr = (
                np.ascontiguousarray(R.indptr, dtype=np.int64),
                np.ascontiguousarray(R.indices, dtype=np.int64),
                np.ascontiguousarray(R.data, dtype=np.float64))
        Ap, Ai, Ax = md._native_csc
        ARp, ARi, ARx = md._native_csr
        lib.ipxlu_model_bind(handle, md.num_cols, Ap, Ai, Ax,
                             ARp, ARi, ARx)
        return lib, handle
    except Exception:
        return None


class _PushDriver:
    """Shared chunked-call driver for the native push loops: calls the
    native function in ~1 s chunks, interleaving interval logging and
    interrupt checks, and syncs basis statistics afterwards."""

    FILLS_CAP = 256

    def __init__(self, control: Control, basis: Basis):
        self.control = control
        self.basis = basis
        self.ic = np.zeros(8, dtype=np.int64)
        self.dc = np.zeros(4, dtype=np.float64)
        self.fills = np.zeros(self.FILLS_CAP, dtype=np.float64)
        self.nfills = np.zeros(1, dtype=np.int64)
        self.next_i = np.zeros(1, dtype=np.int64)
        self.fresh = np.array(
            [1 if basis.factorization_is_fresh else 0], dtype=np.int64)

    def run(self, call, nvars: int, label: str, info: Info) -> None:
        """call(pause_abs) -> native return code."""
        import time as _t
        while True:
            ret = int(call(_t.monotonic() + 1.0))
            self.basis.fill_factors.extend(
                self.fills[:int(self.nfills[0])].tolist())
            if ret == 3:
                self.control.interval_log(
                    f" {nvars - int(self.next_i[0]):8d} {label} pushes "
                    f"remaining ({int(self.ic[1]):7d} pivots)\n")
                try:
                    self.control.interrupt_check()
                except InterruptError:
                    info.errflag = int(Errflag.INTERRUPT_TIME)
                    break
                continue
            if ret != 0:
                info.errflag = int(ret)
            break
        self._sync()

    def _sync(self) -> None:
        b = self.basis
        ic, dc = self.ic, self.dc
        b.num_ftran += int(ic[2])
        b.num_ftran_sparse += int(ic[3])
        b.num_btran += int(ic[4])
        b.num_btran_sparse += int(ic[5])
        b.num_updates += int(ic[6])
        b.num_factorizations += int(ic[7])
        b.time_ftran += float(dc[0])
        b.time_btran += float(dc[1])
        b.time_update += float(dc[2])
        b.time_factorize += float(dc[3])
        b.factorization_is_fresh = bool(self.fresh[0])
        b.lu._pivottol = float(b.lu.lib.ipxlu_get_pivottol(b.lu.handle))


class Crossover:
    def __init__(self, control: Control):
        self.control = control
        self.primal_pushes = 0
        self.primal_pivots = 0
        self.dual_pushes = 0
        self.dual_pivots = 0
        self.time_primal = 0.0
        self.time_dual = 0.0

    # ------------------------------------------------------------------
    def push_all(self, basis: Basis, x: np.ndarray, y: np.ndarray,
                 z: np.ndarray, weights: np.ndarray, info: Info) -> None:
        """reference: src/crossover.cc:15-71"""
        md = basis.model
        m, n = md.num_rows, md.num_cols
        lb, ub = md.lb, md.ub
        tl = Control.textline
        perm = np.argsort(weights, kind="stable")

        self.control.log(
            tl("Primal residual before push phase:")
            + f"{md.primal_residual(x):.2e}\n"
            + tl("Dual residual before push phase:")
            + f"{md.dual_residual(y, z):.2e}\n")

        # dual pushes: basic variables with z != 0, increasing weight
        basic = basis.basic_mask()
        sel = basic[perm] & (z[perm] != 0.0)
        dual_superbasics = perm[sel]
        info.pushes_dual = int(dual_superbasics.size)
        self.control.log(
            tl("Number of dual pushes required:")
            + f"{dual_superbasics.size}\n")
        self.push_dual_from_x(basis, y, z, dual_superbasics, x, info)
        if info.status_crossover != int(SolveStatus.OPTIMAL):
            return

        # primal pushes: nonbasic strictly interior, decreasing weight
        nonbasic = basis.nonbasic_mask()
        rp = perm[::-1]
        sel = (nonbasic[rp] & (x[rp] != lb[rp]) & (x[rp] != ub[rp])
               & ~(np.isinf(lb[rp]) & np.isinf(ub[rp]) & (x[rp] == 0.0)))
        primal_superbasics = rp[sel]
        info.pushes_primal = int(primal_superbasics.size)
        self.control.log(
            tl("Number of primal pushes required:")
            + f"{primal_superbasics.size}\n")
        self.push_primal_restricted(basis, x, primal_superbasics, z, info)
        if info.status_crossover != int(SolveStatus.OPTIMAL):
            return

        self.control.debug(
            tl("Primal residual after push phase:")
            + f"{md.primal_residual(x):.2e}\n"
            + tl("Dual residual after push phase:")
            + f"{md.dual_residual(y, z):.2e}\n")
        info.status_crossover = int(SolveStatus.OPTIMAL)

    # ------------------------------------------------------------------
    def push_primal_restricted(self, basis, x, variables, z, info):
        """Primal push with variables having z!=0 fixed at their bound
        (reference: src/crossover.cc:223-228)."""
        self.push_primal(basis, x, variables, z != 0.0, info)

    def push_primal(self, basis: Basis, x: np.ndarray, variables,
                    fixed_at_bound: Optional[np.ndarray], info: Info) -> None:
        """reference: src/crossover.cc:73-221"""
        t0 = perf_counter()
        md = basis.model
        m, n = md.num_rows, md.num_cols
        lb, ub = md.lb, md.ub
        ftran = IndexedVector(m)
        params = self.control.parameters
        feastol = (params.dfeasibility_tol if md.dualized
                   else params.pfeasibility_tol)
        self.primal_pushes = 0
        self.primal_pivots = 0
        info.errflag = 0

        for j in variables:
            if not basis.is_nonbasic(int(j)):
                raise RuntimeError("invalid variable in push_primal")
        if np.any((x < lb) | (x > ub)):
            raise RuntimeError("bound condition violated in push_primal")

        xbasic = x[basis.basis].copy()
        lbbasic = lb[basis.basis].copy()
        ubbasic = ub[basis.basis].copy()
        if fixed_at_bound is not None:
            fb = fixed_at_bound[basis.basis]
            lbbasic[fb] = xbasic[fb]
            ubbasic[fb] = xbasic[fb]

        self.control.reset_print_interval()
        ctx = _xover_native_ctx(basis)
        if ctx is not None:
            lib, handle = ctx
            drv = _PushDriver(self.control, basis)
            vars64 = np.ascontiguousarray(variables, dtype=np.int64)
            nvars = int(vars64.size)
            x_ = np.ascontiguousarray(x)
            lb_ = np.ascontiguousarray(lb, dtype=np.float64)
            ub_ = np.ascontiguousarray(ub, dtype=np.float64)
            drv.run(lambda pause: lib.ipxlu_xover_primal(
                handle, basis.basis, basis.map2basis, x_, xbasic, lbbasic,
                ubbasic, lb_, ub_, vars64, nvars, drv.next_i, feastol,
                pause, drv.fresh, drv.ic, drv.dc, drv.fills,
                drv.FILLS_CAP, drv.nfills), nvars, "primal", info)
            if x_ is not x:
                x[:] = x_
            x[basis.basis] = xbasic
            self.primal_pushes = int(drv.ic[0])
            self.primal_pivots = int(drv.ic[1])
            self._set_status(info)
            self.time_primal = perf_counter() - t0
            return
        next_i = 0
        nvars = len(variables)
        while next_i < nvars:
            try:
                self.control.interrupt_check()
            except InterruptError:
                info.errflag = int(Errflag.INTERRUPT_TIME)
                break

            jn = int(variables[next_i])
            if (x[jn] == lb[jn] or x[jn] == ub[jn]
                    or (x[jn] == 0.0 and np.isinf(lb[jn])
                        and np.isinf(ub[jn]))):
                next_i += 1
                continue

            # bound to push to: nearer finite bound, or zero if none
            move_to = 0.0
            if np.isfinite(lb[jn]) and np.isfinite(ub[jn]):
                move_to = lb[jn] if x[jn] - lb[jn] <= ub[jn] - x[jn] \
                    else ub[jn]
            elif np.isfinite(lb[jn]):
                move_to = lb[jn]
            elif np.isfinite(ub[jn]):
                move_to = ub[jn]
            step = x[jn] - move_to

            basis.solve_for_update(jn, ftran)
            pblock, block_at_lb, step = self._primal_ratio_test(
                xbasic, ftran, lbbasic, ubbasic, step, feastol)
            jb = int(basis.basis[pblock]) if pblock >= 0 else -1

            if pblock >= 0:
                pivot = ftran.values[pblock]
                assert pivot != 0.0
                if abs(pivot) < 1e-4:
                    self.control.debug(
                        f" |pivot| = {abs(pivot):.2e}\n", 3)
                info.errflag, exchanged = basis.exchange_if_stable(
                    jb, jn, pivot, -1)
                if info.errflag:
                    self.control.debug(
                        Control.textline(
                            "Minimum singular value of basis matrix:")
                        + f"{basis.min_singular_value():.2e}\n")
                    break
                if not exchanged:
                    continue
                self.primal_pivots += 1
                if block_at_lb:
                    step = (lbbasic[pblock] - xbasic[pblock]) / pivot
                else:
                    step = (ubbasic[pblock] - xbasic[pblock]) / pivot

            if step != 0.0:
                nz = ftran.nonzero_indices()
                xb = xbasic[nz] + step * ftran.values[nz]
                xbasic[nz] = np.clip(xb, lbbasic[nz], ubbasic[nz])
                x[jn] -= step

            if pblock >= 0:
                x[jb] = lbbasic[pblock] if block_at_lb else ubbasic[pblock]
                xbasic[pblock] = x[jn]
                lbbasic[pblock] = lb[jn]
                ubbasic[pblock] = ub[jn]
            else:
                x[jn] = move_to

            self.primal_pushes += 1
            next_i += 1
            self.control.interval_log(
                f" {nvars - next_i:8d} primal pushes remaining"
                f" ({self.primal_pivots:7d} pivots)\n")

        x[basis.basis] = xbasic
        self._set_status(info)
        self.time_primal = perf_counter() - t0

    # ------------------------------------------------------------------
    def push_dual_from_x(self, basis, y, z, variables, x, info):
        """Builds sign restrictions from x (reference:
        src/crossover.cc:342-358): z[j] >= 0 allowed iff x[j] != ub[j],
        z[j] <= 0 allowed iff x[j] != lb[j]."""
        md = basis.model
        lb, ub = md.lb, md.ub
        sign_restrict = np.zeros(md.num_var_all, dtype=np.int64)
        sign_restrict[x != ub] |= 1
        sign_restrict[x != lb] |= 2
        self.push_dual(basis, y, z, variables, sign_restrict, info)

    def push_dual(self, basis: Basis, y: np.ndarray, z: np.ndarray,
                  variables, sign_restrict: np.ndarray, info: Info) -> None:
        """reference: src/crossover.cc:229-340"""
        t0 = perf_counter()
        md = basis.model
        m, n = md.num_rows, md.num_cols
        btran = IndexedVector(m)
        row = IndexedVector(n + m)
        params = self.control.parameters
        feastol = (params.pfeasibility_tol if md.dualized
                   else params.dfeasibility_tol)
        self.dual_pushes = 0
        self.dual_pivots = 0
        info.errflag = 0

        for j in variables:
            if not basis.is_basic(int(j)):
                raise RuntimeError("invalid variable in push_dual")
        bad = (((sign_restrict & 1) != 0) & (z < 0.0)) \
            | (((sign_restrict & 2) != 0) & (z > 0.0))
        if np.any(bad):
            raise RuntimeError("sign condition violated in push_dual")

        self.control.reset_print_interval()
        ctx = _xover_native_ctx(basis)
        if ctx is not None:
            lib, handle = ctx
            drv = _PushDriver(self.control, basis)
            vars64 = np.ascontiguousarray(variables, dtype=np.int64)
            sr64 = np.ascontiguousarray(sign_restrict, dtype=np.int64)
            nvars = int(vars64.size)
            y_ = np.ascontiguousarray(y)
            z_ = np.ascontiguousarray(z)
            drv.run(lambda pause: lib.ipxlu_xover_dual(
                handle, basis.basis, basis.map2basis, y_, z_, sr64,
                vars64, nvars, drv.next_i, feastol, pause, drv.fresh,
                drv.ic, drv.dc, drv.fills, drv.FILLS_CAP, drv.nfills),
                nvars, "dual", info)
            if y_ is not y:
                y[:] = y_
            if z_ is not z:
                z[:] = z_
            self.dual_pushes = int(drv.ic[0])
            self.dual_pivots = int(drv.ic[1])
            self._set_status(info)
            self.time_dual = perf_counter() - t0
            return
        next_i = 0
        nvars = len(variables)
        while next_i < nvars:
            try:
                self.control.interrupt_check()
            except InterruptError:
                info.errflag = int(Errflag.INTERRUPT_TIME)
                break

            jb = int(variables[next_i])
            if z[jb] == 0.0:
                next_i += 1
                continue

            # y := y + step*btran, z := z - step*row, z[jb] -= step
            basis.tableau_row(jb, btran, row)
            step = z[jb]
            jn, step = self._dual_ratio_test(z, row, sign_restrict, step,
                                             feastol)

            if jn >= 0:
                assert basis.is_nonbasic(jn)
                pivot = row.values[jn]
                assert pivot != 0.0
                if abs(pivot) < 1e-4:
                    self.control.debug(
                        f" |pivot| = {abs(pivot):.2e}\n", 3)
                info.errflag, exchanged = basis.exchange_if_stable(
                    jb, jn, pivot, 1)
                if info.errflag:
                    self.control.debug(
                        Control.textline(
                            "Minimum singular value of basis matrix:")
                        + f"{basis.min_singular_value():.2e}\n")
                    break
                if not exchanged:
                    continue
                self.dual_pivots += 1
                step = z[jn] / row.values[jn]

            if step != 0.0:
                bnz = btran.nonzero_indices()
                y[bnz] += step * btran.values[bnz]
                rnz = row.nonzero_indices()
                znew = z[rnz] - step * row.values[rnz]
                pos = (sign_restrict[rnz] & 1) != 0
                neg = (sign_restrict[rnz] & 2) != 0
                znew = np.where(pos, np.maximum(znew, 0.0), znew)
                znew = np.where(neg, np.minimum(znew, 0.0), znew)
                z[rnz] = znew
                z[jb] -= step

            if jn >= 0:
                z[jn] = 0.0
            else:
                assert z[jb] == 0.0

            self.dual_pushes += 1
            next_i += 1
            self.control.interval_log(
                f" {nvars - next_i:8d} dual pushes remaining"
                f" ({self.dual_pivots:7d} pivots)\n")

        self._set_status(info)
        self.time_dual = perf_counter() - t0

    # ------------------------------------------------------------------
    def _primal_ratio_test(self, xbasic, ftran: IndexedVector, lbbasic,
                           ubbasic, step, feastol):
        """Two-pass ratio test (reference: src/crossover.cc:359-416).
        Returns (pblock, block_at_lb, step)."""
        nz = ftran.nonzero_indices()
        piv = ftran.values[nz]
        big = np.abs(piv) > PIVOT_ZERO_TOL
        nzb = nz[big]
        pivb = piv[big]
        if nzb.size == 0:
            return -1, True, step

        # First pass: expand step by feastol, sequential semantics preserved
        # via iterative tightening (vectorized fixed-point: compute blocking
        # constraints for current step until stable).
        pblock = -1
        block_at_lb = True
        while True:
            xb_new = xbasic[nzb] + step * pivb
            viol_lb = xb_new < lbbasic[nzb] - feastol
            viol_ub = xb_new > ubbasic[nzb] + feastol
            if not (np.any(viol_lb) or np.any(viol_ub)):
                break
            steps_lb = np.where(viol_lb,
                                (lbbasic[nzb] - xbasic[nzb] - feastol)
                                / pivb, np.nan)
            steps_ub = np.where(viol_ub,
                                (ubbasic[nzb] - xbasic[nzb] + feastol)
                                / pivb, np.nan)
            # the binding step is the smallest in magnitude
            allsteps = np.where(np.isnan(steps_lb), steps_ub, steps_lb)
            k = int(np.nanargmin(np.abs(allsteps)))
            new_step = float(allsteps[k])
            if pblock >= 0 and not abs(new_step) < abs(step):
                break      # no progress (floating-point boundary case)
            step = new_step
            pblock = int(nzb[k])
            block_at_lb = bool(viol_lb[k])
        if pblock < 0:
            return -1, True, step

        # Second pass: maximum pivot among all that block within step
        # (vectorized argmax; ties resolve to the first index like the
        # reference's strict-improvement scan).
        with np.errstate(divide="ignore", invalid="ignore"):
            down = step * pivb < 0.0     # moves toward lower bound
            step_lb = (lbbasic[nzb] - xbasic[nzb]) / pivb
            step_ub = (ubbasic[nzb] - xbasic[nzb]) / pivb
        cand_lb = down & (np.abs(step_lb) <= abs(step))
        cand_ub = ~down & (step * pivb > 0.0) \
            & (np.abs(step_ub) <= abs(step))
        apiv = np.abs(pivb)
        ok = (cand_lb | cand_ub) & (apiv > PIVOT_ZERO_TOL)
        assert np.any(ok)
        best = int(np.argmax(np.where(ok, apiv, -1.0)))
        block_at_lb = bool(cand_lb[best])
        return int(nzb[best]), block_at_lb, step

    def _dual_ratio_test(self, z, row: IndexedVector, sign_restrict, step,
                         feastol):
        """Two-pass dual ratio test (reference: src/crossover.cc:418-465).
        Returns (jblock, step)."""
        nz = row.nonzero_indices()
        piv = row.values[nz]
        big = np.abs(piv) > PIVOT_ZERO_TOL
        nzb = nz[big]
        pivb = piv[big]
        if nzb.size == 0:
            return -1, step

        pos = (sign_restrict[nzb] & 1) != 0
        neg = (sign_restrict[nzb] & 2) != 0
        jblock = -1
        while True:
            znew = z[nzb] - step * pivb
            viol_pos = pos & (znew < -feastol)
            viol_neg = neg & (znew > feastol)
            if not (np.any(viol_pos) or np.any(viol_neg)):
                break
            steps_pos = np.where(viol_pos, (z[nzb] + feastol) / pivb, np.nan)
            steps_neg = np.where(viol_neg, (z[nzb] - feastol) / pivb, np.nan)
            allsteps = np.where(np.isnan(steps_pos), steps_neg, steps_pos)
            k = int(np.nanargmin(np.abs(allsteps)))
            new_step = float(allsteps[k])
            if jblock >= 0 and not abs(new_step) < abs(step):
                break      # no progress (floating-point boundary case)
            step = new_step
            jblock = int(nzb[k])
        if jblock < 0:
            return -1, step

        with np.errstate(divide="ignore", invalid="ignore"):
            ratio_ok = np.abs(z[nzb] / pivb) <= abs(step)
        sp = step * pivb
        cand = ratio_ok & ((pos & (sp > 0.0)) | (neg & (sp < 0.0)))
        apiv = np.abs(pivb)
        ok = cand & (apiv > PIVOT_ZERO_TOL)
        assert np.any(ok)
        jblock = int(nzb[int(np.argmax(np.where(ok, apiv, -1.0)))])
        return jblock, step

    def _set_status(self, info: Info) -> None:
        if info.errflag == int(Errflag.INTERRUPT_TIME):
            info.errflag = 0
            info.status_crossover = int(SolveStatus.TIME_LIMIT)
        elif info.errflag != 0:
            info.status_crossover = int(SolveStatus.FAILED)
        else:
            info.status_crossover = int(SolveStatus.OPTIMAL)
