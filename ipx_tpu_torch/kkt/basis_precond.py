"""Phase-2 KKT solver: basis-preconditioned conjugate residuals.

Counterpart of the reference basis KKT solver (reference:
src/kkt_solver_basis.{h,cc}), implementing the basis preconditioning
algorithm of Schork & Gondzio [L. Schork, "Basis Preconditioning in Interior
Point Methods", PhD thesis (2018), Section 6.4].

Per-iteration Factorize = DropPrimal (pivot near-bound basic variables out or
mark implied) + DropDual (pivot near-zero-dual nonbasic variables in or fix)
+ maxvolume refresh + refactorize + prepare the splitted operator
(reference: src/kkt_solver_basis.cc:20-67). Solve reduces the KKT system to
preconditioned normal equations, handling BASIC_FREE variables via extra
B/B' solves (reference: src/kkt_solver_basis.cc:75-194).

The port's copy of ipx_tpu/kkt/basis_precond.py. Its device branches are
the port's: _prepare_sharded builds the column-blocked N N' of
parallel/sharding.py when Parameters.shards > 1, _prepare_device otherwise
the device splitted CR (ops/device_cr2.py) for Parameters.device "cuda"
and "torch_cpu". A failure in either raises: there is no host fallback.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..basis.basis import BASIC, BASIC_FREE, NONBASIC, Basis
from ..basis.indexed_vector import IndexedVector
from ..basis.maxvolume import Maxvolume
from ..control import Control
from ..info import Info
from .. import backend
from ..model import Model
from ..ops.device_cr2 import DeviceSplittedCR
from ..parallel.sharding import ShardedPhase2CR, ShardedSplittedNNt
from .base import KKTSolver
from .cr import ConjugateResiduals
from .splitted_normal import SplittedNormalMatrix

PIVOT_ZERO_TOL = 1e-7      # reference: src/kkt_solver_basis.h:33
INF = np.inf


def _drop_native_ctx(basis: Basis):
    """Binds the model + registers the native drop-loop drivers.
    Returns (lib, handle) or None."""
    from ..basis.crossover import _xover_native_ctx
    ctx = _xover_native_ctx(basis)
    if ctx is None:
        return None
    lib, handle = ctx
    if not hasattr(lib, "_drop_ready"):
        import ctypes as ct
        I = ct.c_int64
        D = ct.c_double
        P_ = ct.c_void_p
        IA = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        DA = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        tail = [IA, I, IA, D, D, IA, IA, IA, IA, DA, DA, I, IA]
        lib.ipxlu_drop_primal.restype = I
        lib.ipxlu_drop_primal.argtypes = \
            [P_, IA, IA, DA, DA, DA, DA, DA] + tail
        lib.ipxlu_drop_dual.restype = I
        lib.ipxlu_drop_dual.argtypes = [P_, IA, IA, DA] + tail
        lib._drop_ready = True
    return lib, handle


class KKTSolverBasis(KKTSolver):
    def __init__(self, control: Control, basis: Basis):
        self.control = control
        self.basis = basis
        self.model: Model = basis.model
        self.splitted = SplittedNormalMatrix(self.model)
        nm = self.model.num_var_all
        self.colscale = np.zeros(nm)
        self.maxiter = -1
        self._iters = 0
        self.changes = 0
        self.factorized = False
        # Adaptive maxvolume tolerance (no reference counterpart — the
        # reference uses the fixed parameter, default 2.0): START TIGHT so
        # the first basis after the phase switch is a good preconditioner
        # (on staircase/srd-like LPs a loose first basis costs thousands of
        # CR iterations in the first solve), then relax toward the
        # parameter while CR stays cheap and tighten again when it is not.
        self._vt = max(1.05, min(1.1, control.parameters.volume_tol))

    # ------------------------------------------------------------------
    def _factorize(self, iterate, info: Info) -> None:
        info.errflag = 0
        self.factorized = False
        prev_iters = self._iters
        self._iters = 0
        self.changes = 0

        # feedback control of the maxvolume tolerance (see __init__)
        vt_max = max(self.control.parameters.volume_tol, 1.0)
        if prev_iters > 60:
            self._vt = max(1.05, self._vt * 0.75)
        elif prev_iters and prev_iters < 25:
            self._vt = min(vt_max, self._vt * 1.3)

        self.colscale = iterate.scaling_factors()

        # Drop degenerate variables unless the model looks infeasible
        # (pobj < dobj), reference: src/kkt_solver_basis.cc:30-43.
        if iterate.pobjective() >= iterate.dobjective():
            self._drop_primal(iterate, info)
            if info.errflag:
                return
            self._drop_dual(iterate, info)
            if info.errflag:
                return

        # Refresh-skip: when the previous refresh was nearly dry AND CR
        # stayed cheap, the basis is still volume-good for the drifted
        # weights — skip at most every other refresh (the scaling D2 is
        # rebuilt from the CURRENT iterate either way via
        # splitted.prepare, so only candidate scanning is saved). No
        # reference counterpart (the reference refreshes uncondition-
        # ally, src/kkt_solver_basis.cc:44-57).
        m = self.model.num_rows
        dry = (getattr(self, "_prev_mv_updates", 1 << 30)
               <= max(4, m // 50000)
               and prev_iters and prev_iters < 40
               and not getattr(self, "_skipped_last", False))
        if dry:
            self._skipped_last = True
        else:
            self._skipped_last = False
            maxvol = Maxvolume(self.control, volume_tol=self._vt)
            if self.control.parameters.update_heuristic == 0:
                info.errflag = maxvol.run_sequential(self.colscale,
                                                     self.basis)
            else:
                info.errflag = maxvol.run_heuristic(self.colscale,
                                                    self.basis)
            info.updates_ipm += maxvol.updates
            info.time_maxvol += maxvol.time
            info.maxvol_updates += maxvol.updates
            info.maxvol_skipped += maxvol.skipped
            info.maxvol_passes += max(maxvol.passes, 0)
            info.volume_increase += maxvol.volinc
            self.changes += maxvol.updates
            self._prev_mv_updates = maxvol.updates
            if info.errflag:
                return

        # Refactorize only when cost-driven: the splitted operator runs
        # through the eta-aware FTRAN/BTRAN, so (unlike the reference, which
        # needs fresh explicit factors each iteration, reference:
        # src/kkt_solver_basis.cc:58-66) a stale factorization plus updates
        # is exact. need_fresh fires when the accumulated eta-application
        # work exceeds a multiple of the factor size.
        if (not self.basis.factorization_is_fresh
                and self.basis.lu.need_fresh_factorization()):
            info.errflag = self.basis.factorize()
            if info.errflag:
                return
        self.splitted.prepare(self.basis, self.colscale)
        self._prepare_sharded()
        self._prepare_device()
        self._epoch_lhs = None      # slot-space warm start, valid only for
                                    # this prepared operator
        self.factorized = True

    def _prepare_sharded(self) -> None:
        """Phase-2 N N' over column blocks when Parameters.shards > 1
        (VERDICT r3 item 2: the splitted operator was the missing
        mesh-parallel phase; B/B' solves stay on host). The blocks live
        where phase 1's row blocks do: on the ranks of
        backend.resolve_mesh's mesh, or on the device of
        backend.resolve_sharded; the operator is built once per model and
        device (or mesh) and repacked at every factorization. Errors
        raise."""
        params = self.control.parameters
        self._sharded2 = None
        if params.shards is None or params.shards <= 1:
            return
        md = self.model
        P = int(params.shards)
        mesh, device, key = backend.sharded_place(params.device, P)
        cached = getattr(md, "_sharded_nnt", None)
        if cached is None or cached[0] != key:
            nnt = ShardedSplittedNNt(md.num_rows, md.num_cols, P, device,
                                     mesh)
            where = device if mesh is None else mesh.describe()
            self.control.log(f" sharded phase-2 N N': {P} column blocks on "
                             f"{where}\n")
            md._sharded_nnt = (key, nnt, ShardedPhase2CR(nnt))
            cached = md._sharded_nnt
        _, nnt, cr = cached
        nnt.set_operand(self.splitted.N)
        self._sharded2 = cr

    def _prepare_device(self) -> None:
        """Device phase-2 CR for Parameters.device "cuda" and "torch_cpu"
        (the reference gates on device == "tpu"): the N N' product on the
        device, host-looped recurrences and B/B' solves (ops/device_cr2.py).
        "auto" keeps phase 2 on the host, as the reference does. With
        Parameters.shards > 1 the column blocks take phase 2 instead, as
        the row blocks take phase 1 (kkt/diag.py), so that the blocks of
        both phases sit on the device the caller named; the reference's
        device CR would take phase 2 there."""
        device = self.control.parameters.device
        if device not in ("cuda", "torch_cpu") or self._sharded2 is not None:
            self._device_cr = None
            return
        if getattr(self, "_device_cr", None) is None:
            self._device_cr = DeviceSplittedCR(self.model,
                                               backend.resolve(device))
        self._device_cr.prepare(self.splitted)

    # ------------------------------------------------------------------
    def _solve(self, a: np.ndarray, b: np.ndarray, tol: float, info: Info,
               y0=None):
        # y0 (the row-space warm start the IPM offers) is unused — mapping
        # it into slot space costs a B' solve. Instead the native CR warm
        # starts the CORRECTOR from the predictor's slot-space solution of
        # the same factorize epoch (no transform needed; the kernel keeps
        # the zero start whenever the warm residual is not smaller).
        """reference: src/kkt_solver_basis.cc:75-194"""
        md = self.model
        m, n = md.num_rows, md.num_cols
        basis = self.basis
        info.errflag = 0
        assert self.factorized

        D = self.colscale
        m2b = basis.map2basis
        nonbasic = m2b == -1
        free_basic = m2b >= m          # BASIC_FREE

        # work = inv(B') v with v[p] = a[basis[p]] for free basic vars
        free_pos_mask = basis.basic_free_mask()     # by position
        num_free = int(free_pos_mask.sum())
        work = np.zeros(m)
        if num_free > 0:
            bvars = basis.basis[free_pos_mask]
            work[free_pos_mask] = a[bvars]
            work = basis.solve_dense(work, "T")

        # rhs = inv(B) (N D2_n (a[nonbasic] - N' work))
        d2 = np.where(nonbasic, D * D, 0.0)
        if num_free > 0:
            atw = md.AIt_mul(work)
            alpha = np.where(nonbasic, (a - atw) * d2, 0.0)
        else:
            alpha = np.where(nonbasic, a * d2, 0.0)
        rhs = md.AI_mul(alpha)
        rhs = basis.solve_dense(rhs, "N")

        # work = inv(B) b
        work = basis.solve_dense(b, "N")

        # rhs[p] = (rhs[p]-work[p])/D[j] + D[j]*a[j] for non-free basic j
        bvars_all = basis.basis
        dbasic = D[bvars_all]
        normal_basic = ~free_pos_mask
        with np.errstate(invalid="ignore", divide="ignore"):
            rhs = np.where(normal_basic,
                           (rhs - work) / dbasic + a[bvars_all] * dbasic,
                           0.0)
        assert np.all(np.isfinite(rhs[normal_basic]))
        workp = rhs        # the operator works directly in basis-slot space

        # CR on the preconditioned normal equations; the whole loop runs in
        # the native kernel when available (triangular solves + NN' product
        # + recurrence without Python crossings per iteration).
        self.splitted.reset_time()
        if getattr(self, "_device_cr", None) is not None:
            from time import perf_counter
            deadline = 0.0
            tl = self.control.parameters.time_limit
            if tl >= 0:
                import time as _t
                remaining = tl - self.control.elapsed()
                deadline = _t.monotonic() + max(remaining, 0.0)
            t0 = perf_counter()
            warm = (getattr(self, "_epoch_lhs", None)
                    if getattr(self, "_last_solve_iters", 0) >= 12 else None)
            lhs, iters, errflag = self._device_cr.solve(
                workp, tol, self.maxiter, deadline=deadline, warm=warm)
            info.errflag = errflag
            info.kktiter2 += iters
            info.time_cr2 += perf_counter() - t0
            info.time_cr2_B += self._device_cr.time_B
            info.time_cr2_Bt += self._device_cr.time_Bt
            info.time_cr2_NNt += self._device_cr.time_NNt
            self._iters += iters
            self._last_solve_iters = iters
            if errflag == 0:
                self._epoch_lhs = lhs
        elif getattr(self, "_sharded2", None) is not None:
            from time import perf_counter
            cr = self._sharded2
            cr.time_B = cr.time_Bt = cr.time_NNt = 0.0
            t0 = perf_counter()
            lhs, iters, errflag = cr.solve(self.splitted, workp, tol,
                                           self.maxiter)
            info.errflag = errflag
            info.kktiter2 += iters
            info.time_cr2 += perf_counter() - t0
            info.time_cr2_NNt += cr.time_NNt
            info.time_cr2_B += cr.time_B
            info.time_cr2_Bt += cr.time_Bt
            self._iters += iters
        elif getattr(self.splitted, "_native", None) is not None:
            from time import perf_counter
            deadline = 0.0
            tl = self.control.parameters.time_limit
            if tl >= 0:
                import time as _t
                remaining = tl - self.control.elapsed()
                deadline = _t.monotonic() + max(remaining, 0.0)
            # the warm start costs one extra operator application, so it
            # only pays when solves run long enough to amortize it (grid-
            # class instances at 40-200 CR iters/solve; not transportation
            # at 5-8)
            warm = (getattr(self, "_epoch_lhs", None)
                    if getattr(self, "_last_solve_iters", 0) >= 12 else None)
            t0 = perf_counter()
            lhs, iters, errflag = self.splitted.native_cr(
                workp, tol, self.maxiter, deadline, warm=warm)
            info.errflag = errflag
            info.kktiter2 += iters
            info.time_cr2 += perf_counter() - t0
            self._iters += iters
            self._last_solve_iters = iters
            if errflag == 0:
                self._epoch_lhs = lhs
        else:
            lhs = np.zeros(m)
            cr = ConjugateResiduals(self.control)
            cr.solve(self.splitted, workp, tol, None, self.maxiter, lhs)
            info.errflag = cr.errflag
            info.kktiter2 += cr.iter
            info.time_cr2 += cr.time
            self._iters += cr.iter
        info.time_cr2_NNt += self.splitted.time_NNt
        info.time_cr2_B += self.splitted.time_B
        info.time_cr2_Bt += self.splitted.time_Bt
        if info.errflag:
            return np.zeros(n + m), np.zeros(m)
        y = lhs

        # recover dual solution: y[p] /= D[j] for basic, a[j] for free basic
        with np.errstate(invalid="ignore", divide="ignore"):
            y = np.where(normal_basic, y / dbasic, a[bvars_all])
        y = basis.solve_dense(y, "T")

        # x[nonbasic] and work = b - N x[nonbasic]
        aty = md.AIt_mul(y)
        x = np.where(nonbasic, (a - aty) * d2, 0.0)
        work = b - md.AI_mul(np.where(nonbasic, x, 0.0))

        # x[basic]
        sol = basis.solve_dense(work, "N")
        x[bvars_all] = sol
        return x, y

    def _iter(self) -> int:
        return self._iters

    def _basis_changes(self) -> int:
        return self.changes

    def _basis(self):
        return self.basis

    # ------------------------------------------------------------------
    def _run_drop_native(self, lib, basis, iterate, info, cand64, call):
        """Chunked driver for the native drop loops; returns (dropped list,
        exchange count) and syncs basis statistics."""
        import time as _t
        from ..status import InterruptError
        ncand = int(cand64.size)
        st = {
            "next_i": np.zeros(1, dtype=np.int64),
            "fresh": np.array(
                [1 if basis.factorization_is_fresh else 0], dtype=np.int64),
            "dropped": np.zeros(max(ncand, 1), dtype=np.int64),
            "ndropped": np.zeros(1, dtype=np.int64),
            "ic": np.zeros(8, dtype=np.int64),
            "dc": np.zeros(4, dtype=np.float64),
            "fills": np.zeros(256, dtype=np.float64),
            "cap": 256,
            "nfills": np.zeros(1, dtype=np.int64),
        }
        while True:
            ret = int(call(_t.monotonic() + 1.0, st))
            basis.fill_factors.extend(
                st["fills"][:int(st["nfills"][0])].tolist())
            if ret == 3:
                try:
                    self.control.interrupt_check()
                except InterruptError:
                    info.errflag = 999
                    break
                continue
            if ret != 0:
                info.errflag = int(ret)
            break
        ic, dc = st["ic"], st["dc"]
        basis.num_ftran += int(ic[2])
        basis.num_ftran_sparse += int(ic[3])
        basis.num_btran += int(ic[4])
        basis.num_btran_sparse += int(ic[5])
        basis.num_updates += int(ic[6])
        basis.num_factorizations += int(ic[7])
        basis.time_ftran += float(dc[0])
        basis.time_btran += float(dc[1])
        basis.time_update += float(dc[2])
        basis.time_factorize += float(dc[3])
        basis.factorization_is_fresh = bool(st["fresh"][0])
        basis.lu._pivottol = float(
            basis.lu.lib.ipxlu_get_pivottol(basis.lu.handle))
        dropped = st["dropped"][:int(st["ndropped"][0])].tolist()
        return dropped, int(ic[1])

    # ------------------------------------------------------------------
    def _drop_primal(self, iterate, info: Info) -> None:
        """Pivot near-bound basic variables out of the basis or mark them
        implied (reference: src/kkt_solver_basis.cc:196-293)."""
        md = self.model
        m, n = md.num_rows, md.num_cols
        basis = self.basis
        xl, xu = iterate.xl, iterate.xu
        zl, zu = iterate.zl, iterate.zu
        btran = IndexedVector(m)
        row = IndexedVector(n + m)
        drop_primal = self.control.parameters.ipm_drop_primal
        volume_tol = 2.0
        info.errflag = 0

        bvars = basis.basis
        is_basic = basis.map2basis[bvars] < m      # BASIC, not BASIC_FREE
        lower_near = xl[bvars] <= xu[bvars]
        xj = np.where(lower_near, xl[bvars], xu[bvars])
        zj = np.where(lower_near, zl[bvars], zu[bvars])
        with np.errstate(invalid="ignore"):
            cand_mask = is_basic & (xj < 0.01 * zj) & (xj <= drop_primal)
        candidates = [int(j) for j in bvars[cand_mask]]
        if not candidates:
            return

        ctx = _drop_native_ctx(basis)
        if ctx is not None:
            lib, handle = ctx
            self.colscale = np.ascontiguousarray(self.colscale)
            cand64 = np.ascontiguousarray(candidates, dtype=np.int64)
            dropped, changes = self._run_drop_native(
                lib, basis, iterate, info, cand64,
                lambda pause, st: lib.ipxlu_drop_primal(
                    handle, basis.basis, basis.map2basis, self.colscale,
                    np.ascontiguousarray(iterate.xl),
                    np.ascontiguousarray(iterate.xu),
                    np.ascontiguousarray(iterate.zl),
                    np.ascontiguousarray(iterate.zu),
                    cand64, cand64.size, st["next_i"], 2.0, pause,
                    st["fresh"], st["dropped"], st["ndropped"],
                    st["ic"], st["dc"], st["fills"], st["cap"],
                    st["nfills"]))
            for code in dropped:
                jb = int(code) // 2
                if int(code) % 2:
                    iterate.make_implied_lb(jb)
                else:
                    iterate.make_implied_ub(jb)
            info.primal_dropped += len(dropped)
            info.updates_ipm += changes
            self.changes += changes
            return

        with np.errstate(divide="ignore"):
            invscale_basic = 1.0 / self.colscale[basis.basis]
        invscale_basic[~np.isfinite(invscale_basic)] = 0.0

        while candidates:
            jb = candidates[-1]
            p = basis.position_of(jb)
            s = invscale_basic[p]
            basis.tableau_row(jb, btran, row, True)
            nz = row.nonzero_indices()
            vals = np.abs(row.values[nz])
            v = np.where(vals > PIVOT_ZERO_TOL,
                         vals * self.colscale[nz] * s, 0.0)
            jmax = -1
            if v.size:
                k = int(np.argmax(v))
                if v[k] > volume_tol:
                    jmax = int(nz[k])
            if jmax >= 0:
                pivot = row.values[jmax]
                if abs(pivot) < 1e-3:
                    self.control.debug(
                        f" |pivot| = {abs(pivot):.2e} (primal basic "
                        "variable close to bound)\n", 3)
                info.errflag, exchanged = basis.exchange_if_stable(
                    jb, jmax, pivot, 1)
                if info.errflag:
                    return
                if not exchanged:
                    continue
                invscale_basic[p] = 1.0 / self.colscale[jmax]
                info.updates_ipm += 1
                self.changes += 1
            else:
                with np.errstate(invalid="ignore"):
                    lb_side = zl[jb] / xl[jb] > zu[jb] / xu[jb]
                if lb_side:
                    iterate.make_implied_lb(jb)
                else:
                    iterate.make_implied_ub(jb)
                basis.free_basic_variable(jb)
                invscale_basic[p] = 0.0
                self.colscale[jb] = INF
                info.primal_dropped += 1
            candidates.pop()

    def _drop_dual(self, iterate, info: Info) -> None:
        """Pivot near-zero-dual nonbasic variables into the basis or fix them
        (reference: src/kkt_solver_basis.cc:295-387)."""
        md = self.model
        m, n = md.num_rows, md.num_cols
        basis = self.basis
        xl, xu = iterate.xl, iterate.xu
        zl, zu = iterate.zl, iterate.zu
        ftran = IndexedVector(m)
        drop_dual = self.control.parameters.ipm_drop_dual
        volume_tol = 2.0
        info.errflag = 0

        nb = np.nonzero(basis.map2basis == -1)[0]
        upper_larger = zl[nb] >= zu[nb]
        xj = np.where(upper_larger, xl[nb], xu[nb])
        zj = np.where(upper_larger, zl[nb], zu[nb])
        with np.errstate(invalid="ignore"):
            cand_mask = (zj < 0.01 * xj) & (zj <= drop_dual)
        candidates = [int(j) for j in nb[cand_mask]]
        if not candidates:
            return

        ctx = _drop_native_ctx(basis)
        if ctx is not None:
            lib, handle = ctx
            self.colscale = np.ascontiguousarray(self.colscale)
            cand64 = np.ascontiguousarray(candidates, dtype=np.int64)
            dropped, changes = self._run_drop_native(
                lib, basis, iterate, info, cand64,
                lambda pause, st: lib.ipxlu_drop_dual(
                    handle, basis.basis, basis.map2basis, self.colscale,
                    cand64, cand64.size, st["next_i"], 2.0, pause,
                    st["fresh"], st["dropped"], st["ndropped"],
                    st["ic"], st["dc"], st["fills"], st["cap"],
                    st["nfills"]))
            for jn in dropped:
                iterate.make_fixed(int(jn))
            info.dual_dropped += len(dropped)
            info.updates_ipm += changes
            self.changes += changes
            return

        with np.errstate(divide="ignore"):
            invscale_basic = 1.0 / self.colscale[basis.basis]
        invscale_basic[~np.isfinite(invscale_basic)] = 0.0

        while candidates:
            jn = candidates[-1]
            s = self.colscale[jn]
            basis.solve_for_update(jn, ftran)
            nz = ftran.nonzero_indices()
            vals = np.abs(ftran.values[nz])
            v = np.where(vals > PIVOT_ZERO_TOL,
                         vals * invscale_basic[nz] * s, 0.0)
            pmax = -1
            if v.size:
                k = int(np.argmax(v))
                if v[k] > volume_tol:
                    pmax = int(nz[k])
            if pmax >= 0:
                pivot = ftran.values[pmax]
                if abs(pivot) < 1e-3:
                    self.control.debug(
                        f" |pivot| = {abs(pivot):.2e} (dual nonbasic "
                        "variable close to zero)\n", 3)
                jb = int(basis.basis[pmax])
                info.errflag, exchanged = basis.exchange_if_stable(
                    jb, jn, pivot, -1)
                if info.errflag:
                    return
                if not exchanged:
                    continue
                invscale_basic[pmax] = 1.0 / self.colscale[jn]
                info.updates_ipm += 1
                self.changes += 1
            else:
                iterate.make_fixed(jn)
                basis.fix_nonbasic_variable(jn)
                self.colscale[jn] = 0.0
                info.dual_dropped += 1
            candidates.pop()
