"""Maxvolume basis refinement ("Russian algorithm").

Counterpart of the reference maxvolume (reference: src/maxvolume.{h,cc}):
keep the basis approximately of maximum volume under the IPM column scaling.
Two variants:

 - sequential (parameter update_heuristic=0): passes over all nonbasic
   columns, exchanging whenever the scaled tableau entry exceeds volume_tol
   (reference: src/maxvolume.cc:14-94);
 - heuristic (default): split tableau rows into 5 + m/rows_per_slice slices;
   per slice compute column weights with ONE dense BTRAN, then repeatedly
   exchange the column with the largest weight, rank-1-updating the weights
   after each exchange, stopping the slice after maxskip_updates skips
   (reference: src/maxvolume.cc:96-320).

The port's copy of ipx_tpu/basis/maxvolume.py.
"""
from __future__ import annotations

from time import perf_counter

import numpy as np

from ..control import Control
from ..status import Errflag, InterruptError
from .basis import BASIC, NONBASIC, Basis
from .indexed_vector import IndexedVector

PIVOT_ZERO_TOL = 1e-7      # reference: src/kkt_solver_basis.h:33


class Maxvolume:
    def __init__(self, control: Control, volume_tol: float = None):
        self.control = control
        # optional override of parameters.volume_tol (adaptive controller
        # in KKTSolverBasis)
        self._volume_tol = volume_tol
        self.updates = 0
        self.skipped = 0
        self.passes = 0
        self.slices = 0
        self.volinc = 0.0
        self.time = 0.0
        self.tblnnz = 0
        self.tblmax = 0.0
        self.frobnorm_squared = 0.0

    # ------------------------------------------------------------------
    def run_sequential(self, colscale: np.ndarray, basis: Basis) -> int:
        """reference: src/maxvolume.cc:14-94"""
        md = basis.model
        m, n = md.num_rows, md.num_cols
        ftran = IndexedVector(m)
        t0 = perf_counter()
        errflag = 0

        maxpasses = self.control.parameters.maxpasses
        volumetol = max(self._volume_tol if self._volume_tol is not None
                        else self.control.parameters.volume_tol, 1.0)

        invscale_basic = np.zeros(m)
        for p in range(m):
            j = int(basis.basis[p])
            if basis.status_of(j) == BASIC:
                invscale_basic[p] = 1.0 / colscale[j]

        while self.passes < maxpasses or maxpasses < 0:
            self.tblnnz = 0
            self.tblmax = 0.0
            self.frobnorm_squared = 0.0
            updates_last = 0
            candidates = list(np.argsort(colscale, kind="stable"))
            while candidates:
                j = int(candidates[-1])
                dj = colscale[j]
                if dj == 0.0:
                    break
                if basis.status_of(j) != NONBASIC:
                    candidates.pop()
                    continue
                try:
                    self.control.interrupt_check()
                except InterruptError:
                    errflag = int(Errflag.INTERRUPT_TIME)
                    break
                basis.solve_for_update(j, ftran)
                nz = ftran.nonzero_indices()
                v = np.abs(ftran.values[nz]) * invscale_basic[nz] * dj
                self.tblnnz += int(np.count_nonzero(v))
                self.frobnorm_squared += float(v @ v)
                pmax = -1
                vmax = 0.0
                if v.size:
                    k = int(np.argmax(v))
                    vmax = float(v[k])
                    pmax = int(nz[k])
                self.tblmax = max(self.tblmax, vmax)
                if vmax <= volumetol:
                    self.skipped += 1
                    candidates.pop()
                    continue
                jb = int(basis.basis[pmax])
                errflag, exchanged = basis.exchange_if_stable(
                    jb, j, ftran.values[pmax], -1)
                if errflag:
                    break
                if not exchanged:
                    continue
                invscale_basic[pmax] = 1.0 / dj
                updates_last += 1
                self.volinc += np.log2(vmax)
                candidates.pop()
            self.updates += updates_last
            self.passes += 1
            if updates_last == 0 or errflag != 0:
                break
        self.time = perf_counter() - t0
        return errflag

    # ------------------------------------------------------------------
    def run_heuristic(self, colscale: np.ndarray, basis: Basis) -> int:
        """reference: src/maxvolume.cc:108-153"""
        md = basis.model
        m, n = md.num_rows, md.num_cols
        t0 = perf_counter()
        errflag = 0

        num_slices = 5 + max(m // self.control.parameters.rows_per_slice, 0)
        num_slices = min(num_slices, m)

        # invscale by position; BASIC only (zero at BASIC_FREE positions)
        mp_basic = basis.map2basis[basis.basis]
        plain = (mp_basic >= 0) & (mp_basic < m)
        with np.errstate(divide="ignore"):
            invscale_basic = np.where(plain, 1.0 / colscale[basis.basis],
                                      0.0)
        cs = np.zeros(n + m)
        nb = basis.map2basis == -1
        cs[nb] = colscale[nb]

        perm = np.argsort(invscale_basic, kind="stable")
        native = self._native_ctx(basis)
        # (Measured dead end, kept as a note: grouping the slice BTRANs
        # into blocked multi-RHS solves amortizes the factor traversal but
        # the intra-group weight staleness degrades the refreshed basis —
        # staircase-90k kkt2 512 -> 1046 — costing more CR time than the
        # solves saved. Slices therefore keep per-slice exact BTRANs, as
        # the reference does; reference: src/maxvolume.cc:155-199.)
        # Dry-streak early exit: slices interleave one scale-ordered
        # permutation (slice s takes perm[i], i % num_slices == s), so
        # they are statistically exchangeable samples of the same
        # candidate population. Once several consecutive slices produce
        # (almost) no exchanges, the remaining slices are dry too — but
        # each would still pay its full BTRAN + weights pass. Measured on
        # staircase(120,1500): late refreshes spend 14 slices on 0-2
        # total updates; the exit recovers that time with no observed
        # kkt2 change. (Distinct from the round-3 grouped-BTRAN dead end:
        # no weights go stale — we only stop scanning.)
        dry_streak = 0
        self.slices_visited = 0
        for s in range(num_slices):
            self.slices_visited += 1
            upd0 = self.updates
            tblrow_used = np.zeros(m, dtype=bool)
            tblrow_used[perm[np.arange(m) % num_slices == s]] = True
            if native is not None:
                errflag = self._driver_native(native, basis, cs,
                                              invscale_basic, tblrow_used)
            else:
                errflag = self._driver(basis, cs, invscale_basic,
                                       tblrow_used)
            if errflag:
                break
            dry_streak = dry_streak + 1 if self.updates - upd0 <= 1 else 0
            if dry_streak >= 3 and s >= 4:
                break

        self.time = perf_counter() - t0
        self.passes = -1
        self.slices = num_slices
        return errflag

    # ------------------------------------------------------------------
    def _native_ctx(self, basis: Basis):
        from .crossover import _xover_native_ctx
        ctx = _xover_native_ctx(basis)
        if ctx is None:
            return None
        lib, handle = ctx
        if not hasattr(lib, "_maxvol_ready"):
            import ctypes as ct
            I = ct.c_int64
            D = ct.c_double
            P_ = ct.c_void_p
            IA = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            DA = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
            BA = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
            lib.ipxlu_maxvol_slice.restype = I
            lib.ipxlu_maxvol_slice.argtypes = [
                P_, IA, IA, DA, DA, BA, DA, D, I, D, IA, IA, DA,
                IA, DA, DA, I, IA]
            lib._maxvol_ready = True
        return lib, handle

    def _driver_native(self, native, basis: Basis, colscale, invscale_basic,
                       tblrow_used, work=None) -> int:
        """Whole-slice driver in the native kernel (chunked for interrupt
        checks); mirrors _driver/reference: src/maxvolume.cc:202-320.
        `work` optionally supplies a precomputed B' solve of the slice
        vector (the blocked path in run_heuristic)."""
        import time as _t
        lib, handle = native
        md = basis.model
        volumetol = max(self._volume_tol if self._volume_tol is not None
                        else self.control.parameters.volume_tol, 1.0)
        maxskip = self.control.parameters.maxskip_updates

        if work is None:
            work = np.where(tblrow_used, invscale_basic, 0.0)
            work = basis.solve_dense(work, "T")
        mulh = md._native_mul()
        if mulh is not None:
            if not hasattr(lib, "_maxvolw_ready"):
                import ctypes as ct
                I = ct.c_int64
                IA = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
                IA32 = np.ctypeslib.ndpointer(np.int32,
                                              flags="C_CONTIGUOUS")
                DA = np.ctypeslib.ndpointer(np.float64,
                                            flags="C_CONTIGUOUS")
                lib.ipxlu_maxvol_weights.argtypes = [I, I, IA, IA32, DA,
                                                     DA, DA, DA]
                lib._maxvolw_ready = True
            _, Ap, Ai, Ax = mulh[:4]
            colscale = np.ascontiguousarray(colscale)
            colweights = np.empty(md.num_var_all)
            lib.ipxlu_maxvol_weights(md.num_rows, md.num_cols, Ap, Ai, Ax,
                                     np.ascontiguousarray(work), colscale,
                                     colweights)
        else:
            aty = md.AIt_mul(work)
            colweights = np.ascontiguousarray(
                np.where(colscale != 0.0, aty * colscale, 0.0))
        used8 = np.ascontiguousarray(tblrow_used, dtype=np.int8)

        fresh = np.array([1 if basis.factorization_is_fresh else 0],
                         dtype=np.int64)
        skipstate = np.zeros(1, dtype=np.int64)
        volinc = np.zeros(1, dtype=np.float64)
        ic = np.zeros(8, dtype=np.int64)
        dc = np.zeros(4, dtype=np.float64)
        fills = np.zeros(256, dtype=np.float64)
        nfills = np.zeros(1, dtype=np.int64)
        errflag = 0
        while True:
            ret = int(lib.ipxlu_maxvol_slice(
                handle, basis.basis, basis.map2basis, colscale,
                invscale_basic, used8, colweights, volumetol, maxskip,
                _t.monotonic() + 1.0, fresh, skipstate, volinc,
                ic, dc, fills, 256, nfills))
            basis.fill_factors.extend(fills[:int(nfills[0])].tolist())
            if ret == 3:
                try:
                    self.control.interrupt_check()
                except InterruptError:
                    errflag = int(Errflag.INTERRUPT_TIME)
                    break
                continue
            if ret != 0:
                errflag = int(ret)
            break
        self.skipped += int(ic[0])
        self.updates += int(ic[1])
        self.volinc += float(volinc[0])
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
        basis.factorization_is_fresh = bool(fresh[0])
        basis.lu._pivottol = float(
            basis.lu.lib.ipxlu_get_pivottol(basis.lu.handle))
        return errflag

    def _driver(self, basis: Basis, colscale, invscale_basic,
                tblrow_used) -> int:
        """reference: src/maxvolume.cc:202-320"""
        md = basis.model
        m, n = md.num_rows, md.num_cols
        lhs = IndexedVector(m)
        row = IndexedVector(n + m)
        errflag = 0

        volumetol = max(self._volume_tol if self._volume_tol is not None
                        else self.control.parameters.volume_tol, 1.0)
        maxskip = self.control.parameters.maxskip_updates

        # column weights: one dense BTRAN per slice
        work = np.where(tblrow_used, invscale_basic, 0.0)
        work = basis.solve_dense(work, "T")
        aty = md.AIt_mul(work)
        colweights = np.where(colscale != 0.0, aty * colscale, 0.0)

        candidates: list = []
        skipped = 0
        TOPK = 32
        fresh_scan = False
        while True:
            if not candidates:
                fresh_scan = True
                # Take the TOPK columns by |weight| in one O(n) pass and
                # consume them largest-first. (The reference rescans for the
                # top-2 after every exchange, reference: src/maxvolume.cc
                # FindLargest; batching the scan is a heuristic-preserving
                # optimization — stale candidates are re-validated below via
                # their current weight.)
                aw = np.abs(colweights)
                k = min(TOPK, aw.size)
                topk = np.argpartition(aw, -k)[-k:]
                topk = topk[np.argsort(aw[topk], kind="stable")]
                candidates = [int(j) for j in topk]
            jn = candidates[-1]
            weight = colweights[jn]
            if weight == 0.0:
                if fresh_scan:
                    break      # a fresh scan's maximum is zero: slice done
                candidates = []    # stale candidate: rescan
                continue
            try:
                self.control.interrupt_check()
            except InterruptError:
                errflag = int(Errflag.INTERRUPT_TIME)
                break

            # max scaled FTRAN entry
            basis.solve_for_update(jn, lhs)
            nz = lhs.nonzero_indices()
            raw = lhs.values[nz]
            scaled = raw * colscale[jn] * invscale_basic[nz]
            eligible = np.abs(raw) > PIVOT_ZERO_TOL
            vabs = np.where(eligible, np.abs(scaled), 0.0)
            if vabs.size == 0:
                vmax = 0.0
                pmax = 0
            else:
                k = int(np.argmax(vabs))
                vmax = float(vabs[k])
                pmax = int(nz[k])
            # scale lhs in place (ScaleFtran semantics)
            lhs.values[nz] = scaled

            if vmax <= volumetol:
                colweights[jn] = 0.0
                colscale[jn] = 0.0
                candidates.pop()
                skipped += 1
                if skipped > maxskip >= 0:
                    break
                continue

            # recompute column weight from FTRAN
            weight_recomp = float(np.sum(lhs.values[nz][tblrow_used[nz]]))

            jb = int(basis.basis[pmax])
            basis.tableau_row(jb, lhs, row, True)
            pivot = row.values[jn]
            if abs(pivot) < 1e-3:
                self.control.debug(
                    f" |pivot| {abs(pivot):.2e} (maxvolume)\n", 3)
            errflag, exchanged = basis.exchange_if_stable(jb, jn, pivot, 0)
            if errflag:
                break
            if not exchanged:
                continue
            self.updates += 1
            self.volinc += np.log2(vmax)

            dn = colscale[jn]
            dbinv = invscale_basic[pmax]
            colscale[jb] = 1.0 / invscale_basic[pmax]
            invscale_basic[pmax] = 1.0 / colscale[jn]
            colscale[jn] = 0.0

            # rank-1 update of column weights
            alpha = (float(tblrow_used[pmax]) - weight_recomp) / (dn * pivot)
            rnz = row.nonzero_indices()
            colweights[rnz] += alpha * row.values[rnz] * colscale[rnz]
            colweights[jb] = float(tblrow_used[pmax]) + alpha / dbinv
            colweights[jn] = 0.0
            candidates.pop()
            fresh_scan = False

        self.skipped += skipped
        return errflag

