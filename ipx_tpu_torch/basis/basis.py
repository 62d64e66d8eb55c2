"""Basis manager: ordered basic set with simplex-type linear algebra.

Counterpart of the reference basis manager (reference: src/basis.{h,cc}).
Manages m column indices of AI = [A I] with AI[:,basis] nonsingular, with:

 - factorization with the auto pivot-tolerance tightening ladder
   0.0625 -> 0.1 -> 0.3 -> 0.9 (reference: src/basis.cc:116-156, 490-503);
 - hypersparse FTRAN/BTRAN through the native LU kernel;
 - TableauRow via sparse-vector*CSR or dense-vector*CSC chosen by a fill
   estimate (reference: src/basis.cc:216-284);
 - ExchangeIfStable: LU update or refactorize-on-instability
   (reference: src/basis.cc:286-322);
 - crash-basis pipeline and singularity repair by rook search on inv(B)
   (Higham/Relton; reference: src/basis.cc:536-604);
 - PivotFreeVariablesIntoBasis / PivotFixedVariablesOutOfBasis with
   dependency detection and infeasibility-certificate tests
   (reference: src/basis.cc:676-914).

The port's copy of ipx_tpu/basis/basis.py.
"""
from __future__ import annotations

from time import perf_counter
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp

from ..control import Control
from ..info import Info
from ..model import Model
from ..status import Errflag
from .indexed_vector import HYPERSPARSE_THRESHOLD, IndexedVector
from .lu import make_lu

# statuses (reference: src/basis.h:64)
NONBASIC_FIXED = -2
NONBASIC = -1
BASIC = 0
BASIC_FREE = 1

# Basis repair bounds (reference: src/basis.h:226-230)
BASIS_REPAIR_THRESHOLD = 1e5
MAX_BASIS_REPAIR = 200

INF = np.inf


class Basis:
    def __init__(self, control: Control, model: Model):
        self.control = control
        self.model = model
        m, n = model.num_rows, model.num_cols
        self.basis = np.zeros(m, dtype=np.int64)
        # map2basis encoding (reference: src/basis.h:288-293):
        # -2 NONBASIC_FIXED, -1 NONBASIC, p in [0,m) BASIC at position p,
        # p in [m,2m) BASIC_FREE at position p-m
        self.map2basis = np.zeros(n + m, dtype=np.int64)
        # lu_kernel <= 0: native kernel with PFI updates + hypersparse
        # solves (counterpart of the reference's BASICLU path);
        # lu_kernel = 1: Forrest-Tomlin updates without hypersparsity
        # (counterpart of the reference's generic Forrest-Tomlin over any
        # LuFactorization, reference: src/basis.cc:24-29,
        # src/forrest_tomlin.cc)
        self.lu = make_lu(m, "native" if control.parameters.lu_kernel <= 0
                          else "ft")
        self.lu.pivottol = control.parameters.lu_pivottol
        self.factorization_is_fresh = False

        # statistics
        self.num_factorizations = 0
        self.num_updates = 0
        self.num_ftran = 0
        self.num_btran = 0
        self.num_ftran_sparse = 0
        self.num_btran_sparse = 0
        self.time_ftran = 0.0
        self.time_btran = 0.0
        self.time_update = 0.0
        self.time_factorize = 0.0
        self.fill_factors = []
        self._tabbuf = None           # persistent tableau accumulator

        self.set_to_slack_basis()

    # -- status queries -------------------------------------------------
    def status_of(self, j: int) -> int:
        m = self.model.num_rows
        p = self.map2basis[j]
        if p < 0:
            return NONBASIC if p == -1 else NONBASIC_FIXED
        return BASIC if p < m else BASIC_FREE

    def position_of(self, j: int) -> int:
        m = self.model.num_rows
        p = self.map2basis[j]
        if p < 0:
            return -1
        return p if p < m else p - m

    def is_basic(self, j: int) -> bool:
        return self.map2basis[j] >= 0

    def is_nonbasic(self, j: int) -> bool:
        return self.map2basis[j] < 0

    def basic_mask(self) -> np.ndarray:
        return self.map2basis >= 0

    def nonbasic_mask(self) -> np.ndarray:
        return self.map2basis < 0

    def fix_nonbasic_variable(self, j: int) -> None:
        if self.map2basis[j] == -1:
            self.map2basis[j] = -2

    def free_basic_variable(self, j: int) -> None:
        m = self.model.num_rows
        if 0 <= self.map2basis[j] < m:
            self.map2basis[j] += m

    def unfix_variables(self) -> None:
        self.map2basis[self.map2basis == -2] = -1

    def unfree_variables(self) -> None:
        m = self.model.num_rows
        sel = self.map2basis >= m
        self.map2basis[sel] -= m

    def basic_free_mask(self) -> np.ndarray:
        """True at basis POSITIONS whose variable is BASIC_FREE."""
        m = self.model.num_rows
        mask = np.zeros(m, dtype=bool)
        sel = self.map2basis >= m
        mask[self.map2basis[sel] - m] = True
        return mask

    # -- basis loading --------------------------------------------------
    def set_to_slack_basis(self) -> None:
        m, n = self.model.num_rows, self.model.num_cols
        self.basis = np.arange(n, n + m, dtype=np.int64)
        self.map2basis[:n] = -1
        self.map2basis[n:] = np.arange(m)
        err = self.factorize()
        assert err == 0

    def load(self, basic_status: np.ndarray) -> int:
        """reference: src/basis.cc:82-114"""
        m, n = self.model.num_rows, self.model.num_cols
        bs = np.asarray(basic_status)
        if bs.shape[0] != n + m or not np.all(np.isin(
                bs, [NONBASIC_FIXED, NONBASIC, BASIC, BASIC_FREE])):
            return int(Errflag.INVALID_BASIS)
        basic = np.nonzero((bs == BASIC) | (bs == BASIC_FREE))[0]
        if basic.size != m:
            return int(Errflag.INVALID_BASIS)
        self.basis = basic.astype(np.int64)
        self.map2basis[:] = np.where(bs == NONBASIC_FIXED, -2, -1)
        pos = np.arange(m)
        self.map2basis[basic] = np.where(bs[basic] == BASIC_FREE, pos + m,
                                         pos)
        return self.factorize()

    # -- factorization --------------------------------------------------
    def _basis_arrays(self, allow_empty: bool = False):
        """CSC arrays of the basis matrix B = AI[:, basis]."""
        md = self.model
        m, n = md.num_rows, md.num_cols
        A = md.A
        # structural columns point into A; slack columns into a unit block
        # appended after A's data. The concatenated arrays are invariant:
        # build once and cache on the model.
        cache = getattr(md, "_basis_BiBx", None)
        if cache is None or cache[0].shape[0] != A.indptr[-1] + m:
            nnzA = int(A.indptr[-1])
            Bi = np.concatenate([A.indices.astype(np.int64),
                                 np.arange(m, dtype=np.int64)])
            Bx = np.concatenate([A.data.astype(np.float64), np.ones(m)])
            md._basis_BiBx = cache = (np.ascontiguousarray(Bi),
                                      np.ascontiguousarray(Bx))
        Bi, Bx = cache
        nnzA = int(A.indptr[-1])
        b = self.basis
        if not allow_empty and np.any(b < 0):
            raise ValueError("empty basis slot")
        indptr = A.indptr.astype(np.int64)
        struct = (b >= 0) & (b < n)
        slack = b >= n
        js = np.where(struct, b, 0)
        begin = np.where(struct, indptr[js], 0)
        end = np.where(struct, indptr[js + 1], 0)
        begin = np.where(slack, nnzA + (b - n), begin)
        end = np.where(slack, begin + 1, end)
        return (np.ascontiguousarray(begin), np.ascontiguousarray(end),
                Bi, Bx)

    def factorize(self) -> int:
        """reference: src/basis.cc:116-156"""
        t0 = perf_counter()
        begin, end, Bi, Bx = self._basis_arrays()
        err = 0
        while True:
            flag = self.lu.factorize(begin, end, Bi, Bx, False)
            self.num_factorizations += 1
            self.fill_factors.append(self.lu.fill_factor())
            if flag & 2:
                self._adapt_to_singular_factorization()
                err = int(Errflag.BASIS_SINGULAR)
                break
            if (flag & 1) and self.tighten_lu_pivottol():
                continue
            if flag & 1:
                self.control.debug(
                    f" LU factorization unstable with pivot tolerance "
                    f"{self.lu.pivottol}\n", 3)
            break
        self.time_factorize += perf_counter() - t0
        self.factorization_is_fresh = True
        return err

    def crash_factorize(self) -> int:
        """Factorize with strict absolute pivot tolerance; returns # columns
        dropped (reference: src/basis.cc:606-644)."""
        t0 = perf_counter()
        begin, end, Bi, Bx = self._basis_arrays(allow_empty=True)
        flag = self.lu.factorize(begin, end, Bi, Bx, True)
        self.num_factorizations += 1
        self.fill_factors.append(self.lu.fill_factor())
        ndropped = 0
        if flag & 2:
            ndropped = self._adapt_to_singular_factorization()
        self.time_factorize += perf_counter() - t0
        self.factorization_is_fresh = True
        assert np.all(self.basis >= 0)
        return ndropped

    def _adapt_to_singular_factorization(self) -> int:
        """Replace dependent basis positions by slack variables
        (reference: src/basis.cc:466-488)."""
        n = self.model.num_cols
        rowperm, colperm, dependent = self.lu.get_perms_dependent()
        for k in dependent:
            p = colperm[k]
            i = rowperm[k]
            jb = self.basis[p]
            jn = n + i
            assert self.map2basis[jn] < 0
            self.basis[p] = jn
            self.map2basis[jn] = p
            if jb >= 0:
                self.map2basis[jb] = -1
        # The kernel's factors already represent the slack-patched basis
        # exactly (dependent column k of (L+I)U is the unit column e_k in
        # position space, i.e. slack column n+rowperm[k] in user space), so
        # no refactorization is needed here.
        return int(dependent.size)

    def tighten_lu_pivottol(self) -> bool:
        """Pivot tolerance ladder (reference: src/basis.cc:490-503)."""
        tol = self.lu.pivottol
        if tol <= 0.05:
            self.lu.pivottol = 0.1
        elif tol <= 0.25:
            self.lu.pivottol = 0.3
        elif tol <= 0.5:
            self.lu.pivottol = 0.9
        else:
            return False
        self.control.log(
            f" LU pivot tolerance tightened to {self.lu.pivottol}\n")
        return True

    def get_lu_factors(self):
        # With the cost-driven refresh policy the factorization can be stale
        # (updates pending) when a debug consumer asks for explicit factors;
        # refactorize so the factors match the current basis.
        if not self.factorization_is_fresh:
            self.factorize()
        L, U, rowperm, colperm, _ = self.lu.get_factors()
        return L, U, rowperm, colperm

    # -- solves ---------------------------------------------------------
    def solve_dense(self, rhs: np.ndarray, trans: str) -> np.ndarray:
        return self.lu.solve_dense(rhs, trans in ("t", "T"))

    def solve_for_update(self, j: int, lhs: Optional[IndexedVector] = None):
        """FTRAN of AI[:,j] if j nonbasic, else BTRAN of unit vector at j's
        position (reference: src/basis.cc:172-214)."""
        p = self.position_of(j)
        t0 = perf_counter()
        if p < 0:
            bi, bx = self.model.AI_col(j)
            self.lu.ftran_for_update(bi, bx, lhs)
            if lhs is not None:
                self.num_ftran += 1
                if lhs.sparse():
                    self.num_ftran_sparse += 1
            self.time_ftran += perf_counter() - t0
        else:
            self.lu.btran_for_update(p, lhs)
            if lhs is not None:
                self.num_btran += 1
                if lhs.sparse():
                    self.num_btran_sparse += 1
            self.time_btran += perf_counter() - t0
        return lhs

    def tableau_row(self, jb: int, btran: IndexedVector, row: IndexedVector,
                    ignore_fixed: bool = False) -> None:
        """Row of the tableau matrix for basic variable jb
        (reference: src/basis.cc:216-284). Basic variables get value zero."""
        md = self.model
        m, n = md.num_rows, md.num_cols
        assert self.is_basic(jb)
        self.solve_for_update(jb, btran)

        is_sparse = btran.sparse()
        if is_sparse:
            # estimate fill of the sparse-vector * CSR product
            bi = btran.pattern
            nz_est = int(np.diff(md.A_csr.indptr)[bi].sum() + bi.size) // 2
            if nz_est > HYPERSPARSE_THRESHOLD * (n + m):
                is_sparse = False

        if is_sparse:
            from ..utils import multirange_indices
            bi = btran.pattern
            bv = btran.values[bi]
            # structural part: sum_i btran[i] * A[i,:] over btran's pattern,
            # via a multi-range gather of the CSR rows (no scipy fancy
            # indexing, no full-length scans)
            indptr = md.A_csr.indptr
            starts = indptr[bi].astype(np.int64)
            lens = (indptr[bi + 1] - indptr[bi]).astype(np.int64)
            pos = multirange_indices(starts, lens)
            cols = md.A_csr.indices[pos]
            contrib = md.A_csr.data[pos] * np.repeat(bv, lens)
            if self._tabbuf is None or self._tabbuf.shape[0] != n + m:
                self._tabbuf = np.zeros(n + m)
            buf = self._tabbuf
            np.add.at(buf, cols, contrib)
            cand = np.unique(cols)
            vals = buf[cand]
            buf[cand] = 0.0                      # restore zeros
            nzc = vals != 0.0
            struct_idx = cand[nzc]
            vals = vals[nzc]
            # keep only nonbasic (and optionally fixed) columns
            mp = self.map2basis[struct_idx]
            keep = (mp == -1) | ((mp == -2) & (not ignore_fixed))
            struct_idx = struct_idx[keep]
            vals = vals[keep]
            out = np.zeros(n + m)
            out[struct_idx] = vals
            # slack part: row entry of slack i is btran[i]
            slack_idx = bi + n
            mp = self.map2basis[slack_idx]
            keep = (mp == -1) | ((mp == -2) & (not ignore_fixed))
            slack_idx = slack_idx[keep]
            out[slack_idx] = btran.values[bi[keep]]
            pattern = np.concatenate([struct_idx, slack_idx])
            row.set_sparse(out, np.sort(pattern))
        else:
            bv = btran.values
            out = np.empty(n + m)
            out[:n] = bv @ md.A_csr
            out[n:] = bv
            mp = self.map2basis
            mask = (mp == -1) | ((mp == -2) & (not ignore_fixed))
            out[~mask] = 0.0
            row.set_dense(out)

    # -- exchanges ------------------------------------------------------
    def exchange_if_stable(self, jb: int, jn: int, tableau_entry: float,
                           sys: int) -> Tuple[int, bool]:
        """Returns (errflag, exchanged) (reference: src/basis.cc:286-322)."""
        assert self.is_basic(jb)
        assert self.is_nonbasic(jn)
        if sys > 0:
            self.solve_for_update(jn)
        if sys < 0:
            self.solve_for_update(jb)

        t0 = perf_counter()
        err = self.lu.update(tableau_entry)
        self.time_update += perf_counter() - t0
        if err != 0:
            if self.factorization_is_fresh and not self.tighten_lu_pivottol():
                return int(Errflag.BASIS_TOO_ILL_CONDITIONED), False
            self.control.debug(
                f" stability check forced refactorization after "
                f"{self.lu.updates - 1} updates\n", 3)
            return self.factorize(), False      # refactorizes the old basis

        ib = self.position_of(jb)
        assert self.basis[ib] == jb
        self.basis[ib] = jn
        self.map2basis[jn] = ib
        self.map2basis[jb] = -1
        self.num_updates += 1
        self.factorization_is_fresh = False

        if self.lu.need_fresh_factorization():
            return self.factorize(), True
        return 0, True

    def crash_exchange(self, jb: int, jn: int, tableau_entry: float,
                       sys: int) -> int:
        """Guaranteed exchange during crash (reference: src/basis.cc:646-674).
        Returns # columns dropped by refactorization (0 usually)."""
        assert self.is_basic(jb)
        assert self.is_nonbasic(jn)
        if sys > 0:
            self.solve_for_update(jn)
        if sys < 0:
            self.solve_for_update(jb)
        ib = self.position_of(jb)
        self.basis[ib] = jn
        self.map2basis[jn] = ib
        self.map2basis[jb] = -1
        self.num_updates += 1
        self.factorization_is_fresh = False
        t0 = perf_counter()
        err = self.lu.update(tableau_entry)
        self.time_update += perf_counter() - t0
        if err != 0 or self.lu.need_fresh_factorization():
            self.control.debug(
                " refactorization required in crash_exchange\n", 3)
            return self.crash_factorize()
        return 0

    # -- solution computation ------------------------------------------
    def compute_basic_solution(self, x: np.ndarray, y: np.ndarray,
                               z: np.ndarray) -> None:
        """Computes x[basic], y, z[nonbasic] with AI x = b, AI'y + z = c,
        given x[nonbasic] and z[basic] (reference: src/basis.cc:324-351).
        Modifies x, y, z in place."""
        md = self.model
        m, n = md.num_rows, md.num_cols
        nonbasic = self.nonbasic_mask()
        xn = np.where(nonbasic, x, 0.0)
        rhs = md.b - md.AI_mul(xn)
        sol = self.solve_dense(rhs, "N")
        x[self.basis] = sol

        w = md.c[self.basis] - z[self.basis]
        ynew = self.solve_dense(w, "T")
        y[:] = ynew
        aty = md.AIt_mul(y)
        z[nonbasic] = (md.c - aty)[nonbasic]

    # -- basis construction ---------------------------------------------
    def load_basis(self, basis_array: np.ndarray) -> int:
        """Installs an externally supplied basis (m variable indices into
        AI) and factorizes it. Returns 0 on success, nonzero errflag when
        the basis is singular/unusable (caller falls back to normal
        construction). No reference counterpart — used by the scenario-
        batch pipeline to share one starting basis across finishes."""
        m = self.model.num_rows
        arr = np.asarray(basis_array, dtype=np.int64)
        if arr.shape != (m,) or np.unique(arr).size != m \
                or arr.min() < 0 or arr.max() >= self.model.num_cols + m:
            return int(Errflag.INVALID_BASIS)
        self.basis[:] = arr
        self.map2basis[:] = -1
        self.map2basis[arr] = np.arange(m)
        return self.factorize()

    def construct_basis_from_weights(self, colweights: np.ndarray,
                                     info: Info) -> None:
        """reference: src/basis.cc:353-385"""
        info.errflag = 0
        info.dependent_rows = 0
        info.dependent_cols = 0
        if self.control.parameters.crash_basis:
            self.crash_basis(colweights)
            sigma = self.min_singular_value()
            self.control.debug(
                Control.textline("Minimum singular value of crash basis:")
                + f"{sigma:.2e}\n")
            self.repair(info)
            if info.basis_repairs < 0:
                self.control.log(" discarding crash basis\n")
                self.set_to_slack_basis()
            elif info.basis_repairs > 0:
                sigma = self.min_singular_value()
                self.control.debug(
                    Control.textline(
                        "Minimum singular value of repaired crash basis:")
                    + f"{sigma:.2e}\n")
        else:
            self.set_to_slack_basis()
        self.pivot_free_variables_into_basis(colweights, info)
        if info.errflag:
            return
        self.pivot_fixed_variables_out_of_basis(colweights, info)

    def crash_basis(self, colweights: np.ndarray) -> None:
        """reference: src/basis.cc:505-531"""
        from .guess_basis import guess_basis
        m = self.model.num_rows
        cols_guessed = guess_basis(self.control, self.model, colweights)
        self.basis[:] = -1
        self.map2basis[:] = -1
        for k, j in enumerate(cols_guessed):
            assert self.map2basis[j] == -1
            self.basis[k] = j
            self.map2basis[j] = k
        ndropped = self.crash_factorize()
        self.control.debug(
            Control.textline("Number of columns dropped from guessed basis:")
            + f"{ndropped}\n")

    def _inverse_search(self) -> Tuple[int, int, float]:
        """Rook search for a large entry of inv(B) (Higham/Relton;
        reference: src/basis.cc:536-568). Returns (p, i, value)."""
        m = self.model.num_rows
        if m == 0:
            return -1, -1, 0.0
        work = 1.0 / np.arange(1.0, m + 1.0)
        inverse_max = 0.0
        while True:
            work = self.solve_dense(work, "N")
            if not np.all(np.isfinite(work)):
                break
            pmax = int(np.argmax(np.abs(work)))
            work = np.zeros(m)
            work[pmax] = 1.0
            work = self.solve_dense(work, "T")
            if not np.all(np.isfinite(work)):
                break
            imax = int(np.argmax(np.abs(work)))
            inverse_entry = work[imax]
            if abs(inverse_entry) <= 2.0 * inverse_max:
                return pmax, imax, inverse_entry
            inverse_max = abs(inverse_entry)
            work = np.zeros(m)
            work[imax] = 1.0
        return -1, -1, INF

    def repair(self, info: Info) -> None:
        """reference: src/basis.cc:570-604"""
        n = self.model.num_cols
        info.basis_repairs = 0
        if self.model.num_rows == 0:
            return
        while True:
            pmax, imax, pivot = self._inverse_search()
            if pmax < 0 or imax < 0 or not np.isfinite(pivot):
                info.basis_repairs = -1
                break
            if abs(pivot) < BASIS_REPAIR_THRESHOLD:
                break
            jb = self.basis[pmax]
            jn = n + imax
            if not self.is_nonbasic(jn):
                info.basis_repairs = -2
                break
            if info.basis_repairs >= MAX_BASIS_REPAIR:
                info.basis_repairs = -3
                break
            self.solve_for_update(jb)
            self.solve_for_update(jn)
            self.crash_exchange(jb, jn, pivot, 0)
            info.basis_repairs += 1
            self.control.debug(
                f" basis repair: |pivot| = {abs(pivot):.2e}\n", 3)

    def _run_pivot_native(self, info: Info, remaining, call, label: str):
        """Chunked driver for the native starting-basis pivot loops.
        Returns (dependent, inconsistent, updates, stability_pivots) or
        None when the native kernel is unavailable."""
        from .crossover import _xover_native_ctx
        ctx = _xover_native_ctx(self)
        if ctx is None:
            return None
        import time as _t
        lib, handle = ctx
        if not hasattr(lib, "_pivot_ready"):
            import ctypes as ct
            I = ct.c_int64
            D = ct.c_double
            P_ = ct.c_void_p
            IA = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            DA = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
            tail = [D, IA, IA, D, IA, IA, IA, DA, DA, I, IA]
            lib.ipxlu_pivot_free_in.restype = I
            lib.ipxlu_pivot_free_in.argtypes = [P_, IA, IA, DA, DA] + tail
            lib.ipxlu_pivot_fixed_out.restype = I
            lib.ipxlu_pivot_fixed_out.argtypes = [P_, IA, IA, DA, DA] + tail
            lib._pivot_ready = True
        m, n = self.model.num_rows, self.model.num_cols
        stack = np.zeros(n + m, dtype=np.int64)
        stack[:len(remaining)] = remaining
        nstack = np.array([len(remaining)], dtype=np.int64)
        fresh = np.array([1 if self.factorization_is_fresh else 0],
                         dtype=np.int64)
        flags = np.zeros(4, dtype=np.int64)
        ic = np.zeros(8, dtype=np.int64)
        dc = np.zeros(4, dtype=np.float64)
        fills = np.zeros(256, dtype=np.float64)
        nfills = np.zeros(1, dtype=np.int64)
        st = dict(stack=stack, nstack=nstack, fresh=fresh, flags=flags,
                  ic=ic, dc=dc, fills=fills, cap=256, nfills=nfills)
        while True:
            ret = int(call(lib, handle, _t.monotonic() + 1.0, st))
            self.fill_factors.extend(fills[:int(nfills[0])].tolist())
            if ret == 3:
                self.control.interval_log(
                    f" {int(nstack[0])} {label} variables remaining\n")
                try:
                    self.control.interrupt_check()
                except Exception:
                    info.errflag = int(Errflag.INTERRUPT_TIME)
                    break
                continue
            if ret != 0:
                info.errflag = int(ret)
            break
        self.num_ftran += int(ic[2])
        self.num_ftran_sparse += int(ic[3])
        self.num_btran += int(ic[4])
        self.num_btran_sparse += int(ic[5])
        self.num_updates += int(ic[6])
        self.num_factorizations += int(ic[7])
        self.time_ftran += float(dc[0])
        self.time_btran += float(dc[1])
        self.time_update += float(dc[2])
        self.time_factorize += float(dc[3])
        self.factorization_is_fresh = bool(fresh[0])
        self.lu._pivottol = float(
            self.lu.lib.ipxlu_get_pivottol(self.lu.handle))
        return int(flags[0]), int(flags[1]), int(flags[2]), int(flags[3])

    def pivot_free_variables_into_basis(self, colweights: np.ndarray,
                                        info: Info) -> None:
        """reference: src/basis.cc:676-781"""
        md = self.model
        m, n = md.num_rows, md.num_cols
        ftran = IndexedVector(m)
        dependency_tol = max(0.0, self.control.parameters.dependency_tol)
        info.errflag = 0
        info.dependent_cols = 0
        stability_pivots = 0

        remaining = np.nonzero(np.isinf(colweights)
                               & (self.map2basis < 0))[0].tolist()
        self.control.debug(
            Control.textline("Number of free variables nonbasic:")
            + f"{len(remaining)}\n")
        if not remaining:
            return

        self.control.reset_print_interval()
        cw = np.ascontiguousarray(colweights, dtype=np.float64)
        c_ = np.ascontiguousarray(md.c, dtype=np.float64)
        out = self._run_pivot_native(
            info, remaining,
            lambda lib, handle, pause, st: lib.ipxlu_pivot_free_in(
                handle, self.basis, self.map2basis, cw, c_,
                dependency_tol, st["stack"], st["nstack"], pause,
                st["fresh"], st["flags"], st["ic"], st["dc"],
                st["fills"], st["cap"], st["nfills"]), "free")
        if out is not None:
            dep, inconsistent, updates, stab = out
            info.dependent_cols = dep
            if inconsistent:
                info.cols_inconsistent = 1
            info.updates_start += updates
            self.control.debug(
                Control.textline("Number of free variables swapped for "
                                 "stability:") + f"{stab}\n")
            return
        while remaining:
            jn = remaining[-1]
            try:
                self.control.interrupt_check()
            except Exception:
                info.errflag = int(Errflag.INTERRUPT_TIME)
                return

            self.solve_for_update(jn, ftran)
            nz = ftran.nonzero_indices()
            vals = ftran.values[nz]
            absvals = np.abs(vals)
            weights_basic = colweights[self.basis[nz]]
            free_mask = np.isinf(weights_basic)
            fmax = pmax = 0.0
            pmax = -1
            if absvals.size:
                k = int(np.argmax(absvals))
                fmax = absvals[k]
                pmax = int(nz[k])
            nonfree = ~free_mask
            fmax_nonfree = 0.0
            pmax_nonfree = -1
            if np.any(nonfree):
                k = int(np.argmax(absvals * nonfree))
                if nonfree[k]:
                    fmax_nonfree = absvals[k]
                    pmax_nonfree = int(nz[k])

            if fmax > 4.0 and fmax_nonfree < 1.0:
                jb = int(self.basis[pmax])
                info.errflag, exchanged = self.exchange_if_stable(
                    jb, jn, ftran.values[pmax], -1)
                if info.errflag:
                    return
                if not exchanged:
                    continue
                remaining.pop()
                remaining.append(jb)
                info.updates_start += 1
                stability_pivots += 1
            elif fmax_nonfree <= dependency_tol:
                # jn cannot enter: column dependent on free basic columns.
                # Unbounded-primal-ray test (objective change of unit
                # increase in x[jn]).
                if not info.cols_inconsistent:
                    c = md.c
                    delta_obj = c[jn]
                    fb = self.basis[nz]
                    sel = np.isinf(colweights[fb])
                    delta_obj -= float(c[fb[sel]] @ vals[sel])
                    if abs(delta_obj) > dependency_tol:
                        self.control.debug(
                            Control.textline(
                                "Unbounded primal ray with objective "
                                "change:") + f"{delta_obj:.2e}\n")
                        info.cols_inconsistent = 1
                info.dependent_cols += 1
                remaining.pop()
            else:
                jb = int(self.basis[pmax_nonfree])
                info.errflag, exchanged = self.exchange_if_stable(
                    jb, jn, ftran.values[pmax_nonfree], -1)
                if info.errflag:
                    return
                if not exchanged:
                    continue
                remaining.pop()
                info.updates_start += 1
            self.control.interval_log(
                f" {len(remaining)} free variables remaining\n")
        self.control.debug(
            Control.textline("Number of free variables swapped for "
                             "stability:") + f"{stability_pivots}\n")

    def pivot_fixed_variables_out_of_basis(self, colweights: np.ndarray,
                                           info: Info) -> None:
        """reference: src/basis.cc:783-914"""
        md = self.model
        m, n = md.num_rows, md.num_cols
        btran = IndexedVector(m)
        row = IndexedVector(n + m)
        dependency_tol = max(0.0, self.control.parameters.dependency_tol)
        info.errflag = 0
        info.dependent_rows = 0
        stability_pivots = 0

        # rhs after subtracting fixed columns (dual unboundedness test)
        lb, ub = md.lb, md.ub
        fixed_nonzero = (lb == ub) & (lb != 0.0)
        xfix = np.where(fixed_nonzero, lb, 0.0)
        b_minus_fixed = md.b - md.AI_mul(xfix)

        remaining = (n + np.nonzero((colweights[n:] == 0.0)
                                    & (self.map2basis[n:] >= 0))[0]).tolist()
        self.control.debug(
            Control.textline("Number of fixed variables basic:")
            + f"{len(remaining)}\n")
        if not remaining:
            return

        self.control.reset_print_interval()
        cw = np.ascontiguousarray(colweights, dtype=np.float64)
        bmf = np.ascontiguousarray(b_minus_fixed, dtype=np.float64)
        out = self._run_pivot_native(
            info, remaining,
            lambda lib, handle, pause, st: lib.ipxlu_pivot_fixed_out(
                handle, self.basis, self.map2basis, cw, bmf,
                dependency_tol, st["stack"], st["nstack"], pause,
                st["fresh"], st["flags"], st["ic"], st["dc"],
                st["fills"], st["cap"], st["nfills"]), "fixed")
        if out is not None:
            dep, inconsistent, updates, stab = out
            info.dependent_rows = dep
            if inconsistent:
                info.rows_inconsistent = 1
            info.updates_start += updates
            self.control.debug(
                Control.textline("Number of fixed variables swapped for "
                                 "stability:") + f"{stab}\n")
            return
        while remaining:
            jb = remaining[-1]
            try:
                self.control.interrupt_check()
            except Exception:
                info.errflag = int(Errflag.INTERRUPT_TIME)
                return

            self.tableau_row(jb, btran, row)
            nz = row.nonzero_indices()
            vals = row.values[nz]
            absvals = np.abs(vals)
            # ignore structural variables with zero weight
            considered = (nz >= n) | (colweights[nz] != 0.0)
            rmax = 0.0
            jmax = -1
            if np.any(considered):
                k = int(np.argmax(absvals * considered))
                if considered[k]:
                    rmax = absvals[k]
                    jmax = int(nz[k])
            nonfixed = colweights[nz] != 0.0
            rmax_nonfixed = 0.0
            jmax_nonfixed = -1
            if np.any(nonfixed):
                k = int(np.argmax(absvals * nonfixed))
                if nonfixed[k]:
                    rmax_nonfixed = absvals[k]
                    jmax_nonfixed = int(nz[k])

            if rmax > 4.0 and rmax_nonfixed < 1.0:
                info.errflag, exchanged = self.exchange_if_stable(
                    jb, jmax, row.values[jmax], 1)
                if info.errflag:
                    return
                if not exchanged:
                    continue
                remaining.pop()
                remaining.append(jmax)
                info.updates_start += 1
                stability_pivots += 1
            elif rmax_nonfixed <= dependency_tol:
                # jb cannot leave: rows without it are dependent.
                # Unbounded-dual-ray test.
                if not info.rows_inconsistent:
                    delta_obj = float(btran.values @ b_minus_fixed)
                    if abs(delta_obj) > dependency_tol:
                        self.control.debug(
                            Control.textline(
                                "Unbounded dual ray with objective change:")
                            + f"{delta_obj:.2e}\n")
                    if abs(delta_obj) > dependency_tol:
                        info.rows_inconsistent = 1
                info.dependent_rows += 1
                remaining.pop()
            else:
                # choose stable pivot maximizing basis volume
                eligible = absvals >= 0.1 * rmax_nonfixed
                scaled = np.where(eligible, absvals * colweights[nz], -1.0)
                k = int(np.argmax(scaled))
                assert scaled[k] >= 0.0
                jmax_scaled = int(nz[k])
                pivot = row.values[jmax_scaled]
                info.errflag, exchanged = self.exchange_if_stable(
                    jb, jmax_scaled, pivot, 1)
                if info.errflag:
                    return
                if not exchanged:
                    continue
                remaining.pop()
                info.updates_start += 1
            self.control.interval_log(
                f" {len(remaining)} fixed variables remaining\n")
        self.control.debug(
            Control.textline("Number of fixed variables swapped for "
                             "stability:") + f"{stability_pivots}\n")

    # -- condition estimation / analysis --------------------------------
    def min_singular_value(self) -> float:
        """Power method on inv(B B') (reference: src/basis.cc:387-397,
        src/power_method.h:18-42)."""
        m = self.model.num_rows
        if m == 0:
            return INF
        rng = np.random.default_rng(0)
        v = rng.standard_normal(m)
        v /= np.linalg.norm(v)
        lam = 0.0
        for _ in range(100):
            fv = self.solve_dense(v, "N")
            fv = self.solve_dense(fv, "T")
            lam_new = float(np.linalg.norm(fv))
            if lam_new == 0.0:
                return INF
            v = fv / lam_new
            if abs(lam_new - lam) <= 1e-3 * lam_new:
                lam = lam_new
                break
            lam = lam_new
        return float(np.sqrt(1.0 / lam)) if lam > 0 else INF

    def symbolic_invert(self):
        """Row/column nnz counts of inv(B)
        (reference: src/symbolic_invert.cc)."""
        from .symbolic_invert import symbolic_invert
        return symbolic_invert(self.model, self.basis)

    def density_inverse(self) -> float:
        m = self.model.num_rows
        rowcounts, _ = self.symbolic_invert()
        return float(np.sum(rowcounts / m)) / m

    # -- stats accessors used by LpSolver --------------------------------
    @property
    def frac_ftran_sparse(self) -> float:
        return self.num_ftran_sparse / self.num_ftran if self.num_ftran \
            else 0.0

    @property
    def frac_btran_sparse(self) -> float:
        return self.num_btran_sparse / self.num_btran if self.num_btran \
            else 0.0

    @property
    def mean_fill(self) -> float:
        if not self.fill_factors:
            return 0.0
        return float(np.exp(np.mean(np.log(np.maximum(
            self.fill_factors, 1e-300)))))

    @property
    def max_fill(self) -> float:
        return max(self.fill_factors) if self.fill_factors else 0.0
