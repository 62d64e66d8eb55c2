"""Crash-basis guess: 3-stage column selection.

Counterpart of the reference crash procedure (reference: src/guess_basis.cc):
(1) incomplete left-looking LU over columns with infinite weight (free
    variables), with topological pattern DFS and pivot threshold 1e-3;
(2) singleton columns whose weighted entry is at least half the row max;
(3) maximum-cardinality matching of remaining columns in decreasing weight
    order via augmenting paths, giving up after 10x the remaining deficit of
    failures;
completed with slack columns for unmatched rows.

The port's copy of ipx_tpu/basis/guess_basis.py.
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..control import Control
from ..model import Model
from .sparse_utils import augmenting_path, depth_first_search

LU_DEPENDENCY_TOL = 1e-3
INF = np.inf


def guess_basis(control: Control, model: Model,
                colweights: np.ndarray) -> np.ndarray:
    m, n = model.num_rows, model.num_cols
    basis: List[int] = []
    rownumber = np.full(m, -1, dtype=np.int64)
    active = np.ones(n + m, dtype=bool)

    _process_free_columns(control, model, colweights, basis, rownumber,
                          active)
    _process_singletons(control, model, colweights, basis, rownumber, active)
    _process_remaining(control, model, colweights, basis, rownumber, active)

    # complete with slack columns for uncovered rows
    for i in np.nonzero(rownumber < 0)[0]:
        basis.append(n + int(i))
    assert len(basis) == m
    return np.asarray(basis, dtype=np.int64)


def _process_free_columns(control, model, weights, basis, rownumber, active):
    """Incomplete left-looking LU over free columns
    (reference: src/guess_basis.cc:66-108). Uses the native kernel when
    available; pure-Python fallback below."""
    m, n = model.num_rows, model.num_cols
    free_cols = np.nonzero(np.isinf(weights))[0]
    num_free = 0
    if free_cols.size == 0:
        return
    try:
        import ctypes
        from .lu import _load_lib
        lib = _load_lib()
        if not hasattr(lib, "_guessfree_ready"):
            I = ctypes.c_int64
            IA = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            DA = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
            BA = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
            lib.ipxlu_guess_free.restype = I
            lib.ipxlu_guess_free.argtypes = [I, IA, IA, DA, I, IA, IA, I, BA]
            lib._guessfree_ready = True
        A = model.A
        Ap = np.ascontiguousarray(A.indptr, dtype=np.int64)
        Ai = np.ascontiguousarray(A.indices, dtype=np.int64)
        Ax = np.ascontiguousarray(A.data, dtype=np.float64)
        # free columns are structural only (slacks always have a finite
        # bound); assert defensively and fall back otherwise
        if free_cols.size and free_cols.max() >= n:
            raise RuntimeError("free slack column")
        order = np.ascontiguousarray(free_cols, dtype=np.int64)
        chosen = np.zeros(order.size, dtype=np.int8)
        num_free = int(lib.ipxlu_guess_free(m, Ap, Ai, Ax, order.size,
                                            order, rownumber, len(basis),
                                            chosen))
        basis.extend(int(j) for j, f in zip(order, chosen) if f)
        active[free_cols] = False
        control.debug(
            Control.textline("Number of free variables in starting basis:")
            + f"{num_free}\n")
        return
    except Exception:
        pass
    # L columns stored as (rows, values) lists; row indices unpermuted.
    Lcols_rows: List[np.ndarray] = []
    Lcols_vals: List[np.ndarray] = []
    # concatenated pattern arrays for DFS: built incrementally
    Lp = [0]
    Li: List[int] = []
    lhs = np.zeros(m)
    marked = np.full(m, -1, dtype=np.int64)
    istack = np.empty(m, dtype=np.int64)
    work = np.empty(m, dtype=np.int64)

    for j in free_cols:
        bi, bx = model.AI_col(int(j))
        Lp_arr = np.asarray(Lp, dtype=np.int64)
        Li_arr = np.asarray(Li, dtype=np.int64)
        # pattern of L \ AI[:,j] via DFS (neighbours of node i = column
        # rownumber[i] of L)
        top = m
        for i in bi:
            if marked[i] != j:
                top = depth_first_search(int(i), Lp_arr, Li_arr, rownumber,
                                         top, istack, marked, int(j), work)
        pattern = istack[top:m]
        # numeric phase in topological order
        lhs[pattern] = 0.0
        lhs[bi] = bx
        lhsmax = 0.0
        imax = -1
        for i in pattern:
            temp = lhs[i]
            k = rownumber[i]
            if temp != 0.0:
                if k >= 0:
                    seg = slice(Lp[k], Lp[k + 1])
                    rows = Lcols_rows[k]
                    lhs[rows] -= Lcols_vals[k] * temp
                elif abs(temp) > lhsmax:
                    lhsmax = abs(temp)
                    imax = int(i)
        pivot = lhs[imax] if imax >= 0 else 0.0
        if abs(pivot) > LU_DEPENDENCY_TOL:
            rownumber[imax] = len(basis)
            basis.append(int(j))
            # new L column: off-diagonals restricted to pattern of AI[:,j]
            sel = (rownumber[bi] < 0) & (lhs[bi] != 0.0)
            rows = bi[sel]
            vals = lhs[rows] / pivot
            Lcols_rows.append(rows.astype(np.int64))
            Lcols_vals.append(vals)
            Li.extend(rows.tolist())
            Lp.append(len(Li))
            num_free += 1
        active[j] = False
    control.debug(
        Control.textline("Number of free variables in starting basis:")
        + f"{num_free}\n")


def _process_singletons(control, model, weights, basis, rownumber, active):
    """Singleton columns with weighted entry >= 0.5 x row max
    (reference: src/guess_basis.cc:112-146). Vectorized: per-row maxima of
    |entry|*weight over active columns and over active singleton columns via
    sparse reductions; the sequential greedy is preserved because selecting a
    singleton never deactivates another row's candidates (each singleton
    column touches exactly one row)."""
    m, n = model.num_rows, model.num_cols
    A_csr = model.A_csr
    colcount = np.diff(model.A.indptr)

    rows_of = np.repeat(np.arange(m), np.diff(A_csr.indptr))
    cols_of = A_csr.indices
    # inactive columns contribute 0 (guarding inf*0 for free columns)
    with np.errstate(invalid="ignore"):
        w = np.where(active[cols_of],
                     np.abs(A_csr.data) * weights[cols_of], 0.0)
    w = np.nan_to_num(w, nan=0.0, posinf=0.0)
    rowmax = np.zeros(m)
    np.maximum.at(rowmax, rows_of, w)
    # best singleton per row (structural)
    single = (colcount[cols_of] == 1) & active[cols_of]
    ws = np.where(single, w, 0.0)
    singmax = np.zeros(m)
    np.maximum.at(singmax, rows_of, ws)
    # index of the best structural singleton per row: scatter argmax
    best_j = np.full(m, -1, dtype=np.int64)
    hit = ws > 0
    order = np.argsort(ws[hit], kind="stable")
    hi_rows = rows_of[hit][order]
    hi_cols = cols_of[hit][order]
    best_j[hi_rows] = hi_cols          # last write = max (sorted ascending)

    # slack columns: weight (|entry| = 1), active, singleton by construction
    slack_w = weights[n:] * active[n:]
    rowmax = np.maximum(rowmax, slack_w)
    use_slack = slack_w > singmax
    singmax = np.where(use_slack, slack_w, singmax)
    best_j = np.where(use_slack, n + np.arange(m), best_j)

    sel = (rownumber < 0) & (singmax > 0.0) & (singmax >= 0.5 * rowmax) \
        & (best_j >= 0)
    num_singletons = 0
    for i in np.nonzero(sel)[0]:
        j = int(best_j[i])
        if not active[j]:
            continue            # already taken by an earlier row
        rownumber[i] = len(basis)
        basis.append(j)
        active[j] = False
        num_singletons += 1
    control.debug(
        Control.textline("Number of singletons in starting basis:")
        + f"{num_singletons}\n")


def _process_remaining(control, model, weights, basis, rownumber, active):
    """Weight-ordered maximum matching via augmenting paths
    (reference: src/guess_basis.cc:151-204)."""
    m, n = model.num_rows, model.num_cols
    A = model.A
    # AI column pattern arrays including slack columns
    nnzA = A.indptr[-1]
    Ap = np.concatenate([A.indptr.astype(np.int64),
                         nnzA + 1 + np.arange(m, dtype=np.int64)])
    Ai = np.concatenate([A.indices.astype(np.int64),
                         np.arange(m, dtype=np.int64)])
    # decreasing stable order by weight
    colperm = np.argsort(-np.asarray(weights), kind="stable")

    jmatch = np.full(m, -1, dtype=np.int64)
    jmatch[rownumber >= 0] = -2

    # priority order restricted to active columns with positive weight
    worder = [int(j) for j in colperm
              if active[j] and weights[j] > 0.0]
    worder = np.asarray(worder, dtype=np.int64)

    num_matched, num_failed, matched_cols = _run_matching(
        m, n + m, Ap, Ai, worder, jmatch, m - len(basis), len(basis))
    basis.extend(matched_cols)
    sel = jmatch >= 0
    assert np.all(rownumber[sel] < 0)
    rownumber[sel] = m      # matched marker
    control.debug(
        Control.textline("Number of other columns matched:")
        + f"{num_matched}\n"
        + Control.textline("Number of other columns failed:")
        + f"{num_failed}\n")


def _run_matching(nrows, ncols, Ap, Ai, order, jmatch, deficit, already):
    """Weight-ordered augmenting-path matching; native kernel when
    available, pure-Python fallback otherwise. Returns
    (num_matched, num_failed, matched column list in order)."""
    try:
        from .lu import _load_lib
        import ctypes
        lib = _load_lib()
        if not hasattr(lib, "_matching_ready"):
            I = ctypes.c_int64
            IA = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            BA = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
            lib.ipxlu_matching.restype = I
            lib.ipxlu_matching.argtypes = [I, I, IA, IA, I, IA, IA, I, I,
                                           I, BA]
            lib._matching_ready = True
        matched_out = np.zeros(len(order), dtype=np.int8)
        Ap = np.ascontiguousarray(Ap, dtype=np.int64)
        Ai = np.ascontiguousarray(Ai, dtype=np.int64)
        order = np.ascontiguousarray(order, dtype=np.int64)
        nm = int(lib.ipxlu_matching(nrows, ncols, Ap, Ai, len(order),
                                    order, jmatch, 10,
                                    already + deficit, already,
                                    matched_out))
        matched_cols = [int(j) for j, f in zip(order, matched_out) if f]
        nf = int(np.count_nonzero(matched_out == 0))
        return nm, nf, matched_cols
    except Exception:
        pass
    # fallback: pure Python
    marked = np.full(ncols, -1, dtype=np.int64)
    cheap = np.asarray(Ap[:ncols]).copy()
    work = np.empty(nrows + 1, dtype=np.int64)
    work2 = np.empty(nrows + 1, dtype=np.int64)
    work3 = np.empty(nrows + 1, dtype=np.int64)
    matched_cols = []
    num_matched = num_failed = 0
    size = already
    for j in order:
        if augmenting_path(int(j), Ap, Ai, jmatch, cheap, marked, work,
                           work2, work3):
            matched_cols.append(int(j))
            num_matched += 1
            size += 1
        else:
            num_failed += 1
        if num_failed >= 10 * (already + deficit - size):
            break
    return num_matched, num_failed, matched_cols
