"""Level-scheduled sparse triangular solve on a torch device (port of
``level_solve`` and ``pack`` in tools/device_trisolve_proto.py).

The rows of a triangular matrix T fall into levels: a row's level is one
more than the largest level of the rows its off-diagonal entries name (rows
before it for a lower T, after it for an upper one), 0 if it names none.
The rows of one level depend only on rows of earlier levels, so one sweep
over the levels solves T X = V, each level in one parallel pass:

    X[r] = (V[r] - sum_j T[r, j] X[j]) / T[r, r]    for every row r of level l

K17 ``level_solve`` (csrc/trisolve.cu) runs a whole sweep in one launch on
the current stream, for V of shape (m, B), B contiguous, in float64: the
blocks that own a tile of lanes walk every level, a block barrier between
levels.

The schedule is kept as it is: the rows in level order with a pointer per
level, and their off-diagonal entries as one CSR in the same row order. The
reference's padding to (levels, Rmax) and (levels, Emax), its sentinel row m
and its mode="drop" scatter existed for XLA's static shapes and are not
carried over. Like the reference, the solve applies no row or column
permutation: it sweeps the factor it is given.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from .. import backend, kernels

F64 = torch.float64


@dataclass
class LevelSchedule:
    """The level schedule of an m x m triangular matrix.

    rows (m,) int32: the rows in level order, ascending within a level;
    level_ptr (nlev + 1,) int64, on the host: level l is rows[level_ptr[l]
    : level_ptr[l + 1]], and level_ptr_dev the same on the schedule's
    device (K17's sweep reads it there); entry_ptr (m + 1,) int64, cols
    int32 and vals float64: the off-diagonal entries of rows[p] are cols /
    vals[entry_ptr[p] : entry_ptr[p + 1]], in the order T stores them;
    inv_diag (m,) float64: 1 / T[rows[p], rows[p]]. Rmax and Emax are the most rows and the most
    off-diagonal entries of one level (Emax at least 1), as the reference
    counts them."""

    m: int
    nlev: int
    Rmax: int
    Emax: int
    level_ptr: np.ndarray
    level_ptr_dev: torch.Tensor
    rows: torch.Tensor
    entry_ptr: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    inv_diag: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.vals.device


def levels(T: sp.csr_matrix, lower: bool) -> np.ndarray:
    """The level of every row, visited in the reference's order (0..m-1 for
    a lower T, m-1..0 for an upper one). Every stored entry off the
    diagonal counts, an explicit zero too, as in the reference."""
    T = sp.csr_matrix(T)
    m = T.shape[0]
    indptr, indices = T.indptr, T.indices
    lev = np.zeros(m, dtype=np.int64)
    for i in (range(m) if lower else range(m - 1, -1, -1)):
        deps = indices[indptr[i]:indptr[i + 1]]
        deps = deps[deps < i] if lower else deps[deps > i]
        if len(deps):
            lev[i] = lev[deps].max() + 1
    return lev


def level_schedule(T: sp.csr_matrix, lower: bool,
                   device=None) -> LevelSchedule:
    """The level schedule of the triangular CSR matrix T (lower or upper)
    with its tensors on `device`; by default on the card, as the port's
    other entry points (backend.cuda_device, which raises when there is
    none). "cpu" keeps it on the CPU, for the plain version."""
    device = backend.cuda_device() if device is None else torch.device(
        device)
    T = sp.csr_matrix(T)
    m = T.shape[0]
    if T.shape != (m, m) or m == 0:
        raise ValueError(f"T must be square and not empty, got {T.shape}")
    lev = levels(T, lower)
    nlev = int(lev.max()) + 1
    order = np.argsort(lev, kind="stable")     # by level, then by row
    per_level = np.bincount(lev, minlength=nlev)
    level_ptr = np.concatenate([[0], np.cumsum(per_level)]).astype(np.int64)

    row_of = np.repeat(np.arange(m), np.diff(T.indptr))
    off = T.indices < row_of if lower else T.indices > row_of
    counts = np.bincount(row_of[off], minlength=m)
    # the off-diagonal entries, row by row in level order, each row's in
    # the order T stores them
    rank = np.empty(m, dtype=np.int64)
    rank[order] = np.arange(m)
    take = np.argsort(rank[row_of], kind="stable")
    take = take[off[take]]
    entry_ptr = np.concatenate([[0], np.cumsum(counts[order])]).astype(
        np.int64)
    per_level_entries = np.add.reduceat(counts[order], level_ptr[:-1])
    diag = T.diagonal()

    def t(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dtype).to(device)

    return LevelSchedule(
        m=m, nlev=nlev, Rmax=int(per_level.max()),
        Emax=max(int(per_level_entries.max()), 1), level_ptr=level_ptr,
        level_ptr_dev=t(level_ptr, torch.int64), rows=t(order, torch.int32),
        entry_ptr=t(entry_ptr, torch.int64),
        cols=t(T.indices[take], torch.int32), vals=t(T.data[take], F64),
        inv_diag=t(1.0 / diag[order], F64))


def basis_factors(basis):
    """(L, U) as CSR: scipy's splu (COLAMD) of the basis matrix B = [A I]
    restricted to the basic columns of `basis`, as the reference tool
    builds them (tools/device_trisolve_proto.py:56-65)."""
    import scipy.sparse.linalg as spla
    md = basis.model
    m, n = md.num_rows, md.num_cols
    cols = np.asarray(basis.basis)
    A = md.A.tocsc()
    eye = sp.eye(m, format="csc")
    Bm = sp.hstack([A[:, cols[cols < n]], eye[:, cols[cols >= n] - n]],
                   format="csc").tocsc()
    lu = spla.splu(Bm, permc_spec="COLAMD")
    return lu.L.tocsr(), lu.U.tocsr()


def _check(sched: LevelSchedule, V: torch.Tensor) -> None:
    if V.dim() != 2 or V.shape[0] != sched.m:
        raise ValueError(f"V has shape {tuple(V.shape)}, expected "
                         f"({sched.m}, B)")
    if V.dtype != F64:
        raise ValueError(f"V has dtype {V.dtype}, expected float64")
    if V.device != sched.device:
        raise ValueError(f"V is on {V.device}, the schedule on "
                         f"{sched.device}")


def level_solve_plain(sched: LevelSchedule, V: torch.Tensor) -> torch.Tensor:
    """Plain version of K17: X with T X = V, level by level, each level's
    row sums by index_add_ as the reference's segment_sum."""
    _check(sched, V)
    X = torch.empty_like(V)
    rows, ep = sched.rows.long(), sched.entry_ptr
    for l in range(sched.nlev):
        p0, p1 = int(sched.level_ptr[l]), int(sched.level_ptr[l + 1])
        e0, e1 = int(ep[p0]), int(ep[p1])
        r = rows[p0:p1]
        dst = torch.repeat_interleave(
            torch.arange(p1 - p0, device=V.device), ep[p0 + 1:p1 + 1]
            - ep[p0:p1])
        g = sched.vals[e0:e1, None] * X[sched.cols[e0:e1].long()]
        s = torch.zeros((p1 - p0, V.shape[1]), dtype=F64,
                        device=V.device).index_add_(0, dst, g)
        X[r] = (V[r] - s) * sched.inv_diag[p0:p1, None]
    return X


def level_solve(sched: LevelSchedule, V: torch.Tensor) -> torch.Tensor:
    """K17: X with T X = V for V of shape (m, B), float64. On the CPU the
    plain version; on a card one launch of K17 a sweep."""
    if V.device.type == "cpu":
        return level_solve_plain(sched, V)
    return kernels.level_solve(sched, V)
