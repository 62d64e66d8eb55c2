"""Host-side sparse matrix helpers.

The reference implements its own CSC container with queued column building
(reference: src/sparse_matrix.{h,cc}). Here the host representation is
scipy.sparse (CSC/CSR) — already native C — and this module adds only the
pieces scipy lacks: strict validation of user input in IPX semantics, the
fused normal-matrix products, and conversion into the padded device layout
used by the JAX/Pallas compute path (ipx_tpu.ops).

The port's copy of ipx_tpu/sparse.py.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp


def csc_from_arrays(num_rows: int, num_cols: int, Ap, Ai, Ax) -> sp.csc_matrix:
    """Build a CSC matrix from raw arrays without copying when possible."""
    Ap = np.asarray(Ap, dtype=np.int64)
    Ai = np.asarray(Ai, dtype=np.int64)
    Ax = np.asarray(Ax, dtype=np.float64)
    A = sp.csc_matrix((Ax, Ai, Ap), shape=(num_rows, num_cols))
    return A


# ----------------------------------------------------------------------
# Fused normal-matrix products on host (correctness reference for the
# device kernels; reference: src/sparse_matrix.cc AddNormalProduct and
# src/normal_matrix.cc one-pass strategy).
# ----------------------------------------------------------------------

def normal_apply(A_csc: sp.csc_matrix, A_csr: sp.csr_matrix,
                 W: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Compute (AI diag(W) AI') v where AI = [A I] and W has length n+m.

    = A (W[:n] * (A' v)) + W[n:] * v.
    """
    n = A_csc.shape[1]
    u = v @ A_csr            # A' v, computed row-major over CSR
    u = u * W[:n]
    out = A_csc @ u
    out += W[n:] * v
    return out


def normal_diag(A_csc: sp.csc_matrix, W: np.ndarray) -> np.ndarray:
    """diag(AI diag(W) AI') = sum_j W[j]*A[:,j]^2 + W[n:].

    Used for the diagonal preconditioner
    (reference: src/diagonal_precond.cc:17-46).
    """
    m, n = A_csc.shape
    A2 = A_csc.copy()
    A2.data = A2.data * A2.data
    d = A2 @ W[:n]
    d += W[n:]
    return np.asarray(d)


def column_norms_sq(A_csc: sp.csc_matrix) -> np.ndarray:
    A2 = A_csc.copy()
    A2.data = A2.data * A2.data
    return np.asarray(A2.sum(axis=0)).ravel()


def find_dense_columns(A_csc: sp.csc_matrix, max_dense: int = 1000
                       ) -> np.ndarray:
    """Classify "dense" columns of A: the k densest columns such that each has
    more than max(40, 10x the nnz of the densest non-dense column) entries;
    abort (return empty) if more than max_dense columns qualify
    (reference: src/model.cc:34-56).
    """
    n = A_csc.shape[1]
    counts = np.diff(A_csc.indptr)
    order = np.argsort(-counts, kind="stable")  # decreasing nnz
    sorted_counts = counts[order]
    ndense = 0
    # find the split: column k is dense if count > max(40, 10*count[k+1])
    for k in range(min(n - 1, max_dense)):
        if sorted_counts[k] > max(40, 10 * sorted_counts[k + 1]):
            ndense = k + 1
            break
    if ndense == 0 or ndense > max_dense:
        return np.empty(0, dtype=np.int64)
    return np.sort(order[:ndense])


# ----------------------------------------------------------------------
# Device layout: flattened COO-ish arrays padded to a lane multiple, with
# rows/cols sorted for efficient segment reductions on TPU.
# ----------------------------------------------------------------------

class DeviceMatrix:
    """Static-shape flattened layout of A for the JAX compute path.

    Stores the nonzeros twice — once sorted by row (CSR order) and once by
    column (CSC order) — each padded to `pad_to` so every jit trace sees one
    static shape. The padding entries carry index = num_rows (or num_cols)
    and value = 0 so segment reductions drop them naturally.
    """

    def __init__(self, A_csc: sp.csc_matrix, pad_to: int = 512):
        m, n = A_csc.shape
        self.shape = (m, n)
        coo = A_csc.tocoo()
        nnz = coo.nnz
        cap = max(pad_to, -(-max(nnz, 1) // pad_to) * pad_to)
        self.nnz = nnz
        self.capacity = cap

        def pad(ix, dtype, fill):
            out = np.full(cap, fill, dtype=dtype)
            out[:nnz] = ix
            return out

        # CSC order (sorted by column): for A' v products
        csc_order = np.argsort(coo.col, kind="stable")
        self.csc_rows = pad(coo.row[csc_order], np.int32, m)
        self.csc_cols = pad(coo.col[csc_order], np.int32, n)
        self.csc_vals = pad(coo.data[csc_order], np.float64, 0.0)
        # CSR order (sorted by row): for A u products
        csr_order = np.argsort(coo.row, kind="stable")
        self.csr_rows = pad(coo.row[csr_order], np.int32, m)
        self.csr_cols = pad(coo.col[csr_order], np.int32, n)
        self.csr_vals = pad(coo.data[csr_order], np.float64, 0.0)
