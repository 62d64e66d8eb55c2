"""Symbolic structure of inv(B): per-row/column nonzero counts.

Counterpart of the reference symbolic inverse (reference:
src/symbolic_invert.cc): computes nnz counts per row and column of inv(B)
without forming it, via block-triangular form + reachability on the quotient
(condensation) graph. Re-architected over scipy.sparse.csgraph: perfect
matching -> strongly connected components -> reachability counts on the
condensation DAG.

The port's copy of ipx_tpu/basis/symbolic_invert.py.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.csgraph as csgraph

from ..model import Model


def symbolic_invert(model: Model, basis: np.ndarray):
    """Returns (rowcounts, colcounts): structural nnz per row / column of
    inv(B) where B = AI[:, basis]."""
    m, n = model.num_rows, model.num_cols
    # build B pattern
    cols = []
    A = model.A
    rows_idx = []
    cols_idx = []
    for p, j in enumerate(basis):
        if j < n:
            seg = slice(A.indptr[j], A.indptr[j + 1])
            ri = A.indices[seg]
        else:
            ri = np.array([j - n])
        rows_idx.append(ri)
        cols_idx.append(np.full(ri.shape, p))
    ri = np.concatenate(rows_idx)
    ci = np.concatenate(cols_idx)
    B = sp.csc_matrix((np.ones(ri.size), (ri, ci)), shape=(m, m))

    # match rows to columns (B is nonsingular so a perfect matching exists
    # structurally; fall back gracefully if not)
    match = csgraph.maximum_bipartite_matching(B.tocsr(), perm_type="column")
    if np.any(match < 0):
        # structurally singular (shouldn't happen for a factorized basis)
        match = np.where(match < 0, np.arange(m), match)

    # permuted pattern: G[i, k] with diagonal matched; SCCs of G give the
    # block triangular form
    Bp = B[:, match]
    ncomp, labels = csgraph.connected_components(Bp, directed=True,
                                                 connection="strong")
    # condensation DAG: edge c1 -> c2 if Bp has entry (i in c1, k in c2)
    coo = Bp.tocoo()
    mask = labels[coo.row] != labels[coo.col]
    edges = np.unique(np.stack([labels[coo.row], labels[coo.col]], axis=1)
                      [mask], axis=0) if np.any(mask) else \
        np.empty((0, 2), dtype=np.int64)
    C = sp.csr_matrix((np.ones(edges.shape[0]),
                       (edges[:, 0], edges[:, 1])), shape=(ncomp, ncomp))

    # inv(B) structure: entry (k, i) of inv(Bp) is structurally nonzero iff
    # component of i reaches component of k in the condensation. Compute the
    # transitive closure on the (usually tiny) condensation.
    # comp_size[c] = number of rows/cols in component c
    comp_size = np.bincount(labels, minlength=ncomp)
    # reachability: closure[c1, c2] = 1 if c1 reaches c2
    reach = csgraph.shortest_path(C, method="D", unweighted=True) < np.inf
    # colcounts of inv(Bp): column i has nonzeros at rows k whose component
    # is reached FROM component(i)... inv entries flow along dependencies:
    # (inv(Bp))[k, i] != 0 iff comp(k) reaches comp(i) in C' (transposed
    # convention). Count both directions symmetrically:
    reach_counts_from = reach @ comp_size          # rows reachable from c
    reach_counts_to = reach.T @ comp_size          # rows that reach c
    colcounts_p = reach_counts_to[labels]          # per permuted column
    rowcounts_p = reach_counts_from[labels]        # per permuted row

    # Map back to B. With Bp = B Q (Q[k, j] = 1 iff match[j] = k):
    # inv(B) = Q inv(Bp), so row k of inv(B) is row inv_match[k] of
    # inv(Bp) while columns are unpermuted.
    inv_match = np.empty(m, dtype=np.int64)
    inv_match[match] = np.arange(m)
    rowcounts = rowcounts_p[inv_match].astype(np.int64)
    colcounts = colcounts_p.astype(np.int64)
    return rowcounts, colcounts
