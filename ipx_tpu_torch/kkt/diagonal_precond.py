"""Diagonal preconditioner for the normal matrix, with optional dense-column
splitting via Sherman-Morrison-Woodbury.

Counterpart of the reference diagonal preconditioner (reference:
src/diagonal_precond.{h,cc}). The preconditioner is

    P = diag(AI W AI')            (dense columns excluded if splitting)
      [ + Ad Wd Ad' as a low-rank term handled by SMW ]

with inv(P) = inv(E) - inv(E) Ad inv(S) Ad' inv(E), where E is the diagonal
part and S = inv(Wd) + Ad' inv(E) Ad is an ndense x ndense Schur complement
factorized by dense Cholesky (reference: src/diagonal_precond.cc:48-101).

The port's copy of ipx_tpu/kkt/diagonal_precond.py.
"""
from __future__ import annotations

from time import perf_counter
from typing import Optional

import numpy as np
import scipy.linalg as sla

from ..info import Info
from ..model import Model
from ..status import Errflag
from .cr import LinearOperator


class DiagonalPrecond(LinearOperator):
    def __init__(self, model: Model):
        self.model = model
        self.diagonal = np.zeros(model.num_rows)
        self.Adense = None          # m x ndense dense array (columns of A)
        self.chol = None            # Cholesky factor of Schur complement
        self.factorized = False
        self.time = 0.0

    def reset_time(self) -> None:
        self.time = 0.0

    def factorize(self, W: Optional[np.ndarray], precond_dense_cols: bool,
                  info: Info) -> None:
        md = self.model
        m, n = md.num_rows, md.num_cols
        self.factorized = False

        dense_cols = (md.dense_column_indices()
                      if precond_dense_cols and md.num_dense_cols > 0
                      else np.empty(0, dtype=np.int64))
        sparse_mask = np.ones(n, dtype=bool)
        sparse_mask[dense_cols] = False

        # diagonal of AI W AI' excluding dense columns
        A2 = md.A.copy()
        A2.data = A2.data * A2.data
        if W is not None:
            wcol = W[:n] * sparse_mask
            self.diagonal = A2 @ wcol + W[n:]
        else:
            self.diagonal = A2 @ sparse_mask.astype(np.float64)

        if dense_cols.size:
            # SMW for the dense part: S = inv(Wd) + Ad' inv(E) Ad
            Ad = md.A[:, dense_cols].toarray()
            Einv_Ad = Ad / self.diagonal[:, None]
            S = Ad.T @ Einv_Ad
            wd = W[dense_cols] if W is not None else np.ones(dense_cols.size)
            S[np.diag_indices_from(S)] += 1.0 / wd
            try:
                self.chol = sla.cho_factor(S, lower=True)
            except sla.LinAlgError:
                info.errflag = int(Errflag.LAPACK_CHOL)
                return
            self.Adense = Ad
        else:
            self.Adense = None
            self.chol = None
        self.factorized = True

    def _apply(self, rhs: np.ndarray, want_dot: bool):
        t0 = perf_counter()
        assert self.factorized
        if self.Adense is not None:
            e_rhs = rhs / self.diagonal
            w = self.Adense.T @ e_rhs
            w = sla.cho_solve(self.chol, w)
            lhs = (rhs - self.Adense @ w) / self.diagonal
        else:
            lhs = rhs / self.diagonal
        dot = float(lhs @ rhs) if want_dot else None
        self.time += perf_counter() - t0
        return lhs, dot
