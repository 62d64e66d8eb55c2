"""Abstract KKT solver interface.

Solves systems with the KKT matrix

    [ G   AI' ] (x) = (a)
    [ AI   0  ] (y)   (b)

where G is a positive semidefinite diagonal built from the IPM iterate. An
iterative implementation must return a solution with residual (res) in the
first block satisfying infnorm(D*res) <= tol with D = sqrt(1/G)
(reference: src/kkt_solver.h:11-68).

The port's copy of ipx_tpu/kkt/base.py.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..info import Info


class KKTSolver:
    def factorize(self, iterate, info: Info) -> None:
        """Prepare preconditioner / factorization from the iterate. May be
        called with iterate=None, meaning G = identity."""
        self._factorize(iterate, info)

    def solve(self, a: np.ndarray, b: np.ndarray, tol: float,
              info: Info, y0: Optional[np.ndarray] = None):
        """Returns (x, y) solving the KKT system to tolerance tol. y0 is an
        optional initial guess for the dual (row) part; implementations may
        use it to warm-start an iterative solve (the reference always starts
        from zero, reference: src/conjugate_residuals.cc:33-36)."""
        return self._solve(a, b, tol, info, y0)

    @property
    def iter(self) -> int:
        """Linear solver iterations in all solve() calls since the last
        factorize()."""
        return self._iter()

    @property
    def basis_changes(self) -> int:
        return self._basis_changes()

    # `basis` is a plain attribute: None for solvers without a basis matrix
    # (diag), set by implementations that maintain one (KKTSolverBasis).
    basis = None

    # -- implementation hooks -----------------------------------------
    def _factorize(self, iterate, info: Info) -> None:
        raise NotImplementedError

    def _solve(self, a, b, tol, info, y0=None):
        raise NotImplementedError

    def _iter(self) -> int:
        raise NotImplementedError

    def _basis_changes(self) -> int:
        return 0

    def _basis(self):
        return None
