"""KKT solver layer: conjugate residuals on the normal equations with
diagonal (phase 1) or basis (phase 2) preconditioning.

The port's copy of ipx_tpu/kkt/__init__.py.
"""
from .base import KKTSolver
from .cr import ConjugateResiduals
from .diag import KKTSolverDiag

__all__ = ["KKTSolver", "ConjugateResiduals", "KKTSolverDiag"]
