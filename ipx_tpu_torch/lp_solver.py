"""LpSolver of the port: ipx_tpu's LpSolver building the port's KKT solvers.

Presolve, the IPM, the starting basis, crossover, postsolve and checkpoints
are inherited; the three places that build a KKT solver
(ipx_tpu/lp_solver.py:481-571) are overridden, and so is clear_model, so
that a second LP on one solver starts from a fresh Model.
"""
from __future__ import annotations

from time import perf_counter
from typing import Optional

from ipx_tpu.ipm import IPM
from ipx_tpu.lp_solver import LpSolver as _LpSolver
from ipx_tpu.model import Model
from ipx_tpu.presolve import Presolver
from ipx_tpu.status import SolveStatus

from .kkt.basis_precond import KKTSolverBasis
from .kkt.diag import KKTSolverDiag
from .parameters import Parameters


class LpSolver(_LpSolver):
    def __init__(self, parameters: Optional[Parameters] = None):
        super().__init__(parameters if parameters is not None
                         else Parameters())

    def clear_model(self) -> None:
        """ipx_tpu's clear_model, then a fresh Model and Presolver. Model.clear
        keeps the native handles that ipx_tpu caches on the Model (the CSC/CSR
        copies and the normal-apply handle); a second LP that reused them
        crashed the process in a native kernel."""
        super().clear_model()
        self.model = Model()
        self.presolver = Presolver(self.user_model, self.model)

    def _compute_starting_point(self, ipm: IPM) -> None:
        t0 = perf_counter()
        kkt = KKTSolverDiag(self.control, self.model)
        ipm.compute_starting_point(kkt, self.iterate, self.info)
        self.info.time_ipm1 += perf_counter() - t0

    def _run_initial_ipm(self, ipm: IPM) -> None:
        """ipx_tpu/lp_solver.py:487-519 with the port's KKTSolverDiag."""
        t0 = perf_counter()
        params = self.control.parameters
        kkt = KKTSolverDiag(self.control, self.model)
        switchiter = params.switchiter
        if switchiter < 0:
            kkt.maxiter = min(500, 10 + self.model.num_rows // 20)
            ipm.maxiter = params.ipm_maxiter
            ipm.phase1_trend_switch = self.model.num_rows >= 5000
        else:
            ipm.maxiter = min(switchiter, params.ipm_maxiter)
        ipm.iteration_callback = self._checkpoint_tick
        ipm.driver(kkt, self.iterate, self.info)
        ipm.phase1_trend_switch = False
        ipm._kkt_iter_hist = []
        info = self.info
        if info.status_ipm == int(SolveStatus.OPTIMAL):
            # still run the basis-preconditioned IPM so that crossover has
            # a starting basis
            info.status_ipm = int(SolveStatus.NOT_RUN)
        elif info.status_ipm == int(SolveStatus.NO_PROGRESS):
            info.status_ipm = int(SolveStatus.NOT_RUN)
        elif info.status_ipm == int(SolveStatus.FAILED):
            info.status_ipm = int(SolveStatus.NOT_RUN)
            info.errflag = 0
        elif info.status_ipm == int(SolveStatus.ITER_LIMIT):
            if info.iter < params.ipm_maxiter:   # stopped at switchiter
                info.status_ipm = int(SolveStatus.NOT_RUN)
        info.time_ipm1 += perf_counter() - t0

    def _run_main_ipm(self, ipm: IPM) -> None:
        t0 = perf_counter()
        kkt = KKTSolverBasis(self.control, self.basis)
        ipm.maxiter = self.control.parameters.ipm_maxiter
        ipm.iteration_callback = self._checkpoint_tick
        ipm.driver(kkt, self.iterate, self.info)
        self.info.time_ipm2 = perf_counter() - t0
