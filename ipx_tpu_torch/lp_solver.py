"""LpSolver: the solver orchestration layer and only public entry point.

Counterpart of the reference solver driver (reference: src/lp_solver.{h,cc}):
presolve -> IPM (phase 1 with diagonal preconditioning, phase 2 with basis
preconditioning) -> crossover -> postsolve, with the reference's status
policy (reference: src/lp_solver.cc:79-95) and phase-switch heuristics
(reference: src/lp_solver.cc:388-397).

The port's copy of ipx_tpu/lp_solver.py. Its KKT solvers are the port's
(kkt/diag.py and kkt/basis_precond.py), which choose the device path;
solve() returns Status.INTERNAL_ERROR, the message logged, before any work
when Parameters.device names a device that is not there or not known
(backend.require: "cuda", the default, without a card or with a kernel
library that does not build), as it does for any error, and never solves
on the host instead; a second LP on one solver is safe because Model.clear
drops the caches of the LP before. A solve runs numpy's and scipy's
OpenBLAS pools on one thread unless the user sized them
(native/threads.py).
"""
from __future__ import annotations

from time import perf_counter
from typing import Optional

import numpy as np

from . import backend
from .control import Control
from .info import Info
from .ipm import IPM
from .iterate import Iterate
from .kkt.diag import KKTSolverDiag
from .model import Model
from .native import threads
from .parameters import Parameters
from .presolve import Presolver
from .status import (Errflag, IPX_BASIC, IPX_NONBASIC_LB, IPX_NONBASIC_UB,
                     IPX_SUPERBASIC, InterruptError, SolveStatus, Status)
from .user_model import BasicSolution, InteriorSolution, UserModel
from .version import __version__

INF = np.inf


class LpSolver:
    def __init__(self, parameters: Optional[Parameters] = None):
        self.control = Control(parameters)
        self.user_model = UserModel()
        self.model = Model()
        self.presolver = Presolver(self.user_model, self.model)
        self.info = Info()
        self.iterate: Optional[Iterate] = None
        self.basis = None
        self.simplex_iterate = None
        self.interior_solution: Optional[InteriorSolution] = None
        self.basic_solution: Optional[BasicSolution] = None
        self.ipm_start: Optional[InteriorSolution] = None
        # checkpoint/resume state (ipx_tpu/checkpoint.py; no reference
        # counterpart — the reference only has user warm starts,
        # reference: src/lp_solver.h:60-66)
        self._resume_ckpt = None       # set by load_checkpoint()
        self._checkpoint = None        # final pre-postsolve snapshot
        self._ckpt_last_write = 0.0

    # ------------------------------------------------------------------
    # Model loading (reference: src/lp_solver.cc:18-52)
    # ------------------------------------------------------------------
    def load_model(self, num_var, obj, lb, ub, num_constr, Ap, Ai, Ax,
                   rhs, constr_type) -> int:
        self.clear_model()
        errflag = self.user_model.load(num_constr, num_var, Ap, Ai, Ax, rhs,
                                       constr_type, obj, lb, ub)
        if errflag:
            return errflag
        self.user_model.get_info(self.info)
        return 0

    def load_ipm_starting_point(self, x, xl, xu, slack, y, zl, zu) -> int:
        self.ipm_start = None
        point = InteriorSolution(
            x=np.asarray(x, dtype=float),
            xl=np.asarray(xl, dtype=float),
            xu=np.asarray(xu, dtype=float),
            slack=np.asarray(slack, dtype=float),
            y=np.asarray(y, dtype=float),
            zl=np.asarray(zl, dtype=float),
            zu=np.asarray(zu, dtype=float))
        errflag = self.user_model.check_interior_point(point)
        if errflag:
            return errflag
        self.ipm_start = point
        return 0

    def load_starting_basis(self, basis_array) -> int:
        """Supplies a starting basis (m solver-model variable indices into
        AI = [A I]) to install at the phase switch instead of crash
        construction; silently falls back to normal construction when the
        supplied basis is singular or inconsistent. Only meaningful with
        dualize=0 (indices must map 1:1). No reference counterpart — used
        by the scenario-batch pipeline to amortize one mean-scenario basis
        across all warm-started finishes."""
        self._preset_basis = np.asarray(basis_array, dtype=np.int64).copy()
        return 0

    # ------------------------------------------------------------------
    # Checkpoint / resume (ipx_tpu/checkpoint.py; capability added beyond
    # the reference, whose only restart path is the user warm start)
    # ------------------------------------------------------------------
    def get_checkpoint(self):
        """Returns the most recent checkpoint dict, or None.

        After solve() this is the final pre-postsolve IPM state (iterate +
        basis); it can be passed to load_checkpoint() on a solver holding
        the same model to continue where this run stopped (e.g. after a
        time or iteration limit).
        """
        from . import checkpoint as _ckpt
        if self._checkpoint is not None:
            return self._checkpoint
        if self.iterate is not None and not self.iterate.postprocessed:
            return _ckpt.build(self.model, self.iterate, self.basis,
                               self.info.iter)
        return None

    def save_checkpoint(self, path: str) -> int:
        from . import checkpoint as _ckpt
        ckpt = self.get_checkpoint()
        if ckpt is None:
            return int(Errflag.INVALID_CHECKPOINT)
        _ckpt.save_npz(ckpt, path)
        return 0

    def load_checkpoint(self, src) -> int:
        """Arms a resume from a checkpoint dict or .npz path.

        The next solve() skips the starting-point procedure and phase 1,
        restores the iterate (and basis, if the checkpoint holds one) and
        continues with basis-preconditioned iterations. The checkpoint must
        match the presolved model (same LP, same dualize/scale settings);
        a mismatch fails the solve with IPX_ERROR_invalid_checkpoint.
        """
        from . import checkpoint as _ckpt
        if isinstance(src, str):
            src = _ckpt.load_npz(src)
        if not isinstance(src, dict) or "fingerprint" not in src \
                or any(k not in src for k in ("x", "xl", "xu", "y", "zl",
                                              "zu", "state", "iter")):
            self._resume_ckpt = None
            return int(Errflag.INVALID_CHECKPOINT)
        self._resume_ckpt = src
        return 0

    def clear_model(self) -> None:
        self.user_model.clear()
        self.model.clear()
        self.presolver.clear()
        self.clear_solution()
        self.ipm_start = None
        self._resume_ckpt = None

    def clear_solution(self) -> None:
        self.iterate = None
        self.basis = None
        self._checkpoint = None
        self._ckpt_last_write = 0.0
        self.simplex_iterate = None
        self.interior_solution = None
        self.basic_solution = None
        self.info = Info()
        self.user_model.get_info(self.info)

    # ------------------------------------------------------------------
    # Solve (reference: src/lp_solver.cc:53-110)
    # ------------------------------------------------------------------
    def solve(self) -> int:
        # numpy's and scipy's BLAS pools on one thread for the solve, unless
        # the user sized them (native/threads.py)
        with threads.quiet_blas():
            return self._solve()

    def _solve(self) -> int:
        self.clear_solution()
        info = self.info
        if self.user_model.empty():
            info.status = int(Status.NO_MODEL)
            return info.status
        self.control.reset_timer()
        self.control.open_logfile()
        self.control.log(f"IPX version {__version__} (torch)\n")
        try:
            # the device the caller asked for ("cuda" by default) before any
            # work: without it (no card, a kernel library that does not
            # build, an unknown device) the solve ends at INTERNAL_ERROR
            # below, and no host solve stands in for it
            backend.require(self.control.parameters.device)
            self._presolve()
            if info.status == int(Status.NOT_RUN):
                self._interior_point_solve()
                if (info.status_ipm in (int(SolveStatus.OPTIMAL),
                                        int(SolveStatus.IMPRECISE))
                        and self.control.parameters.crossover):
                    self._run_crossover()
            if self.basis is not None:
                b = self.basis
                info.ftran_sparse = b.frac_ftran_sparse
                info.btran_sparse = b.frac_btran_sparse
                info.time_lu_invert = b.time_factorize
                info.time_lu_update = b.time_update
                info.time_ftran = b.time_ftran
                info.time_btran = b.time_btran
                info.mean_fill = b.mean_fill
                info.max_fill = b.max_fill
            if (info.status_ipm in (int(SolveStatus.PRIMAL_INFEAS),
                                    int(SolveStatus.DUAL_INFEAS))
                    or info.status_crossover in
                    (int(SolveStatus.PRIMAL_INFEAS),
                     int(SolveStatus.DUAL_INFEAS))):
                info.status = int(Status.SOLVED)
            else:
                method_status = (info.status_crossover
                                 if self.control.parameters.crossover
                                 else info.status_ipm)
                if method_status in (int(SolveStatus.OPTIMAL),
                                     int(SolveStatus.IMPRECISE)):
                    info.status = int(Status.SOLVED)
                else:
                    info.status = int(Status.STOPPED)
            self._print_summary()
        except MemoryError:
            self.control.log(" out of memory\n")
            info.status = int(Status.OUT_OF_MEMORY)
        except Exception as e:
            self.control.log(f" internal error: {e}\n")
            if self.control.parameters.debug:
                import traceback
                traceback.print_exc()
            info.status = int(Status.INTERNAL_ERROR)
        info.time_total = self.control.elapsed()
        if self.control.parameters.debug >= 2:
            self.control.debug(self.info.dump(), 2)
        self.control.close_logfile()
        return info.status

    # ------------------------------------------------------------------
    def get_info(self) -> Info:
        return self.info

    def get_interior_solution(self) -> Optional[InteriorSolution]:
        return self.interior_solution

    def get_basic_solution(self) -> Optional[BasicSolution]:
        return self.basic_solution

    def get_parameters(self) -> Parameters:
        return self.control.parameters

    def set_parameters(self, parameters: Parameters) -> None:
        self.control.set_parameters(parameters)

    def get_iterate(self):
        """Debug accessor (reference: src/lp_solver.h:122-137)."""
        if self.iterate is None:
            return None
        it = self.iterate
        return (it.x.copy(), it.y.copy(), it.zl.copy(), it.zu.copy(),
                it.xl.copy(), it.xu.copy())

    def get_basis(self):
        """Returns (cbasis, vbasis) in user space, from crossover if run,
        else from the IPM basis (reference: src/lp_solver.cc:233-245)."""
        if self.basis is None:
            return None
        if self.basic_solution is not None:
            return (self.basic_solution.cbasis.copy(),
                    self.basic_solution.vbasis.copy())
        bp = BasicSolution.zeros(self.user_model.num_var,
                                 self.user_model.num_constr)
        self.presolver.postsolve_basis(self._build_basic_statuses(), bp)
        return bp.cbasis, bp.vbasis

    def get_kkt_matrix(self):
        """Returns (AI (scipy csc incl. slack columns), g) of the current KKT
        system (reference: src/lp_solver.cc:247-279)."""
        if self.iterate is None:
            return None
        import scipy.sparse as sp
        md = self.model
        m = md.num_rows
        AI = sp.hstack([md.A, sp.identity(m, format="csc")], format="csc")
        it = self.iterate
        with np.errstate(divide="ignore", invalid="ignore"):
            g = np.where(it.barrier_lb_mask, it.zl / it.xl, 0.0) \
                + np.where(it.barrier_ub_mask, it.zu / it.xu, 0.0)
        g[it.fixed_mask] = INF
        g[it.free_mask] = 0.0
        return AI, g

    def symbolic_invert(self):
        """Row/column nnz counts of inv(B) (reference:
        src/lp_solver.cc:281-286)."""
        if self.basis is None:
            return None
        return self.basis.symbolic_invert()

    def _build_basic_statuses(self) -> np.ndarray:
        """reference: src/lp_solver.cc:212-231"""
        md = self.model
        lb, ub = md.lb, md.ub
        statuses = np.where(np.isfinite(lb), IPX_NONBASIC_LB,
                            np.where(np.isfinite(ub), IPX_NONBASIC_UB,
                                     IPX_SUPERBASIC))
        statuses[self.basis.basic_mask()] = IPX_BASIC
        return statuses

    # ------------------------------------------------------------------
    def _presolve(self) -> None:
        self.presolver.presolve_model(self.control)
        self.model.get_info(self.info)
        self.presolver.get_info(self.info)

    def _interior_point_solve(self) -> None:
        """reference: src/lp_solver.cc:305-332"""
        control = self.control
        params = control.parameters
        control.log("Interior Point Solve\n")

        self.iterate = Iterate(self.model)
        self.iterate.feasibility_tol = params.ipm_feasibility_tol
        self.iterate.optimality_tol = params.ipm_optimality_tol
        if params.crossover:
            self.iterate.crossover_start = params.crossover_start

        self._run_ipm()

        # Stash the final pre-postsolve state as a checkpoint: postprocess()
        # below restores fixed/implied variables and invalidates the iterate
        # for resuming, so this is the last consistent snapshot.
        from . import checkpoint as _ckpt
        try:
            self._checkpoint = _ckpt.build(self.model, self.iterate,
                                           self.basis, self.info.iter)
            if params.checkpoint_file and self.info.status_ipm not in (
                    int(SolveStatus.OPTIMAL), int(SolveStatus.IMPRECISE)):
                _ckpt.save_npz(self._checkpoint, params.checkpoint_file)
        except (OSError, ValueError) as e:
            control.log(f" Warning: final checkpoint failed: {e}\n")

        self.iterate.postprocess()
        self.interior_solution = InteriorSolution.zeros(
            self.user_model.num_var, self.user_model.num_constr)
        it = self.iterate
        self.presolver.postsolve_interior_solution(
            it.x, it.xl, it.xu, it.y, it.zl, it.zu, self.interior_solution)
        self.user_model.evaluate_interior_point(self.interior_solution,
                                                self.info)
        if self.info.status_ipm == int(SolveStatus.OPTIMAL):
            if (abs(self.info.rel_objgap) > params.ipm_optimality_tol
                    or self.info.rel_presidual > params.ipm_feasibility_tol
                    or self.info.rel_dresidual > params.ipm_feasibility_tol):
                self.info.status_ipm = int(SolveStatus.IMPRECISE)

    def _run_ipm(self) -> None:
        """reference: src/lp_solver.cc:334-359"""
        ipm = IPM(self.control)
        info = self.info

        if self._resume_ckpt is not None:
            self.control.log(" Resuming from checkpoint."
                             " Skipping initial iterations.\n")
            restored_basis = self._restore_checkpoint()
            self._resume_ckpt = None
            if info.status_ipm != int(SolveStatus.NOT_RUN) or info.errflag:
                if info.errflag:
                    info.status_ipm = int(SolveStatus.FAILED)
                return
            if not restored_basis:
                self._build_starting_basis()
                if info.status_ipm != int(SolveStatus.NOT_RUN):
                    return
            self._run_main_ipm(ipm)
            return

        if self.ipm_start is not None and not self.model.dualized:
            self.control.log(" Using starting point provided by user."
                             " Skipping initial iterations.\n")
            self._load_starting_point(ipm)
            if info.status_ipm != int(SolveStatus.NOT_RUN):
                return
        else:
            if self.ipm_start is not None:
                self.control.log(" Ignoring starting point provided by user"
                                 " because presolver dualized model.\n")
            self._compute_starting_point(ipm)
            if info.status_ipm != int(SolveStatus.NOT_RUN):
                return
            self._run_initial_ipm(ipm)
            if info.status_ipm != int(SolveStatus.NOT_RUN):
                return
        self._build_starting_basis()
        if info.status_ipm != int(SolveStatus.NOT_RUN):
            return
        self._run_main_ipm(ipm)

    def _restore_checkpoint(self) -> bool:
        """Restores iterate (+basis) from the armed checkpoint.

        Returns True when a basis was restored (resume continues directly in
        phase 2), False when the checkpoint predates the phase switch (a
        starting basis is then built from the restored iterate). Sets
        info.errflag on a model mismatch or singular restored basis.
        """
        from . import checkpoint as _ckpt
        info = self.info
        ckpt = self._resume_ckpt
        if not _ckpt.validate(ckpt, self.model):
            self.control.log(" Checkpoint does not match the presolved"
                             " model; refusing to resume.\n")
            info.errflag = int(Errflag.INVALID_CHECKPOINT)
            return False
        # Shape validation: a fingerprint match does not guarantee the
        # arrays themselves are well-formed (a hand-built dict could hold
        # truncated arrays); reject rather than crash downstream.
        nva = self.model.num_var_all
        m = self.model.num_rows
        bad = any(np.asarray(ckpt[k]).shape != (nva,)
                  for k in ("x", "xl", "xu", "zl", "zu", "state"))
        bad = bad or np.asarray(ckpt["y"]).shape != (m,)
        if _ckpt.has_basis(ckpt):
            bad = bad or np.asarray(ckpt["basis"]).shape != (m,) \
                or np.asarray(ckpt["map2basis"]).shape != (nva,)
        if bad:
            self.control.log(" Checkpoint arrays have inconsistent shapes;"
                             " refusing to resume.\n")
            info.errflag = int(Errflag.INVALID_CHECKPOINT)
            return False
        it = self.iterate
        it.x = np.array(ckpt["x"], dtype=float)
        it.xl = np.array(ckpt["xl"], dtype=float)
        it.xu = np.array(ckpt["xu"], dtype=float)
        it.y = np.array(ckpt["y"], dtype=float)
        it.zl = np.array(ckpt["zl"], dtype=float)
        it.zu = np.array(ckpt["zu"], dtype=float)
        it.state = np.array(ckpt["state"], dtype=it.state.dtype)
        it._evaluated = False
        it.postprocessed = False
        info.iter = int(ckpt["iter"])
        if not _ckpt.has_basis(ckpt):
            return False
        from .basis.basis import Basis
        self.basis = Basis(self.control, self.model)
        self.basis.basis = np.array(ckpt["basis"], dtype=np.int64)
        self.basis.map2basis = np.array(ckpt["map2basis"], dtype=np.int64)
        errflag = self.basis.factorize()
        if errflag == int(Errflag.BASIS_SINGULAR):
            # factorize() already repaired the basis by substituting slack
            # columns for the dependent positions (the factors represent the
            # patched basis exactly), so a slightly stale checkpoint resumes
            # with the repaired basis instead of aborting.  A corrupt
            # checkpoint (e.g. duplicated basic column) can leave map2basis
            # pointing away from the repaired basis; reconcile the pair.
            b = self.basis
            if np.unique(b.basis).size != m:
                info.errflag = int(Errflag.INVALID_CHECKPOINT)
                return False
            jb = b.basis
            pos = np.arange(m)
            was_free = (b.map2basis[jb] >= m) \
                & (b.map2basis[jb] - m == pos)
            b.map2basis[jb] = np.where(was_free, pos + m, pos)
            nonbasic = np.ones(nva, dtype=bool)
            nonbasic[jb] = False
            b.map2basis[nonbasic & (b.map2basis >= 0)] = -1
            self.control.log(" Restored basis was singular; repaired with"
                             " slack columns.\n")
            return True
        if errflag:
            info.errflag = errflag
            return False
        return True

    def _checkpoint_tick(self) -> None:
        """Per-IPM-iteration hook: periodic checkpoint writes."""
        from . import checkpoint as _ckpt
        params = self.control.parameters
        if not params.checkpoint_file or params.checkpoint_interval < 0:
            return
        now = perf_counter()
        if (self._ckpt_last_write
                and now - self._ckpt_last_write < params.checkpoint_interval):
            return
        try:
            _ckpt.save_npz(_ckpt.build(self.model, self.iterate, self.basis,
                                       self.info.iter),
                           params.checkpoint_file)
            self._ckpt_last_write = perf_counter()
        except (OSError, ValueError) as e:
            self.control.log(f" Warning: checkpoint write failed: {e}\n")

    def _load_starting_point(self, ipm: IPM) -> None:
        out = self.presolver.presolve_ipm_starting_point(self.ipm_start)
        assert not isinstance(out, int)
        x, xl, xu, y, zl, zu = out
        ipm.load_starting_point(x, xl, xu, y, zl, zu, self.iterate, self.info)

    def _compute_starting_point(self, ipm: IPM) -> None:
        t0 = perf_counter()
        kkt = KKTSolverDiag(self.control, self.model)
        ipm.compute_starting_point(kkt, self.iterate, self.info)
        self.info.time_ipm1 += perf_counter() - t0

    def _run_initial_ipm(self, ipm: IPM) -> None:
        """reference: src/lp_solver.cc:384-420"""
        t0 = perf_counter()
        params = self.control.parameters
        kkt = KKTSolverDiag(self.control, self.model)
        switchiter = params.switchiter
        if switchiter < 0:
            kkt.maxiter = min(500, 10 + self.model.num_rows // 20)
            ipm.maxiter = params.ipm_maxiter
            # auto mode additionally ends phase 1 on a sustained growth
            # trend in CR iterations (see IPM.phase1_trend_switch); only
            # for large models so tiny-LP status expectations are unchanged
            ipm.phase1_trend_switch = self.model.num_rows >= 5000
        else:
            ipm.maxiter = min(switchiter, params.ipm_maxiter)
        ipm.iteration_callback = self._checkpoint_tick
        ipm.driver(kkt, self.iterate, self.info)
        ipm.phase1_trend_switch = False
        ipm._kkt_iter_hist = []
        info = self.info
        if info.status_ipm == int(SolveStatus.OPTIMAL):
            # Still run the basis-preconditioned IPM so a starting basis is
            # available for crossover.
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

    def _build_starting_basis(self) -> None:
        """reference: src/lp_solver.cc:422-454"""
        info = self.info
        params = self.control.parameters
        if params.stop_at_switch < 0:
            info.status_ipm = int(SolveStatus.DEBUG)
            return
        from .basis.basis import Basis
        from .basis.starting_basis import build_starting_basis
        t0 = perf_counter()
        self.basis = Basis(self.control, self.model)
        self.control.log(" Constructing starting basis...\n")
        try:
            build_starting_basis(self.iterate, self.basis, info,
                                 preset=getattr(self, "_preset_basis",
                                                None))
        except InterruptError:
            info.status_ipm = int(SolveStatus.TIME_LIMIT)
            return
        finally:
            info.time_starting_basis += perf_counter() - t0
        if info.errflag == int(Errflag.INTERRUPT_TIME):
            info.errflag = 0
            info.status_ipm = int(SolveStatus.TIME_LIMIT)
            return
        if info.errflag:
            info.status_ipm = int(SolveStatus.FAILED)
            return
        if self.model.dualized:
            info.dependent_rows, info.dependent_cols = \
                info.dependent_cols, info.dependent_rows
            info.rows_inconsistent, info.cols_inconsistent = \
                info.cols_inconsistent, info.rows_inconsistent
        if params.stop_at_switch > 0:
            info.status_ipm = int(SolveStatus.DEBUG)
            return
        if info.rows_inconsistent:
            info.status_ipm = int(SolveStatus.PRIMAL_INFEAS)
            return
        if info.cols_inconsistent:
            info.status_ipm = int(SolveStatus.DUAL_INFEAS)
            return

    def _run_main_ipm(self, ipm: IPM) -> None:
        from .kkt.basis_precond import KKTSolverBasis
        t0 = perf_counter()
        kkt = KKTSolverBasis(self.control, self.basis)
        ipm.maxiter = self.control.parameters.ipm_maxiter
        ipm.iteration_callback = self._checkpoint_tick
        ipm.driver(kkt, self.iterate, self.info)
        self.info.time_ipm2 = perf_counter() - t0

    def _run_crossover(self) -> None:
        """reference: src/lp_solver.cc:464-537"""
        from .basis.crossover import Crossover
        control = self.control
        info = self.info
        control.log("Crossover\n")
        assert self.basis is not None
        md = self.model
        lb, ub = md.lb, md.ub

        x, y, z = self.iterate.drop_to_complementarity()
        self.simplex_iterate = (x, y, z)

        weights = self.iterate.scaling_factors()
        crossover = Crossover(control)
        crossover.push_all(self.basis, x, y, z, weights, info)
        info.time_crossover = crossover.time_primal + crossover.time_dual
        info.updates_crossover = (crossover.primal_pivots
                                  + crossover.dual_pivots)
        if info.status_crossover != int(SolveStatus.OPTIMAL):
            self.simplex_iterate = None
            return

        # Recompute vertex solution and set basic statuses.
        self.basis.compute_basic_solution(x, y, z)
        basic = self.basis.basic_mask()
        statuses = np.empty(md.num_var_all, dtype=np.int64)
        fixed = lb == ub
        at_lb = x == lb
        at_ub = x == ub
        statuses[:] = IPX_SUPERBASIC
        statuses[at_ub] = IPX_NONBASIC_UB
        statuses[at_lb] = IPX_NONBASIC_LB
        statuses[fixed & (z >= 0)] = IPX_NONBASIC_LB
        statuses[fixed & (z < 0)] = IPX_NONBASIC_UB
        statuses[basic] = IPX_BASIC

        self.basic_solution = BasicSolution.zeros(
            self.user_model.num_var, self.user_model.num_constr)
        self.presolver.postsolve_general_point(x, y, z, self.basic_solution)
        self.presolver.postsolve_basis(statuses, self.basic_solution)
        self.presolver.correct_basic_solution(self.basic_solution)
        self.user_model.evaluate_basic_point(self.basic_solution, info)

        params = control.parameters
        if (info.primal_infeas > params.pfeasibility_tol
                or info.dual_infeas > params.dfeasibility_tol):
            info.status_crossover = int(SolveStatus.IMPRECISE)

    # ------------------------------------------------------------------
    def _print_summary(self) -> None:
        """reference: src/lp_solver.cc:539-568"""
        tl = Control.textline
        info = self.info
        text = ("Summary\n"
                + tl("Runtime:") + f"{self.control.elapsed():.2f}s\n"
                + tl("Status interior point solve:")
                + _status_string(info.status_ipm) + "\n"
                + tl("Status crossover:")
                + _status_string(info.status_crossover) + "\n")
        if info.status_ipm in (int(SolveStatus.OPTIMAL),
                               int(SolveStatus.IMPRECISE)):
            text += (
                tl("objective value:") + f"{info.pobjval:.8e}\n"
                + tl("interior solution primal residual (abs/rel):")
                + f"{info.abs_presidual:.2e} / {info.rel_presidual:.2e}\n"
                + tl("interior solution dual residual (abs/rel):")
                + f"{info.abs_dresidual:.2e} / {info.rel_dresidual:.2e}\n"
                + tl("interior solution objective gap (abs/rel):")
                + f"{info.pobjval - info.dobjval:.2e} / "
                + f"{info.rel_objgap:.2e}\n")
        if info.status_crossover in (int(SolveStatus.OPTIMAL),
                                     int(SolveStatus.IMPRECISE)):
            text += (
                tl("basic solution primal infeasibility:")
                + f"{info.primal_infeas:.2e}\n"
                + tl("basic solution dual infeasibility:")
                + f"{info.dual_infeas:.2e}\n")
        self.control.log(text)


def _status_string(status: int) -> str:
    names = {
        int(SolveStatus.NOT_RUN): "not run",
        int(SolveStatus.OPTIMAL): "optimal",
        int(SolveStatus.IMPRECISE): "imprecise",
        int(SolveStatus.PRIMAL_INFEAS): "primal infeas",
        int(SolveStatus.DUAL_INFEAS): "dual infeas",
        int(SolveStatus.TIME_LIMIT): "time limit",
        int(SolveStatus.ITER_LIMIT): "iter limit",
        int(SolveStatus.NO_PROGRESS): "no progress",
        int(SolveStatus.FAILED): "failed",
        int(SolveStatus.DEBUG): "debug",
    }
    return names.get(status, f"unknown ({status})")
