"""User-form LP model: validation and solution evaluation.

Counterpart of the reference user model (reference: src/user_model.{h,cc}).
Holds

    minimize   obj'x
    subject to A*x {=,<,>} rhs, lb <= x <= ub

and provides strict input validation (error codes parity with
include/ipx_status.h) plus evaluation of interior/basic points against the
ORIGINAL user data (reference: src/user_model.cc:99-210). All checks are
vectorized numpy; semantics match the reference element loops.

The port's copy of ipx_tpu/user_model.py.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp

from .info import Info
from .status import (Errflag, IPX_BASIC, IPX_NONBASIC_LB, IPX_NONBASIC_UB,
                     IPX_SUPERBASIC)

INF = np.inf


@dataclasses.dataclass
class InteriorSolution:
    """Interior point in user-model space (reference: src/solution.h:12-26)."""
    x: np.ndarray
    xl: np.ndarray
    xu: np.ndarray
    slack: np.ndarray
    y: np.ndarray
    zl: np.ndarray
    zu: np.ndarray

    @classmethod
    def zeros(cls, num_var: int, num_constr: int) -> "InteriorSolution":
        return cls(x=np.zeros(num_var), xl=np.zeros(num_var),
                   xu=np.zeros(num_var), slack=np.zeros(num_constr),
                   y=np.zeros(num_constr), zl=np.zeros(num_var),
                   zu=np.zeros(num_var))


@dataclasses.dataclass
class BasicSolution:
    """Basic point in user-model space (reference: src/solution.h:29-42)."""
    x: np.ndarray
    slack: np.ndarray
    y: np.ndarray
    z: np.ndarray
    vbasis: np.ndarray      # int, statuses of columns
    cbasis: np.ndarray      # int, statuses of rows

    @classmethod
    def zeros(cls, num_var: int, num_constr: int) -> "BasicSolution":
        return cls(x=np.zeros(num_var), slack=np.zeros(num_constr),
                   y=np.zeros(num_constr), z=np.zeros(num_var),
                   vbasis=np.zeros(num_var, dtype=np.int64),
                   cbasis=np.zeros(num_constr, dtype=np.int64))


class UserModel:
    def __init__(self):
        self.clear()

    def clear(self) -> None:
        self._empty = True
        self.num_var = 0
        self.num_constr = 0
        self.obj = np.empty(0)
        self.constr_type = np.empty(0, dtype="U1")
        self.rhs = np.empty(0)
        self.lb = np.empty(0)
        self.ub = np.empty(0)
        self.A: Optional[sp.csc_matrix] = None
        self.norm_obj = 0.0
        self.norm_rhs = 0.0
        self.norm_bounds = 0.0

    def empty(self) -> bool:
        return self._empty

    def get_info(self, info: Info) -> None:
        info.num_var = self.num_var
        info.num_constr = self.num_constr
        info.num_entries = self.A.nnz if self.A is not None else 0

    # ------------------------------------------------------------------
    # Loading (reference: src/user_model.cc:11-25 and CopyInput :282-318)
    # ------------------------------------------------------------------
    def load(self, num_constr, num_var, Ap, Ai, Ax, rhs, constr_type,
             obj, lb, ub) -> int:
        self.clear()
        errflag = self._copy_input(num_constr, num_var, Ap, Ai, Ax, rhs,
                                   constr_type, obj, lb, ub)
        if errflag:
            return errflag
        self._compute_norms()
        self._empty = False
        return 0

    def _copy_input(self, num_constr, num_var, Ap, Ai, Ax, rhs, constr_type,
                    obj, lb, ub) -> int:
        if num_constr is None or num_var is None:
            return int(Errflag.INVALID_DIMENSION)
        num_constr = int(num_constr)
        num_var = int(num_var)
        # dimension checks first (reference: src/user_model.cc:287-289)
        if num_constr < 0 or num_var <= 0:
            return int(Errflag.INVALID_DIMENSION)
        if Ap is None:
            return int(Errflag.ARGUMENT_NULL)
        if num_var > 0 and (obj is None or lb is None or ub is None):
            return int(Errflag.ARGUMENT_NULL)
        if num_constr > 0 and (rhs is None or constr_type is None):
            return int(Errflag.ARGUMENT_NULL)
        Ap = np.asarray(Ap, dtype=np.int64)
        if Ap.shape[0] != num_var + 1:
            return int(Errflag.INVALID_MATRIX)
        num_entries = int(Ap[num_var]) if Ap.size else 0
        if num_entries > 0 and (Ai is None or Ax is None):
            return int(Errflag.ARGUMENT_NULL)

        obj = np.asarray(obj, dtype=np.float64)
        lb = np.asarray(lb, dtype=np.float64)
        ub = np.asarray(ub, dtype=np.float64)
        rhs = (np.asarray(rhs, dtype=np.float64) if num_constr > 0
               else np.empty(0))
        ctype = _as_constr_type(constr_type, num_constr)

        # vector checks (reference: src/user_model.cc:220-244)
        if num_constr and not np.all(np.isfinite(rhs)):
            return int(Errflag.INVALID_VECTOR)
        if not np.all(np.isfinite(obj)):
            return int(Errflag.INVALID_VECTOR)
        # lb finite or -inf; ub finite or +inf; lb <= ub
        if np.any(np.isnan(lb)) or np.any(lb == INF):
            return int(Errflag.INVALID_VECTOR)
        if np.any(np.isnan(ub)) or np.any(ub == -INF):
            return int(Errflag.INVALID_VECTOR)
        if np.any(lb > ub):
            return int(Errflag.INVALID_VECTOR)
        if ctype is None or (num_constr and
                             not np.all(np.isin(ctype, ["=", "<", ">"]))):
            return int(Errflag.INVALID_VECTOR)

        # matrix checks (reference: src/user_model.cc:246-269): monotone
        # colptr from 0, finite values, in-range indices, no duplicates
        # within a column (order within a column is free).
        if Ap[0] != 0 or np.any(np.diff(Ap) < 0):
            return int(Errflag.INVALID_MATRIX)
        Ai = (np.asarray(Ai, dtype=np.int64)[:num_entries]
              if num_entries else np.empty(0, dtype=np.int64))
        Ax = (np.asarray(Ax, dtype=np.float64)[:num_entries]
              if num_entries else np.empty(0))
        if num_entries:
            if not np.all(np.isfinite(Ax)):
                return int(Errflag.INVALID_MATRIX)
            if Ai.min() < 0 or Ai.max() >= num_constr:
                return int(Errflag.INVALID_MATRIX)
            # duplicate detection: pair (col, row) must be unique
            col_of = np.repeat(np.arange(num_var), np.diff(Ap))
            keys = col_of * np.int64(num_constr) + Ai
            if np.unique(keys).size != num_entries:
                return int(Errflag.INVALID_MATRIX)

        self.num_constr = num_constr
        self.num_var = num_var
        self.constr_type = ctype
        self.obj = obj.copy()
        self.rhs = rhs.copy()
        self.lb = lb.copy()
        self.ub = ub.copy()
        A = sp.csc_matrix((Ax, Ai, Ap), shape=(num_constr, num_var))
        A.sort_indices()
        self.A = A
        return 0

    def _compute_norms(self) -> None:
        self.norm_obj = float(np.max(np.abs(self.obj))) if self.obj.size else 0.0
        self.norm_rhs = float(np.max(np.abs(self.rhs))) if self.rhs.size else 0.0
        vals = []
        for v in (self.lb, self.ub):
            finite = np.abs(v[np.isfinite(v)])
            if finite.size:
                vals.append(float(finite.max()))
        self.norm_bounds = max(vals, default=0.0)

    # ------------------------------------------------------------------
    # Interior point validation (reference: src/user_model.cc:48-97)
    # ------------------------------------------------------------------
    def check_interior_point(self, point: InteriorSolution) -> int:
        for arr in dataclasses.astuple(point):
            if arr is None:
                return int(Errflag.ARGUMENT_NULL)
        x, xl, xu, slack, y, zl, zu = (point.x, point.xl, point.xu,
                                       point.slack, point.y, point.zl,
                                       point.zu)
        lb, ub, ct = self.lb, self.ub, self.constr_type
        bad = np.zeros(self.num_var, dtype=bool)
        bad |= ~np.isfinite(x)
        bad |= ~(xl >= 0.0)
        bad |= (lb == -INF) & (xl != INF)
        bad |= (lb != -INF) & (xl == INF)
        bad |= ~(xu >= 0.0)
        bad |= (ub == INF) & (xu != INF)
        bad |= (ub != INF) & (xu == INF)
        bad |= ~((zl >= 0.0) & (zl < INF))
        bad |= (lb == -INF) & (zl != 0.0)
        bad |= ~((zu >= 0.0) & (zu < INF))
        bad |= (ub == INF) & (zu != 0.0)
        if np.any(bad):
            return int(Errflag.INVALID_VECTOR)
        badc = np.zeros(self.num_constr, dtype=bool)
        badc |= ~np.isfinite(slack)
        badc |= (ct == "=") & ~(slack == 0.0)
        badc |= (ct == "<") & ~(slack >= 0.0)
        badc |= (ct == ">") & ~(slack <= 0.0)
        badc |= ~np.isfinite(y)
        badc |= (ct == "<") & ~(y <= 0.0)
        badc |= (ct == ">") & ~(y >= 0.0)
        if np.any(badc):
            return int(Errflag.INVALID_VECTOR)
        return 0

    # ------------------------------------------------------------------
    # Evaluation (reference: src/user_model.cc:99-210)
    # ------------------------------------------------------------------
    def evaluate_interior_point(self, point: InteriorSolution,
                                info: Info) -> None:
        x, xl, xu, slack = point.x, point.xl, point.xu, point.slack
        y, zl, zu = point.y, point.zl, point.zu
        lb, ub = self.lb, self.ub

        # rb = rhs - slack - A x (rhs added last to preserve digits)
        rb = -(self.A @ x) - slack + self.rhs
        # rc = obj - zl + zu - A'y
        rc = -(self.A.T @ y) - (zl - zu) + self.obj

        presidual = float(np.max(np.abs(rb))) if rb.size else 0.0
        dresidual = float(np.max(np.abs(rc))) if rc.size else 0.0

        finl = np.isfinite(lb)
        finu = np.isfinite(ub)
        if np.any(finl):
            presidual = max(presidual,
                            float(np.max(np.abs(lb[finl] - x[finl]
                                                + xl[finl]))))
        if np.any(finu):
            presidual = max(presidual,
                            float(np.max(np.abs(ub[finu] - x[finu]
                                                - xu[finu]))))

        pobjective = float(self.obj @ x)
        dobjective = float(self.rhs @ y)
        if np.any(finl):
            dobjective += float(lb[finl] @ zl[finl])
        if np.any(finu):
            dobjective -= float(ub[finu] @ zu[finu])
        objective_gap = (pobjective - dobjective) / (
            1.0 + 0.5 * abs(pobjective + dobjective))

        complementarity = 0.0
        if np.any(finl):
            complementarity += float(xl[finl] @ zl[finl])
        if np.any(finu):
            complementarity += float(xu[finu] @ zu[finu])
        complementarity -= float(y @ slack)

        info.abs_presidual = presidual
        info.abs_dresidual = dresidual
        info.rel_presidual = presidual / (1.0 + max(self.norm_rhs,
                                                    self.norm_bounds))
        info.rel_dresidual = dresidual / (1.0 + self.norm_obj)
        info.pobjval = pobjective
        info.dobjval = dobjective
        info.rel_objgap = objective_gap
        info.complementarity = complementarity
        info.normx = float(np.max(np.abs(x))) if x.size else 0.0
        info.normy = float(np.max(np.abs(y))) if y.size else 0.0
        info.normz = float(max(np.max(np.abs(zl), initial=0.0),
                               np.max(np.abs(zu), initial=0.0)))

    def evaluate_basic_point(self, point: BasicSolution, info: Info) -> None:
        x, slack, y, z = point.x, point.slack, point.y, point.z
        vbasis, ct = point.vbasis, self.constr_type

        primal_infeas = max(
            float(np.max(self.lb - x, initial=0.0)),
            float(np.max(x - self.ub, initial=0.0)))
        dual_infeas = 0.0
        not_at_lb = vbasis != IPX_NONBASIC_LB
        not_at_ub = vbasis != IPX_NONBASIC_UB
        if np.any(not_at_lb):
            dual_infeas = max(dual_infeas, float(np.max(z[not_at_lb])))
        if np.any(not_at_ub):
            dual_infeas = max(dual_infeas, float(np.max(-z[not_at_ub])))

        lt, gt, eq = ct == "<", ct == ">", ct == "="
        if np.any(lt):
            primal_infeas = max(primal_infeas, float(np.max(-slack[lt])))
            dual_infeas = max(dual_infeas, float(np.max(y[lt])))
        if np.any(gt):
            primal_infeas = max(primal_infeas, float(np.max(slack[gt])))
            dual_infeas = max(dual_infeas, float(np.max(-y[gt])))
        if np.any(eq):
            primal_infeas = max(primal_infeas,
                                float(np.max(np.abs(slack[eq]))))

        info.primal_infeas = max(primal_infeas, 0.0)
        info.dual_infeas = max(dual_infeas, 0.0)
        info.objval = float(self.obj @ x)


def _as_constr_type(constr_type, num_constr) -> Optional[np.ndarray]:
    """Normalize constraint-type input (str, bytes, or sequence of chars)."""
    if num_constr == 0:
        return np.empty(0, dtype="U1")
    try:
        if isinstance(constr_type, bytes):
            constr_type = constr_type.decode()
        if isinstance(constr_type, str):
            chars = list(constr_type)
        else:
            chars = [c.decode() if isinstance(c, bytes) else str(c)
                     for c in constr_type]
    except Exception:
        return None
    if len(chars) != num_constr:
        return None
    return np.array(chars, dtype="U1")
