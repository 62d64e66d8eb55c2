"""Presolver: user model <-> solver model conversion.

Counterpart of the reference presolver (reference: src/presolver.{h,cc}):
optional dualization (automatic when num_constr > 2*num_var, reference:
src/presolver.cc:31-34), power-of-2 recursive equilibration scaling
(reference: src/presolver.cc:883-975, the algorithm of Knight/Ruiz/Ucar), and
presolve/postsolve of points and bases between the two spaces.

All transformations are vectorized numpy; scaling factors are exact powers of
two so no round-off is introduced (bit-exact parity with the reference
scaling).

The port's copy of ipx_tpu/presolve.py.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sp

from .control import Control
from .info import Info
from .model import Model
from .status import (Errflag, IPX_BASIC, IPX_NONBASIC, IPX_NONBASIC_LB,
                     IPX_NONBASIC_UB, IPX_SUPERBASIC)
from .user_model import BasicSolution, InteriorSolution, UserModel

INF = np.inf


class Presolver:
    def __init__(self, user_model: UserModel, model: Model):
        self.user_model = user_model
        self.model = model
        self.clear()

    def clear(self) -> None:
        self.num_constr = 0
        self.num_eqconstr = 0
        self.num_var = 0
        self.num_free_var = 0
        self.boxed_vars = np.empty(0, dtype=np.int64)
        self.dualized = False
        self.flipped_vars = np.empty(0, dtype=np.int64)
        self.colscale = np.empty(0)
        self.rowscale = np.empty(0)

    # ------------------------------------------------------------------
    def presolve_model(self, control: Control) -> int:
        """reference: src/presolver.cc:26-49"""
        self.model.clear()
        self._compute_user_model_attributes()
        self._print_user_model_attributes(control)

        dualize = control.parameters.dualize
        if dualize < 0:
            dualize = self.num_constr > 2 * self.num_var
        if dualize:
            self._load_dual()
        else:
            self._load_primal()

        self._scale_model(control)
        self.model.finalize()
        self._print_presolve_log(control)
        return 0

    def get_info(self, info: Info) -> None:
        info.dualized = int(self.dualized)

    def _compute_user_model_attributes(self) -> None:
        um = self.user_model
        self.num_constr = um.num_constr
        self.num_eqconstr = int(np.count_nonzero(um.constr_type == "="))
        self.num_var = um.num_var
        has_lb = np.isfinite(um.lb)
        has_ub = np.isfinite(um.ub)
        self.num_free_var = int(np.count_nonzero(~has_lb & ~has_ub))
        self.boxed_vars = np.nonzero(has_lb & has_ub)[0]
        self.flipped_vars = np.empty(0, dtype=np.int64)

    # ------------------------------------------------------------------
    # Model building (reference: src/presolver.cc:135-264). Unlike the
    # reference, the slack identity is NOT appended to the matrix; the Model
    # stores only the structural columns and handles slacks implicitly.
    # ------------------------------------------------------------------
    def _load_primal(self) -> None:
        um = self.user_model
        m, n = self.num_constr, self.num_var
        md = self.model
        md.num_rows = m
        md.num_cols = n
        md.dualized = self.dualized = False

        md.A = um.A.copy()

        md.b = um.rhs.copy()
        md.c = np.zeros(n + m)
        md.c[:n] = um.obj
        md.lb = np.empty(n + m)
        md.ub = np.empty(n + m)
        md.lb[:n] = um.lb
        md.ub[:n] = um.ub
        ct = um.constr_type
        # slack bounds encode the constraint type
        md.lb[n:] = np.where(ct == ">", -INF, 0.0)
        md.ub[n:] = np.where(ct == "<", INF, 0.0)

    def _load_dual(self) -> None:
        """Dualized computational form (reference: src/presolver.cc:182-264):
        solver rows = user variables, structural solver columns = user
        constraints plus one extra column -e_j per boxed variable j."""
        um = self.user_model
        m, n = self.num_constr, self.num_var     # user dims
        md = self.model
        md.num_rows = n
        md.num_cols = m + self.boxed_vars.size
        md.dualized = self.dualized = True

        # flip variables with only an upper bound
        flipped_mask = np.isinf(um.lb) & np.isfinite(um.ub)
        self.flipped_vars = np.nonzero(flipped_mask)[0]

        At = um.A.T.tocsc(copy=True)             # n x m
        if self.flipped_vars.size:
            flip_rows = flipped_mask[At.indices]
            At.data = np.where(flip_rows, -At.data, At.data)
        # append -identity columns for boxed variables
        nboxed = self.boxed_vars.size
        if nboxed:
            Bneg = sp.csc_matrix(
                (-np.ones(nboxed), (self.boxed_vars, np.arange(nboxed))),
                shape=(n, nboxed))
            md.A = sp.hstack([At, Bneg], format="csc")
        else:
            md.A = At

        md.b = um.obj.copy()
        md.b[self.flipped_vars] *= -1.0

        # effective lower bound of each user variable after flipping
        efflb = np.where(flipped_mask, -um.ub, um.lb)
        nc, nr = md.num_cols, md.num_rows
        md.c = np.empty(nc + nr)
        md.c[:m] = -um.rhs
        md.c[m:nc] = um.ub[self.boxed_vars]
        md.c[nc:] = np.where(np.isfinite(efflb), -efflb, 0.0)

        md.lb = np.empty(nc + nr)
        md.ub = np.empty(nc + nr)
        ct = um.constr_type
        md.lb[:m] = np.where(ct == ">", 0.0, -INF)
        md.ub[:m] = np.where(ct == "<", 0.0, INF)
        md.lb[m:nc] = 0.0
        md.ub[m:nc] = INF
        md.lb[nc:] = 0.0
        md.ub[nc:] = np.where(np.isfinite(efflb), INF, 0.0)

    # ------------------------------------------------------------------
    # Scaling (reference: src/presolver.cc:266-292, 883-975)
    # ------------------------------------------------------------------
    def _scale_model(self, control: Control) -> None:
        self.colscale = np.empty(0)
        self.rowscale = np.empty(0)
        if control.parameters.scale >= 1:
            self._equilibrate_matrix()

        md = self.model
        n = md.num_cols
        if self.colscale.size:
            cs = self.colscale
            md.c[:n] *= cs
            md.lb[:n] /= cs
            md.ub[:n] /= cs
        if self.rowscale.size:
            rs = self.rowscale
            md.b *= rs
            md.c[n:] /= rs
            md.lb[n:] *= rs
            md.ub[n:] *= rs

    def _equilibrate_matrix(self) -> None:
        """Recursive row/column equilibration with power-of-2 factors pushing
        each |entry| into [2^expmin, 2^expmax+1) = [0.5, 8) for
        expmin=0, expmax=3 (reference: src/presolver.cc:868-975). Scales only
        the structural columns; slacks absorb row scales via their bounds."""
        expmin, expmax, maxround = 0, 3, 10
        md = self.model
        A = md.A.tocoo(copy=True)
        m, n = A.shape

        if A.nnz == 0:
            return
        _, exps = np.frexp(np.abs(A.data))
        if np.all((exps >= expmin) & (exps <= expmax)):
            return          # quick return: already well scaled

        colscale = np.ones(n)
        rowscale = np.ones(m)
        vals = A.data.copy()
        rows, cols = A.row, A.col

        def factors(maxabs: np.ndarray) -> np.ndarray:
            _, exp = np.frexp(maxabs)
            f = np.ones_like(maxabs)
            low = exp < expmin
            high = exp > expmax
            f[low] = np.ldexp(1.0, (expmin - exp[low] + 1) // 2)
            f[high] = np.ldexp(1.0, -((exp[high] - expmax + 1) // 2))
            # zero max (empty row/col) must keep factor 1
            f[maxabs == 0.0] = 1.0
            return f

        for _ in range(maxround):
            absvals = np.abs(vals)
            rowmax = np.zeros(m)
            np.maximum.at(rowmax, rows, absvals)
            colmax = np.zeros(n)
            np.maximum.at(colmax, cols, absvals)
            rf = factors(rowmax)
            cf = factors(colmax)
            if np.all(rf == 1.0) and np.all(cf == 1.0):
                break
            rowscale *= rf
            colscale *= cf
            vals *= cf[cols]
            vals *= rf[rows]

        self.colscale = colscale
        self.rowscale = rowscale
        md.A = sp.csc_matrix((vals, (rows, cols)), shape=(m, n))

    # ------------------------------------------------------------------
    # Logging (reference: src/presolver.cc:294-410)
    # ------------------------------------------------------------------
    def _print_user_model_attributes(self, control: Control) -> None:
        um = self.user_model
        tl = Control.textline

        def vrange(v, finite_only=False):
            v = np.abs(np.asarray(v, dtype=float))
            mask = v != 0.0
            if finite_only:
                mask &= np.isfinite(v)
            v = v[mask]
            if v.size == 0:
                return 0.0, 0.0
            return float(v.min()), float(v.max())

        amin, amax = vrange(um.A.data if um.A is not None else [])
        rmin, rmax = vrange(um.rhs)
        omin, omax = vrange(um.obj)
        bvals = np.concatenate([um.lb, um.ub])
        bmin, bmax = vrange(bvals, finite_only=True)
        control.log(
            "Input\n"
            + tl("Number of variables:") + f"{self.num_var}\n"
            + tl("Number of free variables:") + f"{self.num_free_var}\n"
            + tl("Number of constraints:") + f"{self.num_constr}\n"
            + tl("Number of equality constraints:")
            + f"{self.num_eqconstr}\n"
            + tl("Number of matrix entries:")
            + f"{um.A.nnz if um.A is not None else 0}\n"
            + tl("Matrix range:") + f"[{amin:.0e}, {amax:.0e}]\n"
            + tl("RHS range:") + f"[{rmin:.0e}, {rmax:.0e}]\n"
            + tl("Objective range:") + f"[{omin:.0e}, {omax:.0e}]\n"
            + tl("Bounds range:") + f"[{bmin:.0e}, {bmax:.0e}]\n")

    def _print_presolve_log(self, control: Control) -> None:
        tl = Control.textline
        scales = np.concatenate([self.colscale, self.rowscale])
        if scales.size:
            minscale, maxscale = float(scales.min()), float(scales.max())
        else:
            minscale = maxscale = 1.0
        text = ("Preprocessing\n"
                + tl("Dualized model:")
                + ("yes" if self.dualized else "no") + "\n"
                + tl("Number of dense columns:")
                + f"{self.model.num_dense_cols}\n")
        if control.parameters.scale > 0:
            text += (tl("Range of scaling factors:")
                     + f"[{minscale:.2e}, {maxscale:.2e}]\n")
        control.log(text)

    # ------------------------------------------------------------------
    # Point presolve (reference: src/presolver.cc:412-564)
    # ------------------------------------------------------------------
    def presolve_ipm_starting_point(self, up: InteriorSolution):
        """Returns (x, xl, xu, y, zl, zu) in solver space, or errflag int
        (reference: src/presolver.cc:68-82). Refused after dualization."""
        if self.dualized:
            return int(Errflag.NOT_IMPLEMENTED)
        md = self.model
        m, n = md.num_rows, md.num_cols
        ct = self.user_model.constr_type

        x = np.concatenate([up.x, up.slack])
        xl = np.concatenate([up.xl, np.zeros(m)])
        xu = np.concatenate([up.xu, np.zeros(m)])
        y = up.y.copy()
        zl = np.concatenate([up.zl, np.zeros(m)])
        zu = np.concatenate([up.zu, np.zeros(m)])

        eq, lt, gt = ct == "=", ct == "<", ct == ">"
        xl[n:][lt] = up.slack[lt]
        xu[n:][lt] = INF
        zl[n:][lt] = -up.y[lt]
        xl[n:][gt] = INF
        xu[n:][gt] = -up.slack[gt]
        zu[n:][gt] = up.y[gt]
        # (equality slacks keep all zeros)
        del eq

        if self.colscale.size:
            cs = self.colscale
            x[:n] /= cs
            xl[:n] /= cs
            xu[:n] /= cs
            zl[:n] *= cs
            zu[:n] *= cs
        if self.rowscale.size:
            rs = self.rowscale
            y /= rs
            x[n:] *= rs
            xl[n:] *= rs
            xu[n:] *= rs
            zl[n:] /= rs
            zu[n:] /= rs
        return x, xl, xu, y, zl, zu

    # ------------------------------------------------------------------
    # Interior postsolve (reference: src/presolver.cc:618-793)
    # ------------------------------------------------------------------
    def postsolve_interior_solution(self, x_s, xl_s, xu_s, y_s, zl_s, zu_s,
                                    up: InteriorSolution) -> None:
        md = self.model
        m, n = md.num_rows, md.num_cols
        nv, ncon = self.num_var, self.num_constr
        ct = self.user_model.constr_type
        cs = self.colscale if self.colscale.size else np.ones(n)
        rs = self.rowscale if self.rowscale.size else np.ones(m)

        if self.dualized:
            # user vars <-> solver rows; user constraints <-> solver columns
            up.x[:] = -y_s * rs
            eq, lt, gt = ct == "=", ct == "<", ct == ">"
            up.y[eq] = x_s[:ncon][eq] * cs[:ncon][eq]
            up.y[lt] = -xu_s[:ncon][lt] * cs[:ncon][lt]
            up.y[gt] = xl_s[:ncon][gt] * cs[:ncon][gt]

            # zl_user from solver slack (via xl to keep sign)
            up.zl[:] = xl_s[n:] / rs
            fixed_slack = md.lb[n:] == md.ub[n:]
            up.zl[fixed_slack] = 0.0

            up.zu[:] = 0.0
            k = np.arange(ncon, n)
            if self.boxed_vars.size:
                up.zu[self.boxed_vars] = xl_s[k] * cs[k]

            up.xl[:] = np.where(~fixed_slack, zl_s[n:] * rs, INF)
            up.xu[:] = INF
            if self.boxed_vars.size:
                up.xu[self.boxed_vars] = zl_s[k] / cs[k]

            up.slack[eq] = 0.0
            up.slack[lt] = zu_s[:ncon][lt] / cs[:ncon][lt]
            up.slack[gt] = -zl_s[:ncon][gt] / cs[:ncon][gt]

            fv = self.flipped_vars
            if fv.size:
                up.x[fv] *= -1.0
                up.xu[fv] = up.xl[fv]
                up.xl[fv] = INF
                up.zu[fv] = up.zl[fv]
                up.zl[fv] = 0.0
        else:
            up.x[:] = x_s[:nv] * cs
            eq, lt, gt = ct == "=", ct == "<", ct == ">"
            up.y[eq] = y_s[eq] * rs[eq]
            up.y[lt] = -zl_s[n:][lt] * rs[lt]
            up.y[gt] = zu_s[n:][gt] * rs[gt]
            up.zl[:] = zl_s[:nv] / cs
            up.zu[:] = zu_s[:nv] / cs
            up.xl[:] = xl_s[:nv] * cs
            up.xu[:] = xu_s[:nv] * cs
            up.slack[eq] = 0.0
            up.slack[lt] = xl_s[n:][lt] / rs[lt]
            up.slack[gt] = -xu_s[n:][gt] / rs[gt]

    # ------------------------------------------------------------------
    # General point presolve/postsolve (reference: src/presolver.cc:412-491,
    # 566-616); used for basic (crossover) solutions.
    # ------------------------------------------------------------------
    def presolve_general_point(self, x_u, slack_u, y_u, z_u):
        md = self.model
        m, n = md.num_rows, md.num_cols
        nv, ncon = self.num_var, self.num_constr

        x_s = np.zeros(n + m)
        y_s = np.zeros(m)
        z_s = np.zeros(n + m)
        if self.dualized:
            y_s[:] = -x_u
            y_s[self.flipped_vars] *= -1.0
            z_s[:ncon] = -slack_u
            if self.boxed_vars.size:
                k = np.arange(ncon, n)
                z_s[k] = md.c[k] + y_s[self.boxed_vars]
            z_s[n:] = md.c[n:] - y_s
            x_s[:ncon] = y_u
            x_s[n:] = z_u
            x_s[n + self.flipped_vars] *= -1.0
            if self.boxed_vars.size:
                bx = self.boxed_vars
                neg = x_s[n + bx] < 0.0
                k = np.arange(ncon, n)
                x_s[k[neg]] = -x_s[n + bx[neg]]
                x_s[n + bx[neg]] = 0.0
                x_s[k[~neg]] = 0.0
        else:
            x_s[:n] = x_u
            x_s[n:] = slack_u
            y_s[:] = y_u
            z_s[:n] = z_u
            z_s[n:] = md.c[n:] - y_s

        if self.colscale.size:
            x_s[:n] /= self.colscale
            z_s[:n] *= self.colscale
        if self.rowscale.size:
            y_s /= self.rowscale
            x_s[n:] *= self.rowscale
            z_s[n:] /= self.rowscale
        return x_s, y_s, z_s

    def postsolve_general_point(self, x_s, y_s, z_s, bp: BasicSolution
                                ) -> None:
        md = self.model
        m, n = md.num_rows, md.num_cols
        nv, ncon = self.num_var, self.num_constr
        cs = self.colscale if self.colscale.size else np.ones(n)
        rs = self.rowscale if self.rowscale.size else np.ones(m)

        if self.dualized:
            bp.x[:] = -y_s * rs
            bp.z[:] = x_s[n:] / rs
            bp.slack[:] = -z_s[:ncon] / cs[:ncon]
            bp.y[:] = x_s[:ncon] * cs[:ncon]
            if self.boxed_vars.size:
                k = np.arange(ncon, n)
                bp.z[self.boxed_vars] -= x_s[k] * cs[k]
            fv = self.flipped_vars
            bp.x[fv] *= -1.0
            bp.z[fv] *= -1.0
        else:
            bp.x[:] = x_s[:nv] * cs
            bp.z[:] = z_s[:nv] / cs
            bp.slack[:] = x_s[n:] / rs
            bp.y[:] = y_s * rs

    # ------------------------------------------------------------------
    # Basis postsolve (reference: src/presolver.cc:795-845) and basic
    # solution correction (reference: src/presolver.cc:847-881)
    # ------------------------------------------------------------------
    def postsolve_basis(self, basic_status_solver: np.ndarray,
                        bp: BasicSolution) -> None:
        md = self.model
        m, n = md.num_rows, md.num_cols
        nv, ncon = self.num_var, self.num_constr
        bs = np.asarray(basic_status_solver)

        if self.dualized:
            # solver columns 0..ncon-1 <-> user rows
            bp.cbasis[:] = np.where(bs[:ncon] == IPX_BASIC,
                                    IPX_NONBASIC, IPX_BASIC)
            slack_nb = bs[n:] == 0
            fixed = md.lb[n:] != md.ub[n:]
            bp.vbasis[:] = np.where(
                slack_nb, np.where(fixed, IPX_NONBASIC_LB, IPX_SUPERBASIC),
                IPX_BASIC)
            if self.boxed_vars.size:
                k = np.arange(ncon, n)
                at_ub = bs[k] == IPX_BASIC
                bp.vbasis[self.boxed_vars[at_ub]] = IPX_NONBASIC_UB
            fv = self.flipped_vars
            if fv.size:
                sel = bp.vbasis[fv] == IPX_NONBASIC_LB
                bp.vbasis[fv[sel]] = IPX_NONBASIC_UB
        else:
            bp.cbasis[:] = np.where(bs[n:] == IPX_BASIC,
                                    IPX_BASIC, IPX_NONBASIC)
            bp.vbasis[:] = bs[:nv]

    def correct_basic_solution(self, bp: BasicSolution) -> None:
        um = self.user_model
        at_lb = bp.vbasis == IPX_NONBASIC_LB
        at_ub = bp.vbasis == IPX_NONBASIC_UB
        basic = bp.vbasis == IPX_BASIC
        bp.x[at_lb] = um.lb[at_lb]
        bp.x[at_ub] = um.ub[at_ub]
        bp.z[basic] = 0.0
        row_nb = bp.cbasis == IPX_NONBASIC
        row_b = bp.cbasis == IPX_BASIC
        bp.slack[row_nb] = 0.0
        bp.y[row_b] = 0.0
