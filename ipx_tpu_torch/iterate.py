"""IPM iterate: primal-dual point plus per-variable state machine.

Counterpart of the reference iterate (reference: src/iterate.{h,cc}). The
point is (x, xl, xu)[n+m], y[m], (zl, zu)[n+m]; each variable is in a state

    barrier (BARRIER_LB / BARRIER_UB / BARRIER_BOXED),
    fixed   (FIXED), or
    free    (FREE / IMPLIED_LB / IMPLIED_UB / IMPLIED_EQ),

see reference: src/iterate.h:218-268 for the exact invariants. TPU-first
design difference: states are a single int8 vector and every operation is a
masked vector op over the whole iterate (no per-variable branches), which maps
directly onto the device compute path and vmaps over scenario batches.

Residuals/objectives/complementarity are evaluated lazily and cached
(reference: src/iterate.h:274-288).

The port's copy of ipx_tpu/iterate.py.
"""
from __future__ import annotations

import numpy as np

from .model import Model

try:
    from .native import veckernels as _VK
    if not _VK.available():
        _VK = None
except Exception:
    _VK = None

INF = np.inf

# state codes (int8)
BARRIER_LB = 0
BARRIER_UB = 1
BARRIER_BOXED = 2
FREE = 3
FIXED = 4
IMPLIED_LB = 5
IMPLIED_UB = 6
IMPLIED_EQ = 7

# A positive (primal or dual) variable is never moved closer to zero than
# this (reference: src/iterate.h:204).
BARRIER_MIN = 1e-30


class Iterate:
    def __init__(self, model: Model):
        self.model = model
        m, n = model.num_rows, model.num_cols
        nm = n + m
        lb, ub = model.lb, model.ub

        finl = np.isfinite(lb)
        finu = np.isfinite(ub)
        state = np.full(nm, FREE, dtype=np.int8)
        state[finl & ~finu] = BARRIER_LB
        state[~finl & finu] = BARRIER_UB
        state[finl & finu] = BARRIER_BOXED

        self.state = state
        self.x = np.zeros(nm)
        self.xl = np.where(finl, 1.0, INF)
        self.xu = np.where(finu, 1.0, INF)
        self.y = np.zeros(m)
        self.zl = np.where(finl, 1.0, 0.0)
        self.zu = np.where(finu, 1.0, 0.0)

        self.feasibility_tol = 1e-6
        self.optimality_tol = 1e-8
        self.crossover_start = -1.0

        self._evaluated = False
        self.postprocessed = False
        # cached evaluation results
        self._rb = np.zeros(m)
        self._rl = np.zeros(nm)
        self._ru = np.zeros(nm)
        self._rc = np.zeros(nm)
        self._pobjective = 0.0
        self._dobjective = 0.0
        self._presidual = 0.0
        self._dresidual = 0.0
        self._offset = 0.0
        self._complementarity = 0.0
        self._mu = 0.0
        self._mu_min = 0.0
        self._mu_max = 0.0
        # per-column inf-norm of AI, used by residuals_from_dropping
        self._colamax = None

    # -- state masks ---------------------------------------------------
    @property
    def barrier_lb_mask(self) -> np.ndarray:
        return (self.state == BARRIER_LB) | (self.state == BARRIER_BOXED)

    @property
    def barrier_ub_mask(self) -> np.ndarray:
        return (self.state == BARRIER_UB) | (self.state == BARRIER_BOXED)

    @property
    def fixed_mask(self) -> np.ndarray:
        return self.state == FIXED

    @property
    def free_mask(self) -> np.ndarray:
        """State::free in reference terms: FREE or any IMPLIED_*."""
        return (self.state == FREE) | self.implied_mask

    @property
    def barrier_mask(self) -> np.ndarray:
        return self.state <= BARRIER_BOXED

    @property
    def implied_mask(self) -> np.ndarray:
        return self.state >= IMPLIED_LB

    def is_implied(self, j: int) -> bool:
        return self.state[j] >= IMPLIED_LB

    def state_of(self, j: int) -> int:
        return int(self.state[j])

    # ------------------------------------------------------------------
    def initialize(self, x, xl, xu, y, zl, zu) -> None:
        """Load a starting point (reference: src/iterate.cc:62-94)."""
        lb, ub = self.model.lb, self.model.ub
        self.x = np.asarray(x, dtype=float).copy()
        self.xl = np.asarray(xl, dtype=float).copy()
        self.xu = np.asarray(xu, dtype=float).copy()
        self.y = np.asarray(y, dtype=float).copy()
        self.zl = np.asarray(zl, dtype=float).copy()
        self.zu = np.asarray(zu, dtype=float).copy()
        finl = np.isfinite(lb)
        finu = np.isfinite(ub)
        state = np.full(lb.shape, FREE, dtype=np.int8)
        state[finl & ~finu] = BARRIER_LB
        state[~finl & finu] = BARRIER_UB
        state[(finl & finu) | (lb == ub)] = BARRIER_BOXED
        self.state = state
        self._evaluated = False
        self.postprocessed = False

    def update(self, sp, dx, dxl, dxu, sd, dy, dzl, dzu) -> None:
        """Masked step (reference: src/iterate.cc:96-139): x moves unless
        fixed; xl/zl move only with a lower barrier, xu/zu only with an upper
        barrier; positives are clamped at BARRIER_MIN."""
        if (_VK is not None and dx is not None and dxl is not None
                and dxu is not None and dzl is not None
                and dzu is not None):
            for name in ("x", "xl", "xu", "zl", "zu"):
                a = getattr(self, name)
                if not (a.flags["C_CONTIGUOUS"] and a.dtype == np.float64):
                    setattr(self, name, np.ascontiguousarray(
                        a, dtype=np.float64))
            _VK.iterate_update(self.state, sp, sd, self.x, self.xl,
                               self.xu, self.zl, self.zu, dx, dxl, dxu,
                               dzl, dzu)
            if dy is not None:
                self.y = self.y + sd * dy
            self._evaluated = False
            return
        if dx is not None:
            notfixed = self.state != FIXED
            self.x = np.where(notfixed, self.x + sp * dx, self.x)
        blb = self.barrier_lb_mask
        bub = self.barrier_ub_mask
        if dxl is not None:
            self.xl = np.where(blb, np.maximum(self.xl + sp * dxl,
                                               BARRIER_MIN), self.xl)
        if dxu is not None:
            self.xu = np.where(bub, np.maximum(self.xu + sp * dxu,
                                               BARRIER_MIN), self.xu)
        if dy is not None:
            self.y = self.y + sd * dy
        if dzl is not None:
            self.zl = np.where(blb, np.maximum(self.zl + sd * dzl,
                                               BARRIER_MIN), self.zl)
        if dzu is not None:
            self.zu = np.where(bub, np.maximum(self.zu + sd * dzu,
                                               BARRIER_MIN), self.zu)
        self._evaluated = False

    # -- state transitions (reference: src/iterate.cc:146-184) ----------
    def make_fixed(self, j: int, value=None) -> None:
        if value is not None:
            self.x[j] = value
        self.xl[j] = 0.0
        self.xu[j] = 0.0
        self.zl[j] = 0.0
        self.zu[j] = 0.0
        self.state[j] = FIXED
        self._evaluated = False

    def make_implied_lb(self, j: int) -> None:
        self.xl[j] = INF
        self.xu[j] = INF
        self.state[j] = IMPLIED_LB
        self._evaluated = False

    def make_implied_ub(self, j: int) -> None:
        self.xl[j] = INF
        self.xu[j] = INF
        self.state[j] = IMPLIED_UB
        self._evaluated = False

    def make_implied_eq(self, j: int) -> None:
        self.xl[j] = INF
        self.xu[j] = INF
        self.zl[j] = 0.0
        self.zu[j] = 0.0
        self.state[j] = IMPLIED_EQ
        self._evaluated = False

    # -- scaling factors (reference: src/iterate.cc:183-198) -------------
    def scaling_factors(self) -> np.ndarray:
        """Vector of IPM scaling factors: 0 for fixed, inf for free,
        1/sqrt(zl/xl + zu/xu) for barrier variables."""
        with np.errstate(divide="ignore", invalid="ignore"):
            g = np.where(self.barrier_lb_mask, self.zl / self.xl, 0.0) \
                + np.where(self.barrier_ub_mask, self.zu / self.xu, 0.0)
            d = 1.0 / np.sqrt(g)
        d = np.where(self.fixed_mask, 0.0, d)
        d = np.where(self.free_mask, INF, d)
        return d

    def scaling_factor(self, j: int) -> float:
        s = int(self.state[j])
        if s == FIXED:
            return 0.0
        if s in (FREE, IMPLIED_LB, IMPLIED_UB, IMPLIED_EQ):
            return INF
        g = 0.0
        if s in (BARRIER_LB, BARRIER_BOXED):
            g += self.zl[j] / self.xl[j]
        if s in (BARRIER_UB, BARRIER_BOXED):
            g += self.zu[j] / self.xu[j]
        return 1.0 / np.sqrt(g)

    # -- lazy evaluation ------------------------------------------------
    def _evaluate(self) -> None:
        if self._evaluated:
            return
        if _VK is not None:
            self._evaluate_native()
        else:
            self._compute_residuals()
            self._compute_objectives()
            self._compute_complementarity()
        self._evaluated = True

    def _evaluate_native(self) -> None:
        """Single fused pass over the iterate (ipxlu_iterate_eval) for
        residuals, objectives and complementarity."""
        md = self.model
        self._rb = md.b - md.AI_mul(self.x)
        aty = md.AIt_mul(self.y)
        self._aty = aty
        rl, ru, rc, s = _VK.iterate_eval(
            self.state, self.postprocessed, self.x, self.xl, self.xu,
            self.zl, self.zu, md.lb, md.ub, md.c, aty)
        self._rl = rl
        self._ru = ru
        self._rc = rc
        rbnorm = float(np.max(np.abs(self._rb))) if self._rb.size else 0.0
        self._presidual = max(rbnorm, float(s[0]))
        self._dresidual = float(s[1])
        if self.postprocessed:
            self._offset = 0.0
            self._pobjective = float(s[2])
            self._dobjective = float(md.b @ self.y) + float(s[5]) \
                - float(s[6])
        else:
            self._pobjective = float(s[2]) - float(s[4])
            self._offset = float(s[3]) + float(s[4])
            self._dobjective = float(md.b @ self.y) + float(s[5]) \
                - float(s[6]) - float(s[7])
        count = s[11]
        if count > 0:
            self._complementarity = float(s[8])
            self._mu = float(s[8]) / count
            self._mu_min = float(s[9])
            self._mu_max = float(s[10])
        else:
            self._complementarity = 0.0
            self._mu = self._mu_min = self._mu_max = 0.0

    def _compute_residuals(self) -> None:
        """reference: src/iterate.cc:536-589"""
        md = self.model
        lb, ub = md.lb, md.ub
        self._rb = md.b - md.AI_mul(self.x)
        aty = md.AIt_mul(self.y)
        rc = md.c - aty - self.zl + self.zu
        if not self.postprocessed:
            rc[self.fixed_mask] = 0.0
        self._rc = rc
        self._aty = aty   # cached for objectives/postprocess
        blb = self.barrier_lb_mask
        bub = self.barrier_ub_mask
        with np.errstate(invalid="ignore"):
            self._rl = np.where(blb, lb - self.x + self.xl, 0.0)
            self._ru = np.where(bub, ub - self.x - self.xu, 0.0)
        pres = max(_infnorm(self._rb), _infnorm(self._rl),
                   _infnorm(self._ru))
        self._presidual = pres
        self._dresidual = _infnorm(self._rc)

    def _compute_objectives(self) -> None:
        """reference: src/iterate.cc:591-641"""
        md = self.model
        c, b, lb, ub = md.c, md.b, md.lb, md.ub
        if self.postprocessed:
            self._offset = 0.0
            self._pobjective = float(c @ self.x)
            dobj = float(b @ self.y)
            finl = np.isfinite(lb)
            finu = np.isfinite(ub)
            dobj += float(lb[finl] @ self.zl[finl])
            dobj -= float(ub[finu] @ self.zu[finu])
            self._dobjective = dobj
        else:
            fixed = self.fixed_mask
            implied = self.implied_mask
            cx = c * self.x
            self._pobjective = float(np.sum(cx[~fixed]))
            self._offset = float(np.sum(cx[fixed]))
            zx = (self.zl - self.zu) * self.x
            self._pobjective -= float(np.sum(zx[implied]))
            self._offset += float(np.sum(zx[implied]))
            dobj = float(b @ self.y)
            blb = self.barrier_lb_mask
            bub = self.barrier_ub_mask
            dobj += float(lb[blb] @ self.zl[blb])
            dobj -= float(ub[bub] @ self.zu[bub])
            if np.any(fixed):
                dobj -= float(self.x[fixed] @ self._aty[fixed])
            self._dobjective = dobj

    def _compute_complementarity(self) -> None:
        """reference: src/iterate.cc:643-672"""
        blb = self.barrier_lb_mask
        bub = self.barrier_ub_mask
        with np.errstate(invalid="ignore"):
            prods = np.concatenate([(self.xl * self.zl)[blb],
                                    (self.xu * self.zu)[bub]])
        if prods.size:
            self._complementarity = float(prods.sum())
            self._mu = float(prods.mean())
            self._mu_min = float(prods.min())
            self._mu_max = float(prods.max())
        else:
            self._complementarity = 0.0
            self._mu = self._mu_min = self._mu_max = 0.0

    # -- accessors ------------------------------------------------------
    def rb(self):
        self._evaluate()
        return self._rb

    def rl(self):
        self._evaluate()
        return self._rl

    def ru(self):
        self._evaluate()
        return self._ru

    def rc(self):
        self._evaluate()
        return self._rc

    def pobjective(self):
        self._evaluate()
        return self._pobjective

    def dobjective(self):
        self._evaluate()
        return self._dobjective

    def pobjective_after_postproc(self):
        self._evaluate()
        return self._pobjective + self._offset

    def dobjective_after_postproc(self):
        self._evaluate()
        return self._dobjective + self._offset

    def presidual(self):
        self._evaluate()
        return self._presidual

    def dresidual(self):
        self._evaluate()
        return self._dresidual

    def complementarity(self):
        self._evaluate()
        return self._complementarity

    def mu(self):
        self._evaluate()
        return self._mu

    def mu_min(self):
        self._evaluate()
        return self._mu_min

    def mu_max(self):
        self._evaluate()
        return self._mu_max

    # -- termination (reference: src/iterate.cc:221-248) -----------------
    def feasible(self) -> bool:
        self._evaluate()
        md = self.model
        return (self._presidual <= self.feasibility_tol
                * (1.0 + md.norm_bounds)
                and self._dresidual <= self.feasibility_tol
                * (1.0 + md.norm_c))

    def optimal(self) -> bool:
        self._evaluate()
        pobj = self.pobjective_after_postproc()
        dobj = self.dobjective_after_postproc()
        obj = 0.5 * (pobj + dobj)
        gap = pobj - dobj
        return abs(gap) <= self.optimality_tol * (1.0 + abs(obj))

    def term_crit_reached(self) -> bool:
        if self.feasible() and self.optimal():
            if self.crossover_start <= 0.0:
                return True
            pres, dres = self.residuals_from_dropping()
            md = self.model
            if (pres <= self.crossover_start * (1.0 + md.norm_bounds)
                    and dres <= self.crossover_start * (1.0 + md.norm_c)):
                return True
        return False

    # -- postprocessing (reference: src/iterate.cc:250-313) ---------------
    def postprocess(self) -> None:
        md = self.model
        lb, ub, c = md.lb, md.ub, md.c
        aty = md.AIt_mul(self.y)
        z = c - aty

        fixed = self.fixed_mask
        if np.any(fixed):
            self.xl[fixed] = self.x[fixed] - lb[fixed]
            self.xu[fixed] = ub[fixed] - self.x[fixed]
            eqfix = fixed & (lb == ub)
            pos = eqfix & (z >= 0.0)
            neg = eqfix & (z < 0.0)
            self.zl[pos] = z[pos]
            self.zu[neg] = -z[neg]

        ieq = self.state == IMPLIED_EQ
        ilb = self.state == IMPLIED_LB
        iub = self.state == IMPLIED_UB
        if np.any(ieq):
            pos = ieq & (z >= 0.0)
            neg = ieq & (z < 0.0)
            self.zl[pos] = z[pos]
            self.zu[pos] = 0.0
            self.zl[neg] = 0.0
            self.zu[neg] = -z[neg]
            self.x[ieq] = lb[ieq]
        if np.any(ilb):
            self.zl[ilb] = z[ilb]
            self.zu[ilb] = 0.0
            self.x[ilb] = lb[ilb]
        if np.any(iub):
            self.zl[iub] = 0.0
            self.zu[iub] = -z[iub]
            self.x[iub] = ub[iub]
        implied = ieq | ilb | iub
        if np.any(implied):
            self.xl[implied] = self.x[implied] - lb[implied]
            self.xu[implied] = ub[implied] - self.x[implied]

        self.postprocessed = True
        self._evaluated = False

    # -- crossover start point (reference: src/iterate.cc:315-391) --------
    def drop_to_complementarity(self):
        """Returns (x, y, z) complementary point: for each j either x[j] at a
        bound or z[j] == 0."""
        assert self.postprocessed
        md = self.model
        lb, ub = md.lb, md.ub
        xl, xu, zl, zu = self.xl, self.xu, self.zl, self.zu

        xj = np.clip(self.x, lb, ub)
        x = xj.copy()
        z = np.zeros_like(x)

        fixed_b = lb == ub
        finl = np.isfinite(lb)
        finu = np.isfinite(ub)
        boxed = finl & finu & ~fixed_b
        only_lb = finl & ~finu
        only_ub = ~finl & finu

        # fixed: x = lb, z = zl-zu
        x[fixed_b] = lb[fixed_b]
        z[fixed_b] = (zl - zu)[fixed_b]

        # boxed: decide side by zl*xu >= zu*xl, then activity by zl>=xl etc.
        with np.errstate(invalid="ignore"):
            lower_side = zl * xu >= zu * xl
        act_lb = boxed & lower_side & (zl >= xl)
        act_ub = boxed & ~lower_side & (zu >= xu)
        x[act_lb] = lb[act_lb]
        z[act_lb] = np.maximum(0.0, (zl - zu)[act_lb])
        x[act_ub] = ub[act_ub]
        z[act_ub] = np.minimum(0.0, (zl - zu)[act_ub])

        sel = only_lb & (zl >= xl)
        x[sel] = lb[sel]
        z[sel] = np.maximum(0.0, (zl - zu)[sel])
        sel = only_ub & (zu >= xu)
        x[sel] = ub[sel]
        z[sel] = np.minimum(0.0, (zl - zu)[sel])

        return x, self.y.copy(), z

    def residuals_from_dropping(self):
        """Max primal/dual residual that would result from dropping each
        barrier variable to a bound / its dual to zero
        (reference: src/iterate.cc:393-448)."""
        md = self.model
        lb, ub = md.lb, md.ub
        s = self.state
        xl, xu, zl, zu = self.xl, self.xu, self.zl, self.zu

        xdrop = np.zeros_like(self.x)
        zdrop = np.zeros_like(self.x)

        m_lb = s == BARRIER_LB
        act = m_lb & (zl >= xl)
        xdrop[act] = (self.x - lb)[act]
        inact = m_lb & ~(zl >= xl)
        zdrop[inact] = (zl - zu)[inact]

        m_ub = s == BARRIER_UB
        act = m_ub & (zu >= xu)
        xdrop[act] = (self.x - ub)[act]
        inact = m_ub & ~(zu >= xu)
        zdrop[inact] = (zl - zu)[inact]

        m_bx = s == BARRIER_BOXED
        with np.errstate(divide="ignore", invalid="ignore"):
            lower_side = np.where(m_bx, zl / xl >= zu / xu, False)
        act = m_bx & lower_side & (zl >= xl)
        xdrop[act] = (self.x - lb)[act]
        inact = m_bx & lower_side & ~(zl >= xl)
        zdrop[inact] = (zl - zu)[inact]
        act = m_bx & ~lower_side & (zu >= xu)
        xdrop[act] = (self.x - ub)[act]
        inact = m_bx & ~lower_side & ~(zu >= xu)
        zdrop[inact] = (zl - zu)[inact]

        if self._colamax is None:
            colamax = np.zeros(md.num_var_all)
            if md.A.nnz:
                np.maximum.at(colamax[:md.num_cols],
                              np.repeat(np.arange(md.num_cols),
                                        np.diff(md.A.indptr)),
                              np.abs(md.A.data))
            colamax[md.num_cols:] = 1.0
            self._colamax = colamax
        pres = float(np.max(np.abs(xdrop) * self._colamax, initial=0.0))
        dres = float(np.max(np.abs(zdrop), initial=0.0))
        return pres, dres

    # -- consistency (debug; reference: src/iterate.cc:450-525) ------------
    def assert_consistency(self) -> None:
        lb, ub = self.model.lb, self.model.ub
        s = self.state
        assert np.all(np.isfinite(self.x))
        assert np.all(np.isfinite(self.y))
        assert np.all(np.isfinite(self.zl))
        assert np.all(np.isfinite(self.zu))
        blb = self.barrier_lb_mask
        bub = self.barrier_ub_mask
        assert np.all(np.isfinite(lb[blb]))
        assert np.all(self.xl[blb] > 0.0)
        assert np.all(np.isfinite(self.xl[blb]))
        assert np.all(self.zl[blb] > 0.0)
        assert np.all(np.isfinite(ub[bub]))
        assert np.all(self.xu[bub] > 0.0)
        assert np.all(np.isfinite(self.xu[bub]))
        assert np.all(self.zu[bub] > 0.0)
        free = s == FREE
        assert np.all(np.isinf(self.xl[free]))
        assert np.all(self.zl[free] == 0.0)
        assert np.all(self.zu[free] == 0.0)
        fixed = s == FIXED
        assert np.all(self.xl[fixed] == 0.0)
        assert np.all(self.xu[fixed] == 0.0)
        assert np.all(self.zl[fixed] == 0.0)
        assert np.all(self.zu[fixed] == 0.0)


def _infnorm(v: np.ndarray) -> float:
    return float(np.max(np.abs(v))) if v.size else 0.0
