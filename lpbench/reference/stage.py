"""The plain reference of the batched scenario phase 1.

A straightforward PyTorch statement of the batched phase-1 interior-point
method over B scenario LPs that share A and the bounds:

    min c_k' x  st  A x[:n] + x[n:] = b_k,  lb <= x <= ub,   k = 1..B,

the Mehrotra predictor-corrector of IPX's starting point and step
(Schork and Gondzio, "Implementation of an interior point method with basis
preconditioning", 2020), the normal equations solved per lane by Jacobi-
preconditioned CR in float32 chunks with defect correction in the state's
precision, lanes frozen once converged, and the run handed off once the CR
spends 0.8 of its budget two steps in a row.

It imports nothing of the program under test: it builds its own operands
(A, A', A.^2 and their float32 copies) from the scipy matrix it is given,
with torch's sparse CSR product, and works out its own starting point.
`dtype` is the precision of the state and of the defect correction;
float64 is the reference, float32 the control (one precision below).
"""
from __future__ import annotations

import warnings

import numpy as np
import scipy.sparse as sp
import torch

INF = float("inf")
RHO = 0.05          # the starting point's dual fix-up
CHUNK = 125         # trips of one float32 CR chunk
GAMMA = 0.9         # the fraction to the boundary
FLOOR = 1e-30       # the least barrier part a step leaves


class Operands:
    """A, A' and A.^2 as torch CSR tensors in one dtype."""

    def __init__(self, A: sp.csc_matrix, dtype, device):
        def csr(M):
            M = sp.csr_matrix(M)
            M.sort_indices()
            with warnings.catch_warnings():
                # torch calls its sparse CSR support a beta
                warnings.simplefilter("ignore", UserWarning)
                return torch.sparse_csr_tensor(
                    torch.from_numpy(M.indptr.astype(np.int64)),
                    torch.from_numpy(M.indices.astype(np.int64)),
                    torch.from_numpy(M.data.astype(np.float64)),
                    size=M.shape, dtype=dtype, device=device)
        A = sp.csc_matrix(A, dtype=np.float64)
        self.m, self.n = A.shape
        self.A, self.At = csr(A), csr(A.T)
        A2 = A.copy()
        A2.data = A2.data ** 2
        self.A2 = csr(A2)

    def AI(self, X):
        """[A I] X for X of shape (n + m, B)."""
        return self.A @ X[:self.n] + X[self.n:]

    def AIt(self, Y):
        """[A I]' Y for Y of shape (m, B)."""
        return torch.cat([self.At @ Y, Y], dim=0)

    def normal(self, W, V):
        """[A I] diag(W) [A I]' V."""
        return self.A @ (W[:self.n] * (self.At @ V)) + W[self.n:] * V


def cr(ops: Operands, W, invd, resscale, rhs, tol, maxiter: int):
    """Lane-masked Jacobi-preconditioned CR on (AI W AI') Y = rhs in the
    dtype of its operands. A lane stops once max|resscale R| <= tol.
    Returns (Y, trips)."""
    Y = torch.zeros_like(rhs)
    R = rhs
    S = invd * R
    CS = ops.normal(W, S)
    cdot = torch.sum(S * CS, dim=0)
    D, CD = S, CS
    it = 0
    while it < maxiter:
        active = torch.amax(torch.abs(resscale * R), dim=0) > tol
        if not bool(active.any()):
            break
        PCD = invd * CD
        pdot = torch.sum(CD * PCD, dim=0)
        alpha = torch.where((pdot > 0) & active, cdot / pdot, 0.0)
        Y = Y + alpha * D
        R = R - alpha * CD
        S = S - alpha * PCD
        CS = ops.normal(W, S)
        cnew = torch.sum(S * CS, dim=0)
        beta = torch.where(active & (cdot > 0), cnew / cdot, 0.0)
        D = S + beta * D
        CD = CS + beta * CD
        cdot = cnew
        it += 1
    return Y, it


class Phase1:
    """The batched phase 1 of one batch of scenarios, in `dtype`."""

    def __init__(self, A, b, c, lb, ub, *, feasibility_tol, optimality_tol,
                 maxiter, kkt_tol=0.3, cr_maxiter=500, mixed=True,
                 dtype=torch.float64, device="cpu"):
        self.dt, self.dev, self.mixed = dtype, torch.device(device), mixed
        self.ops = Operands(A, dtype, self.dev)
        self.ops32 = Operands(A, torch.float32, self.dev)
        self.m, self.n = A.shape
        self.maxiter, self.kkt_tol, self.cr_maxiter = (maxiter, kkt_tol,
                                                       cr_maxiter)
        t = self.tensor
        self.bT, self.cT = t(np.asarray(b).T), t(np.asarray(c).T)
        self.lb, self.ub = t(lb)[:, None], t(ub)[:, None]
        self.fl, self.fu = torch.isfinite(self.lb), torch.isfinite(self.ub)
        self.num_fin = max(int(self.fl.sum() + self.fu.sum()), 1)
        fin = np.concatenate([np.asarray(lb)[np.isfinite(lb)],
                              np.asarray(ub)[np.isfinite(ub)]])
        norm_bounds = max(np.abs(b).max(initial=0.0),
                          np.abs(fin).max(initial=0.0))
        self.feas_b = feasibility_tol * (1.0 + norm_bounds)
        self.feas_c = feasibility_tol * (1.0 + np.abs(c).max(initial=0.0))
        self.opt_tol = optimality_tol
        A2 = sp.csc_matrix(A, dtype=np.float64).copy()
        A2.data = A2.data ** 2
        self.diag1 = t(np.asarray(A2.sum(axis=1)).ravel() + 1.0)[:, None]

    def tensor(self, x):
        return torch.as_tensor(np.ascontiguousarray(x, dtype=np.float64)
                               ).to(self.dev, self.dt)

    # -- the mixed CR: float32 chunks, defect correction in dtype -----------
    def solve(self, W, diag, resscale, RHS, tol):
        """(Y, trips) of the normal equations: with `mixed`, float32 chunks
        until the lanes converge, the budget is spent or a chunk stops
        reducing the worst scaled residual, then a finish in dtype on the
        defect; else CR in dtype alone."""
        invd = 1.0 / diag
        if not self.mixed:
            return cr(self.ops, W, invd, resscale, RHS, tol, self.cr_maxiter)
        W32, inv32, rs32, tol32 = (x.to(torch.float32)
                                   for x in (W, invd, resscale, tol))

        def resnorm(R):
            return torch.amax(torch.abs(resscale * R), dim=0)

        Y = torch.zeros_like(RHS)
        R = RHS
        trips, best = 0, INF
        while trips < self.cr_maxiter and bool((resnorm(R) > tol).any()):
            dY, t = cr(self.ops32, W32, inv32, rs32, R.to(torch.float32),
                       tol32, min(CHUNK, self.cr_maxiter - trips))
            Y = Y + dY.to(self.dt)
            R = RHS - self.ops.normal(W, Y)
            rn = resnorm(R)
            worst = float(torch.amax(torch.where(rn > tol, rn / tol, 0.0)))
            trips += t
            if worst >= 0.9 * best:
                break
            best = worst
        dY, t = cr(self.ops, W, invd, resscale, R, tol, self.cr_maxiter)
        return Y + dY, trips + t

    # -- the starting point --------------------------------------------------
    def start(self):
        m, n, ops = self.m, self.n, self.ops
        B = self.bT.shape[1]
        fl, fu, lb, ub, cT = self.fl, self.fu, self.lb, self.ub, self.cT
        W1 = torch.ones((n + m, B), dtype=self.dt, device=self.dev)
        ones = torch.ones((m, 1), dtype=self.dt, device=self.dev)
        X0 = torch.minimum(torch.maximum(torch.zeros_like(W1), lb), ub)
        RB = self.bT - ops.AI(X0)
        DY, t1 = self.solve(W1, self.diag1, ones, RB,
                            0.1 * torch.amax(torch.abs(RB), dim=0) + 1e-300)
        Y, t2 = self.solve(W1, self.diag1, ones, ops.AI(cT),
                           0.1 * torch.amax(torch.abs(cT), dim=0) + 1e-300)
        X = X0 + ops.AIt(DY)
        neg = torch.maximum(torch.amax(torch.where(fl, lb - X, 0.0), dim=0),
                            torch.amax(torch.where(fu, X - ub, 0.0), dim=0))
        xshift = 1.0 + 1.5 * torch.clamp(neg, min=0.0)
        XL = X - lb + xshift
        XU = ub - X + xshift
        Z = cT - ops.AIt(Y)
        fix = (torch.linalg.vector_norm(Z, dim=0)
               < RHO * torch.linalg.vector_norm(cT, dim=0))
        Z = torch.where(fix, Z + RHO * cT, Z)
        Y = torch.where(fix, (1.0 - RHO) * Y, Y)
        boxed = fl & fu
        ZL = torch.where(boxed, 0.5 * Z, torch.where(fl, Z, 0.0))
        ZU = torch.where(boxed, -0.5 * Z, torch.where(fu & ~fl, -Z, 0.0))
        neg = torch.maximum(torch.amax(torch.where(fl, -ZL, 0.0), dim=0),
                            torch.amax(torch.where(fu, -ZU, 0.0), dim=0))
        zshift = 1.0 + 1.5 * torch.clamp(neg, min=0.0)
        ZL = torch.where(fl, ZL + zshift, 0.0)
        ZU = torch.where(fu, ZU + zshift, 0.0)

        def fsum(x):
            return (torch.sum(torch.where(fl, x[0], 0.0), dim=0)
                    + torch.sum(torch.where(fu, x[1], 0.0), dim=0))
        xsum = 1.0 + fsum((XL, XU))
        zsum = 1.0 + fsum((ZL, ZU))
        mu = 1.0 + fsum((XL * ZL, XU * ZU))
        XL = torch.where(fl, XL + 0.5 * mu / zsum, INF)
        XU = torch.where(fu, XU + 0.5 * mu / zsum, INF)
        ZL = torch.where(fl, ZL + 0.5 * mu / xsum, 0.0)
        ZU = torch.where(fu, ZU + 0.5 * mu / xsum, 0.0)
        return dict(X=X, XL=XL, XU=XU, Y=Y, ZL=ZL, ZU=ZU,
                    done=torch.zeros(B, dtype=torch.bool, device=self.dev),
                    iters=torch.zeros(B, dtype=torch.int64, device=self.dev),
                    cr=t1 + t2)

    # -- one step ------------------------------------------------------------
    def mu(self, S):
        fl, fu = self.fl, self.fu
        return (torch.sum(torch.where(fl, S["XL"] * S["ZL"], 0.0), dim=0)
                + torch.sum(torch.where(fu, S["XU"] * S["ZU"], 0.0), dim=0)
                ) / self.num_fin

    def residuals(self, S):
        """(RB, RC, RL, RU, mu, passed) of the state S: its residuals, its
        mu and whether each lane passes the stage's convergence test."""
        ops, fl, fu = self.ops, self.fl, self.fu
        lb, ub, bT, cT = self.lb, self.ub, self.bT, self.cT
        X, XL, XU, Y, ZL, ZU = (S[k] for k in ("X", "XL", "XU", "Y", "ZL",
                                               "ZU"))
        where = torch.where
        RB = bT - ops.AI(X)
        RC = cT - ops.AIt(Y) - ZL + ZU
        RL = where(fl, lb - X + XL, 0.0)
        RU = where(fu, ub - X - XU, 0.0)
        mu = self.mu(S)
        pres = torch.maximum(torch.amax(torch.abs(RB), dim=0), torch.maximum(
            torch.amax(torch.abs(RL), dim=0), torch.amax(torch.abs(RU), dim=0)))
        dres = torch.amax(torch.abs(RC), dim=0)
        pobj = torch.sum(cT * X, dim=0)
        dobj = (torch.sum(bT * Y, dim=0)
                + torch.sum(where(fl, lb * ZL, 0.0), dim=0)
                - torch.sum(where(fu, ub * ZU, 0.0), dim=0))
        gap = torch.abs(pobj - dobj) / (1.0 + 0.5 * torch.abs(pobj + dobj))
        passed = ((pres <= self.feas_b) & (dres <= self.feas_c)
                  & (gap <= self.opt_tol))
        return RB, RC, RL, RU, mu, passed

    def converged(self, S):
        return self.residuals(S)[5]

    def step(self, S):
        ops, n, fl, fu = self.ops, self.n, self.fl, self.fu
        X, XL, XU, Y, ZL, ZU = (S[k] for k in ("X", "XL", "XU", "Y", "ZL",
                                               "ZU"))
        where = torch.where
        RB, RC, RL, RU, mu, passed = self.residuals(S)
        done = S["done"] | passed
        G = where(fl, ZL / XL, 0.0) + where(fu, ZU / XU, 0.0)
        regval = torch.minimum(mu, torch.amin(where(G > 0, G, INF), dim=0))
        W = where(G > 0, 1.0 / G, 1.0 / regval)
        resscale = 1.0 / torch.sqrt(W[n:])
        tol = self.kkt_tol * torch.sqrt(torch.clamp(mu, min=1e-300))
        diag = ops.A2 @ W[:n] + W[n:]

        def newton(sigma=None, DXL=None, DZL=None, DXU=None, DZU=None):
            if sigma is None:
                SL = where(fl, -XL * ZL, 0.0)
                SU = where(fu, -XU * ZU, 0.0)
            else:
                SL = where(fl, -XL * ZL + sigma * mu - DXL * DZL, 0.0)
                SU = where(fu, -XU * ZU + sigma * mu - DXU * DZU, 0.0)
            RHS1 = (-RC + where(fl, (SL + ZL * RL) / XL, 0.0)
                    - where(fu, (SU - ZU * RU) / XU, 0.0))
            WR = W * RHS1
            DY, trips = self.solve(W, diag, resscale, ops.AI(WR) - RB, tol)
            ATDY = ops.At @ DY
            DXs = W[:n] * (RHS1[:n] - ATDY)
            DX = torch.cat([DXs, RB - ops.A @ DXs], dim=0)
            fin = fl | fu
            DXL = where(fin, DX - RL, 0.0)
            DZL = where(fin, (SL - ZL * DXL) / XL, 0.0)
            DXU = where(fin, RU - DX, 0.0)
            DZU = where(fin, (SU - ZU * DXU) / XU, 0.0)
            ATDYn = -torch.cat([ATDY, DY], dim=0)
            use_l = fin & torch.isfinite(XL) & (~torch.isfinite(XU)
                                                | (ZL * XU >= ZU * XL))
            use_u = fin & torch.isfinite(XU) & ~use_l
            DZL = where(use_l, RC + DZU - ATDYn, DZL)
            DZU = where(use_u, -RC + DZL + ATDYn, DZU)
            DXL, DXU, DZL, DZU = (where(torch.isfinite(v), v, 0.0)
                                  for v in (DXL, DXU, DZL, DZU))
            return DX, DXL, DXU, -DY, DZL, DZU, trips

        def to_boundary(V, DV, fin):
            damp = 1.0 - np.finfo(float).eps
            cand = where(fin & (DV < 0.0) & torch.isfinite(V),
                         -(V * damp) / DV, INF)
            return torch.clamp(torch.amin(cand, dim=0), max=1.0)

        def max_steps(DXL, DXU, DZL, DZU):
            return (torch.minimum(to_boundary(XL, DXL, fl),
                                  to_boundary(XU, DXU, fu)),
                    torch.minimum(to_boundary(ZL, DZL, fl),
                                  to_boundary(ZU, DZU, fu)))

        DX, DXL, DXU, DY, DZL, DZU, t1 = newton()
        maxp, maxd = max_steps(DXL, DXU, DZL, DZU)
        comp = (torch.sum(where(fl, (XL + maxp * DXL) * (ZL + maxd * DZL),
                                0.0), dim=0)
                + torch.sum(where(fu, (XU + maxp * DXU) * (ZU + maxd * DZU),
                                  0.0), dim=0))
        muaff = comp / self.num_fin
        sigma = (muaff / torch.clamp(mu, min=1e-300)) ** 3
        DX, DXL, DXU, DY, DZL, DZU, t2 = newton(sigma, DXL, DZL, DXU, DZU)
        maxp, maxd = max_steps(DXL, DXU, DZL, DZU)
        ap = torch.minimum(torch.clamp(GAMMA * maxp + (1 - GAMMA),
                                       max=1.0 - 1e-6), maxp * (1 - 1e-12))
        ad = torch.minimum(torch.clamp(GAMMA * maxd + (1 - GAMMA),
                                       max=1.0 - 1e-6), maxd * (1 - 1e-12))
        # lanes not done take the step; the barrier parts where their bound
        # is finite, floored at FLOOR
        go = ~done
        gl, gu = go & fl, go & fu

        def floor(v):
            return torch.clamp(v, min=FLOOR)
        return dict(X=where(go, X + ap * DX, X),
                    XL=where(gl, floor(XL + ap * DXL), XL),
                    XU=where(gu, floor(XU + ap * DXU), XU),
                    Y=where(go, Y + ad * DY, Y),
                    ZL=where(gl, floor(ZL + ad * DZL), ZL),
                    ZU=where(gu, floor(ZU + ad * DZU), ZU), done=done,
                    iters=S["iters"] + (~done).to(torch.int64),
                    cr=S["cr"] + t1 + t2)

    def run(self, steps=None):
        """The stage to convergence, maxiter or the handoff, and on to
        `steps` steps where that is later; returns (the state at the end of
        its own run, the state after `steps` steps or None), each on the
        host as numpy arrays."""
        S = self.start()
        # the CR trips two solves of a step may take
        budget = 2 * self.cr_maxiter * (2 if self.mixed else 1)
        prev, saturated = S["cr"], 0
        own = at = None
        for k in range(1, self.maxiter + 1):
            S = self.step(S)
            if k == steps:
                at = host(S)
            if own is None:
                saturated = (saturated + 1 if S["cr"] - prev >= 0.8 * budget
                             else 0)
                prev = S["cr"]
                if bool(S["done"].all()) or saturated >= 2:
                    own = host(S)
            if own is not None and (steps is None or k >= steps):
                break
        return (own if own is not None else host(S)), at


def host(S):
    return {k: (v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
            for k, v in S.items()}
