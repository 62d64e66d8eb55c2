"""The plain reference of a single LP solved to a vertex.

The LP in the user's form (LpSolver.load_model's arrays):

    min c'x  st  A x + slack = rhs,  lb <= x <= ub,
    slack >= 0 on '<' rows, <= 0 on '>' rows, = 0 on '=' rows.

Two parts, both plain PyTorch in float64, importing nothing of the program:

* `certificate(lp, answer)`: what holds of an optimal basic solution, from
  the LP's own data and the answer's x, slack, y, z and statuses (IPX's
  conventions: c = A'y + z, z >= 0 at a lower bound and <= 0 at an upper
  one, y <= 0 on a nonbasic '<' row and >= 0 on a '>' row, zero duals of
  basic variables). Every number is 0 on an exact vertex.
* `solve(lp, blocks)`: a straightforward Mehrotra predictor-corrector IPM
  on the same LP, for the optimal objective `obj_ref`. Its normal matrix
  A D A' is assembled in float64 from each column's products, scaled to a
  unit diagonal and factored by Cholesky: whole where `blocks` is None,
  else as a block-tridiagonal matrix of `blocks` rows a block (the rows of
  one period of a staircase), which the assembly checks. Each solve is
  refined REFINE times against the product K theta K' itself. It stops once
  the relative gap and the primal and dual infeasibilities are at most
  TOL.
"""
from __future__ import annotations

import warnings

import numpy as np
import scipy.sparse as sp
import torch

F64 = torch.float64
INF = float("inf")
TOL = 1e-9          # the reference IPM's gap and infeasibilities
MAXITER = 200
ETA = 0.9995        # the fraction of the step to the boundary
REFINE = 2          # steps of iterative refinement of each normal solve
# statuses of the answer's columns (vbasis) and rows (cbasis), as IPX's
BASIC, NONBASIC_LB, NONBASIC_UB, SUPERBASIC = 0, -1, -2, -3
ROW_NONBASIC = -1


def _exact():
    """No reduced-precision matrix products anywhere in the reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _csr(M: sp.spmatrix, device) -> torch.Tensor:
    M = sp.csr_matrix(M, dtype=np.float64)
    M.sort_indices()
    with warnings.catch_warnings():
        # torch calls its sparse CSR support a beta
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(
            torch.from_numpy(M.indptr.astype(np.int64)),
            torch.from_numpy(M.indices.astype(np.int64)),
            torch.from_numpy(M.data), size=M.shape, dtype=F64,
            device=device)


class Lp:
    """The LP of `data` (a generator's dict) with the costs `c`, on
    `device`: A and A' as CSR tensors and the vectors in float64."""

    def __init__(self, data: dict, c, device="cpu"):
        self.m, self.n = int(data["num_constr"]), int(data["num_var"])
        self.A = sp.csc_matrix((np.asarray(data["Ax"], dtype=np.float64),
                                np.asarray(data["Ai"]),
                                np.asarray(data["Ap"])),
                               shape=(self.m, self.n))
        self.types = np.array(list(data["constr_type"]))
        self.lb = np.asarray(data["lb"], dtype=np.float64)
        self.ub = np.asarray(data["ub"], dtype=np.float64)
        self.rhs = np.asarray(data["rhs"], dtype=np.float64)
        self.c = np.asarray(c, dtype=np.float64)
        self.device = torch.device(device)
        self.At_dev = _csr(self.A.T, self.device)
        self.A_dev = _csr(self.A, self.device)

    def t(self, v) -> torch.Tensor:
        return torch.as_tensor(np.asarray(v, dtype=np.float64),
                               device=self.device)


# -- the vertex certificate ----------------------------------------------------
def certificate(lp: Lp, answer: dict) -> dict:
    """The judged numbers of `answer` (x, slack, y, z, vbasis, cbasis) as
    an optimal basic solution of `lp`, and its objective c'x (`obj`)."""
    _exact()
    t = lp.t
    x, slack, y, z = (t(answer[k]) for k in ("x", "slack", "y", "z"))
    vb = torch.as_tensor(np.asarray(answer["vbasis"]), device=lp.device)
    cb = torch.as_tensor(np.asarray(answer["cbasis"]), device=lp.device)
    lb, ub, rhs, c = t(lp.lb), t(lp.ub), t(lp.rhs), t(lp.c)
    lt, gt, eq = (torch.as_tensor(lp.types == s, device=lp.device)
                  for s in "<>=")
    zero = torch.zeros((), dtype=F64, device=lp.device)

    def most(v):
        return float(torch.max(v)) if v.numel() else 0.0

    cmax = 1.0 + most(torch.abs(c))
    primal = lp.A_dev @ x + slack - rhs
    primal_res = most(torch.abs(primal)) / (1.0 + most(torch.abs(rhs)))
    bound_viol = max(0.0, most(lb - x), most(x - ub), most(-slack[lt]),
                     most(slack[gt]), most(torch.abs(slack[eq])))
    dual = c - lp.At_dev @ y - z
    dual_res = most(torch.abs(dual)) / cmax

    basic, at_lb, at_ub, superbasic = (vb == s for s in (
        BASIC, NONBASIC_LB, NONBASIC_UB, SUPERBASIC))
    free = torch.isinf(lb) & torch.isinf(ub)
    fixed = lb == ub
    row_basic, row_nb = cb == BASIC, cb == ROW_NONBASIC
    sign_viol = max(most(torch.abs(z[basic | superbasic])),
                    most(-z[at_lb & ~fixed]), most(z[at_ub & ~fixed]),
                    most(torch.abs(y[row_basic])),
                    most(y[row_nb & lt]), most(-y[row_nb & gt])) / cmax

    obj = float(c @ x)
    # z+ with the distance to the lower bound, z- with the upper's, over
    # the columns and the rows' slacks (whose dual is -y), finite sides only
    def side(dual_part, dist):
        return torch.where(torch.isfinite(dist), dual_part * dist,
                           zero).sum()
    w = -y
    gap = (side(torch.clamp(z, min=0), x - lb)
           + side(torch.clamp(-z, min=0), ub - x)
           + side(torch.clamp(w, min=0), torch.where(gt, INF, slack))
           + side(torch.clamp(-w, min=0), torch.where(lt, INF, -slack)))
    compl = float(gap) / (1.0 + abs(obj))

    off = (at_lb & (torch.isinf(lb) | (x != lb))) \
        | (at_ub & (torch.isinf(ub) | (x != ub))) \
        | (superbasic & ~(free & (x == 0))) \
        | ~(basic | at_lb | at_ub | superbasic)
    row_off = (row_nb & (slack != 0)) | ~(row_basic | row_nb)
    nbasic = int(basic.sum()) + int(row_basic.sum())
    off_vertex = int(off.sum()) + int(row_off.sum()) + abs(nbasic - lp.m)
    return dict(primal_res=primal_res, bound_viol=bound_viol,
                dual_res=dual_res, sign_viol=sign_viol, compl=compl,
                off_vertex=off_vertex, obj=obj)


# -- the normal matrix -----------------------------------------------------------
class Normal:
    """M = K diag(theta) K' for the standard form's columns K (m x N CSC),
    assembled from each column's products of its nonzeros and factored by
    Cholesky, whole or block-tridiagonal in blocks of `blocks` rows."""

    def __init__(self, K: sp.csc_matrix, blocks, device):
        K = sp.csc_matrix(K)
        K.sort_indices()
        self.m = K.shape[0]
        self.device = device
        count = np.diff(K.indptr)
        col = np.repeat(np.arange(K.shape[1]), count)
        rows, vals = K.indices.astype(np.int64), K.data
        p, q, j, prod = [], [], [], []
        # every ordered pair of nonzeros of a column, the diagonal's once
        for d in range(int(count.max()) if count.size else 0):
            a = np.arange(col.size - d)
            a = a[col[a] == col[a + d]]
            for s, u in ((a, a + d), (a + d, a)) if d else ((a, a),):
                p.append(rows[s])
                q.append(rows[u])
                j.append(col[s])
                prod.append(vals[s] * vals[u])
        p, q, j, prod = (np.concatenate(v) for v in (p, q, j, prod))
        self.bs = blocks
        if blocks is None:
            index = p * self.m + q
            self.shape = (self.m, self.m)
        else:
            if self.m % blocks:
                raise ValueError(f"{self.m} rows are no whole number of "
                                 f"blocks of {blocks}")
            self.nb = self.m // blocks
            bp, bq = p // blocks, q // blocks
            if np.any(np.abs(bp - bq) > 1):
                raise ValueError("A D A' is not block tridiagonal in blocks "
                                 f"of {blocks} rows")
            # the diagonal blocks, then the nb - 1 blocks below them
            keep = bp >= bq
            p, q, j, prod, bp, bq = (v[keep] for v in (p, q, j, prod, bp,
                                                      bq))
            local = (p % blocks) * blocks + q % blocks
            index = np.where(bp == bq, bp, self.nb + bq) * blocks * blocks \
                + local
            self.shape = (2 * self.nb - 1, blocks, blocks)
        self.breakdowns = 0
        self.index = torch.as_tensor(index, device=device)
        self.col = torch.as_tensor(j, device=device)
        self.prod = torch.as_tensor(prod, device=device)

    def factor(self, theta: torch.Tensor):
        flat = torch.zeros(int(np.prod(self.shape)), dtype=F64,
                           device=self.device)
        flat.index_add_(0, self.index, theta[self.col] * self.prod)
        M = flat.view(self.shape)
        # scaled to a unit diagonal, so that a breakdown's shift is relative
        # to each row's own size; an empty row of A (a period's row that no
        # column touches) gets a 1 on the diagonal and its dy, 0, from it
        if self.bs is None:
            diag = torch.diagonal(M)
        else:
            diag = torch.diagonal(M[:self.nb], dim1=1, dim2=2).reshape(-1)
        empty = (diag == 0).to(F64)
        self.scale = torch.rsqrt(diag + empty)
        if self.bs is None:
            M.mul_(self.scale[:, None]).mul_(self.scale[None, :])
            torch.diagonal(M).add_(empty)
            self.L = self._cholesky(M)
            return
        nb = self.nb
        s = self.scale.view(nb, self.bs)
        D = M[:nb] * s[:, :, None] * s[:, None, :]
        torch.diagonal(D, dim1=1, dim2=2).add_(empty.view(nb, self.bs))
        E = M[nb:] * s[1:, :, None] * s[:-1, None, :]
        self.L, self.C = [], []
        for k in range(nb):
            Dk = D[k]
            if k:
                # C_k = E_k L_{k-1}^{-T}; the Schur complement D_k - C_k C_k'
                Ck = torch.linalg.solve_triangular(
                    self.L[k - 1], E[k - 1].T, upper=False).T
                self.C.append(Ck)
                Dk = Dk - Ck @ Ck.T
            self.L.append(self._cholesky(Dk))

    def solve(self, r: torch.Tensor) -> torch.Tensor:
        r = r * self.scale
        if self.bs is None:
            return torch.cholesky_solve(r[:, None], self.L)[:, 0] \
                * self.scale
        bs, nb = self.bs, self.nb
        r = r.view(nb, bs, 1)
        zs = []
        for k in range(nb):
            rk = r[k] if not k else r[k] - self.C[k - 1] @ zs[-1]
            zs.append(torch.linalg.solve_triangular(self.L[k], rk,
                                                    upper=False))
        xs = [None] * nb
        for k in reversed(range(nb)):
            zk = zs[k] if k == nb - 1 else zs[k] - self.C[k].T @ xs[k + 1]
            xs[k] = torch.linalg.solve_triangular(self.L[k].T, zk,
                                                  upper=True)
        return torch.cat(xs).view(-1) * self.scale

    def _cholesky(self, M: torch.Tensor) -> torch.Tensor:
        """The lower Cholesky factor of M (unit diagonal); where the
        factorization breaks down, of M with its diagonal shifted by 1e-14,
        a hundred times more each try (counted in `breakdowns`)."""
        L, info = torch.linalg.cholesky_ex(M)
        shift = 1e-14
        while int(info):
            if shift > 1e-4:
                raise RuntimeError("the normal matrix is not positive "
                                   "definite")
            self.breakdowns += 1
            shifted = M.clone()
            shifted.diagonal().add_(shift)
            L, info = torch.linalg.cholesky_ex(shifted)
            shift *= 100.0
        return L


# -- the reference IPM -----------------------------------------------------------
def standard_form(lp: Lp):
    """(K, b, c, u, const): the LP as min c'v + const st K v = b,
    0 <= v <= u, its columns the structural ones shifted to their finite
    bound (negated where that is the upper one), then the slacks of the
    inequality rows ('>' negated); '=' rows have none."""
    lb, ub, A = lp.lb, lp.ub, lp.A
    if np.any(np.isinf(lb) & np.isinf(ub)):
        raise ValueError("the reference takes no free column")
    low = np.isfinite(lb)
    shift = np.where(low, lb, ub)
    sign = np.where(low, 1.0, -1.0)
    rows = np.nonzero(lp.types != "=")[0]
    K = sp.hstack([A @ sp.diags(sign),
                   sp.csc_matrix((np.where(lp.types[rows] == "<", 1.0, -1.0),
                                  (rows, np.arange(rows.size))),
                                 shape=(lp.m, rows.size))], format="csc")
    b = lp.rhs - A @ shift
    c = np.concatenate([sign * lp.c, np.zeros(rows.size)])
    u = np.concatenate([np.where(low, ub - lb, INF),
                        np.full(rows.size, INF)])
    return K, b, c, u, float(lp.c @ shift)


def solve(lp: Lp, blocks=None) -> dict:
    """The optimal objective of `lp` by Mehrotra's predictor-corrector
    method: {obj, iters, gap, primal_inf, dual_inf, breakdowns (of the
    factorizations)}. Raises where it does not reach TOL in MAXITER
    steps."""
    _exact()
    dev = lp.device
    K, b, c, u, const = standard_form(lp)
    normal = Normal(K, blocks, dev)
    Kd, Ktd = _csr(K, dev), _csr(K.T, dev)
    t = lp.t
    b, c = t(b), t(c)
    bounded = torch.isfinite(t(u))
    ub_ = torch.where(bounded, t(u), 0.0)
    one = bounded.to(F64)
    N = c.numel()
    nbd = int(bounded.sum())
    bmax, cmax = 1.0 + float(b.abs().max()), 1.0 + float(c.abs().max())
    umax = 1.0 + (float(ub_.abs().max()) if nbd else 0.0)

    # Mehrotra's start: the least-squares primal and dual, shifted inside
    # (w and s, the upper bounds' parts, are 1 and 0 off the bounded columns)
    normal.factor(torch.ones(N, dtype=F64, device=dev))
    v = Ktd @ normal.solve(b)
    y = normal.solve(Kd @ c)
    zt = c - Ktd @ y
    w = torch.where(bounded, ub_ - v, 1.0)
    z = torch.where(bounded, torch.clamp(zt, min=0), zt)
    s = one * torch.clamp(-zt, min=0)
    dp = max(-1.5 * float(torch.min(torch.minimum(v, w))), 0.0)
    dd = max(-1.5 * float(torch.min(torch.where(bounded, torch.minimum(z, s),
                                                z))), 0.0)
    v, w = v + dp, w + one * dp
    z, s = z + dd, s + one * dd
    xz = float(v @ z + (one * w) @ s)
    dp = 0.5 * xz / float(z.sum() + s.sum())
    dd = 0.5 * xz / float(v.sum() + (one * w).sum())
    v, w = v + dp, w + one * dp
    z, s = z + dd, s + one * dd

    def direction(rp, ru, rd, rz, rs, theta):
        """The Newton direction for the residuals and the complementarity
        right-hand sides rz (of v z) and rs (of w s)."""
        rhat = rd - rz / v + one * (rs - s * ru) / w
        r = rp + Kd @ (theta * rhat)
        dy = normal.solve(r)
        for _ in range(REFINE):
            dy = dy + normal.solve(r - Kd @ (theta * (Ktd @ dy)))
        dv = theta * (Ktd @ dy - rhat)
        dz = (rz - z * dv) / v
        dw = one * (ru - dv)
        ds = one * (rs - s * dw) / w
        return dv, dw, dy, dz, ds

    def step(x, dx):
        neg = dx < 0
        if not bool(neg.any()):
            return 1.0
        return min(1.0, float(torch.min(-x[neg] / dx[neg])))

    it = 0
    while True:
        rp = b - Kd @ v
        ru = one * (ub_ - v - w)
        rd = c - Ktd @ y - z + one * s
        pobj = float(c @ v)
        dobj = float(b @ y - ub_ @ (one * s))
        gap = abs(pobj - dobj) / (1.0 + abs(pobj))
        pinf = max(float(rp.abs().max()) / bmax,
                   float(ru.abs().max()) / umax if nbd else 0.0)
        dinf = float(rd.abs().max()) / cmax
        if gap <= TOL and pinf <= TOL and dinf <= TOL:
            break
        if it >= MAXITER or not np.isfinite(gap + pinf + dinf):
            raise RuntimeError(f"the reference IPM stopped after {it} steps "
                               f"at gap {gap:.3g}, infeasibilities "
                               f"{pinf:.3g} / {dinf:.3g}, "
                               f"{normal.breakdowns} breakdowns")
        mu = float(v @ z + (one * w) @ s) / (N + nbd)
        theta = 1.0 / (z / v + one * s / w)
        normal.factor(theta)
        # predictor
        dv, dw, dy, dz, ds = direction(rp, ru, rd, -v * z, -one * w * s,
                                       theta)
        ap = min(step(v, dv), step(w, dw))
        ad = min(step(z, dz), step(s, ds))
        mu_aff = float((v + ap * dv) @ (z + ad * dz)
                       + (one * (w + ap * dw)) @ (s + ad * ds)) / (N + nbd)
        sigma = (mu_aff / mu) ** 3
        # corrector
        rz = sigma * mu - v * z - dv * dz
        rs = one * (sigma * mu - w * s - dw * ds)
        dv, dw, dy, dz, ds = direction(rp, ru, rd, rz, rs, theta)
        ap = ETA * min(step(v, dv), step(w, dw))
        ad = ETA * min(step(z, dz), step(s, ds))
        v, w = v + ap * dv, torch.where(bounded, w + ap * dw, 1.0)
        y, z = y + ad * dy, z + ad * dz
        s = one * (s + ad * ds)
        it += 1
    return dict(obj=pobj + const, iters=it, gap=gap, primal_inf=pinf,
                dual_inf=dinf, breakdowns=normal.breakdowns)
