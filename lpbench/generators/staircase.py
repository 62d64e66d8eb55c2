"""The multi-period staircase LPs (the structure of the srd set of IPX's own
benchmark, ERGO-Code/ipx benchmark/results/srd.tbl).

`make` is a copy of the project's generator (ipx_tpu_torch/testgen.py
`staircase`, itself a copy of ipx_tpu/testgen.py), so that the instances
stay what they are whatever later changes make of the program.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def make(num_periods: int, vars_per_period: int,
         links_per_period: int = 4, seed: int = 0):
    """Multi-period staircase LP: block rows per period coupled to the next
    period through link variables.

    min c'x  st  per period t: B_t x_t + C_t x_{t-1} = b_t,  0 <= x <= u.
    The user form of LpSolver.load_model, as a dict.
    """
    rng = np.random.default_rng(seed)
    T, k = num_periods, vars_per_period
    rows_per = k // 2
    m = T * rows_per
    Ai, Ax, Ap = [], [], [0]
    n = 0
    for t in range(T):
        r0 = t * rows_per
        for j in range(k):
            # each variable touches 2-3 rows of its period
            nr = int(rng.integers(2, 4))
            rows_ = r0 + rng.choice(rows_per, size=min(nr, rows_per),
                                    replace=False)
            ent = rng.uniform(0.5, 2.0, size=rows_.size)
            # link variables also touch the previous period's rows
            if t > 0 and j < links_per_period:
                prev = (t - 1) * rows_per + rng.choice(
                    rows_per, size=1, replace=False)
                rows_ = np.concatenate([prev, rows_])
                ent = np.concatenate([[-1.0], ent])
            order = np.argsort(rows_)
            Ai.extend(rows_[order].tolist())
            Ax.extend(ent[order].tolist())
            Ap.append(len(Ai))
            n += 1
    A = sp.csc_matrix((Ax, Ai, Ap), shape=(m, n))
    x0 = rng.uniform(0.5, 1.5, size=n)
    b = np.asarray(A @ x0).ravel()
    cost = rng.uniform(1.0, 5.0, size=n)
    return dict(num_var=n, obj=cost, lb=np.zeros(n),
                ub=np.full(n, 10.0), num_constr=m,
                Ap=np.array(Ap, dtype=np.int64),
                Ai=np.array(Ai, dtype=np.int64),
                Ax=np.array(Ax, dtype=np.float64), rhs=b,
                constr_type="=" * m)
