"""Structured LP instance generators.

Synthetic families with the structure of the classic benchmark sets (Netlib /
Mittelmann): transportation problems, min-cost network flows on grids, and
multi-knapsack production models. Unlike uniformly random matrices, these
have the unit-entry, tree-like basis structure that the simplex-type linear
algebra exploits (hypersparse FTRAN/BTRAN, low LU fill), so they are the
honest performance testbed when the original MPS files are unavailable.

All generators return the dict-of-arrays form accepted by
LpSolver.load_model.

The port's copy of ipx_tpu/testgen.py.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

INF = np.inf


def transportation(num_sources: int, num_sinks: int, density: float = 0.25,
                   seed: int = 0):
    """Capacitated transportation problem:
    min sum c_ij x_ij  st  sum_j x_ij <= supply_i, sum_i x_ij >= demand_j,
    0 <= x_ij <= cap."""
    rng = np.random.default_rng(seed)
    arcs = []
    for i in range(num_sources):
        # each source connects to a random subset of sinks (>= 2)
        k = max(2, int(density * num_sinks))
        sinks = rng.choice(num_sinks, size=min(k, num_sinks), replace=False)
        arcs.extend((i, int(j)) for j in sinks)
    # ensure every sink is reachable
    covered = {j for _, j in arcs}
    for j in range(num_sinks):
        if j not in covered:
            arcs.append((int(rng.integers(num_sources)), j))
    arcs = sorted(set(arcs), key=lambda t: (t[1], t[0]))

    n = len(arcs)
    m = num_sources + num_sinks
    Ai, Ax, Ap = [], [], [0]
    for (i, j) in arcs:
        # column touches supply row i ('<') and demand row num_sources+j ('>')
        Ai.extend([i, num_sources + j])
        Ax.extend([1.0, 1.0])
        Ap.append(len(Ai))

    demand = rng.uniform(1.0, 10.0, size=num_sinks)
    # guarantee feasibility: assign each sink's demand to one incident
    # source and give that source the supply (plus headroom)
    supply = np.zeros(num_sources)
    sink_arcs = {}
    for (i, j) in arcs:
        sink_arcs.setdefault(j, []).append(i)
    for j in range(num_sinks):
        i = sink_arcs[j][int(rng.integers(len(sink_arcs[j])))]
        supply[i] += demand[j]
    supply += rng.uniform(0.5, 3.0, size=num_sources)   # slack headroom
    cost = rng.uniform(1.0, 20.0, size=n)
    cap = np.full(n, float(demand.max() * 2.0))

    rhs = np.concatenate([supply, demand])
    ctype = "<" * num_sources + ">" * num_sinks
    return dict(num_var=n, obj=cost, lb=np.zeros(n), ub=cap,
                num_constr=m, Ap=np.array(Ap, dtype=np.int64),
                Ai=np.array(Ai, dtype=np.int64),
                Ax=np.array(Ax, dtype=np.float64), rhs=rhs,
                constr_type=ctype)


def grid_flow(rows: int, cols: int, seed: int = 0):
    """Min-cost flow on a grid network with a super source/sink:
    flow conservation equalities, arc capacities."""
    rng = np.random.default_rng(seed)
    num_nodes = rows * cols

    def node(r, c):
        return r * cols + c

    arcs = []
    for r in range(rows):
        for c in range(cols):
            if c + 1 < cols:
                arcs.append((node(r, c), node(r, c + 1)))
                arcs.append((node(r, c + 1), node(r, c)))
            if r + 1 < rows:
                arcs.append((node(r, c), node(r + 1, c)))
                arcs.append((node(r + 1, c), node(r, c)))

    n = len(arcs)
    m = num_nodes
    Ai, Ax, Ap = [], [], [0]
    for (u, v) in arcs:
        if u < v:
            Ai.extend([u, v])
            Ax.extend([1.0, -1.0])
        else:
            Ai.extend([v, u])
            Ax.extend([-1.0, 1.0])
        Ap.append(len(Ai))

    # supplies: positive at a few sources, negative at sinks, sum zero
    b = np.zeros(m)
    k = max(2, num_nodes // 50)
    sources = rng.choice(num_nodes, size=k, replace=False)
    sinks = rng.choice(
        [i for i in range(num_nodes) if i not in set(sources)],
        size=k, replace=False)
    amt = rng.uniform(1.0, 5.0, size=k)
    b[sources] += amt
    b[sinks] -= amt

    cost = rng.uniform(1.0, 10.0, size=n)
    cap = np.full(n, float(amt.sum()))
    return dict(num_var=n, obj=cost, lb=np.zeros(n), ub=cap,
                num_constr=m, Ap=np.array(Ap, dtype=np.int64),
                Ai=np.array(Ai, dtype=np.int64),
                Ax=np.array(Ax, dtype=np.float64), rhs=b,
                constr_type="=" * m)


def production(num_products: int, num_resources: int, nnz_per_col: int = 8,
               seed: int = 0):
    """Dense-ish production planning: min -profit'x st R x <= capacity,
    0 <= x <= u. Netlib-style constraint density, positive data."""
    rng = np.random.default_rng(seed)
    n, m = num_products, num_resources
    Ai, Ax, Ap = [], [], [0]
    for j in range(n):
        k = min(m, max(2, int(rng.poisson(nnz_per_col))))
        rows_ = np.sort(rng.choice(m, size=k, replace=False))
        Ai.extend(rows_.tolist())
        Ax.extend(rng.uniform(0.1, 5.0, size=k).tolist())
        Ap.append(len(Ai))
    x0 = rng.uniform(0.0, 2.0, size=n)
    A = sp.csc_matrix((Ax, Ai, Ap), shape=(m, n))
    capacity = A @ x0 + rng.uniform(1.0, 5.0, size=m)
    profit = rng.uniform(1.0, 10.0, size=n)
    return dict(num_var=n, obj=-profit, lb=np.zeros(n),
                ub=np.full(n, 10.0), num_constr=m,
                Ap=np.array(Ap, dtype=np.int64),
                Ai=np.array(Ai, dtype=np.int64),
                Ax=np.array(Ax, dtype=np.float64), rhs=capacity,
                constr_type="<" * m)


def staircase(num_periods: int, vars_per_period: int,
              links_per_period: int = 4, seed: int = 0):
    """Multi-period staircase LP (the structure of the srd instances in the
    reference's benchmark set, reference: benchmark/results/srd.tbl): block
    rows per period coupled to the next period through link variables.
    Basis preconditioning shines here — srd is the family where the
    reference dominates both Gurobi barrier and simplex (BASELINE.md).

    min c'x  st  per period t: B_t x_t + C_t x_{t-1} = b_t,  0 <= x <= u.
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


def load_into_solver(data, solver):
    return solver.load_model(data["num_var"], data["obj"], data["lb"],
                             data["ub"], data["num_constr"], data["Ap"],
                             data["Ai"], data["Ax"], data["rhs"],
                             data["constr_type"])


def assignment(N: int, seed: int = 0, degree: int = 0):
    """Assignment-problem LP relaxation: massively degenerate (every basic
    solution is; the family behind the reference's nug results,
    reference: benchmark/results/nug.tbl). N^2 variables, 2N equality
    constraints, integral optimum equal to the matching cost.

    degree > 0 sparsifies: each worker is eligible for `degree` random
    jobs (plus a perfect-matching diagonal so the instance stays
    feasible) — N*(degree+1) variables, letting the row count scale to
    nug-class sizes (nug30: 52k rows) without an N^2 variable blow-up."""
    rng = np.random.default_rng(seed)
    Ap = [0]
    Ai: list = []
    Ax: list = []
    if degree <= 0:
        n = N * N
        obj = rng.uniform(0, 10, n)
        for i in range(N):
            for j in range(N):
                Ai.extend([i, N + j])
                Ax.extend([1.0, 1.0])
                Ap.append(len(Ai))
    else:
        cols = []
        perm = rng.permutation(N)      # feasibility: a perfect matching
        for i in range(N):
            jobs = set(rng.integers(0, N, size=degree).tolist())
            jobs.add(int(perm[i]))
            for j in sorted(jobs):
                cols.append((i, j))
        n = len(cols)
        obj = rng.uniform(0, 10, n)
        for (i, j) in cols:
            Ai.extend([i, N + j])
            Ax.extend([1.0, 1.0])
            Ap.append(len(Ai))
    return dict(num_var=n, obj=obj, lb=np.zeros(n),
                ub=np.full(n, INF), num_constr=2 * N,
                Ap=np.array(Ap, dtype=np.int64),
                Ai=np.array(Ai, dtype=np.int64),
                Ax=np.array(Ax, dtype=np.float64),
                rhs=np.ones(2 * N), constr_type="=" * (2 * N))
