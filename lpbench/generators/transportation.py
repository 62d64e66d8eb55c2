"""The transportation LPs of the project's own benchmark, and their
scenario rule.

`make` is a copy of the project's generator (ipx_tpu_torch/testgen.py
`transportation`, itself a copy of ipx_tpu/testgen.py), so that the
instances stay what they are whatever later changes make of the program.
`scenarios` is the rule of the reference's tools/device_batch_solve_bench.py
(lines 72-81), drawn from (seed, request) instead of default_rng(0).
"""
from __future__ import annotations

import numpy as np

def make(num_sources: int, num_sinks: int, density: float = 0.25,
                   seed: int = 0):
    """Capacitated transportation problem:
    min sum c_ij x_ij  st  sum_j x_ij <= supply_i, sum_i x_ij >= demand_j,
    0 <= x_ij <= cap. The user form of LpSolver.load_model, as a dict."""
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


def scenarios(data: dict, sources: int, B: int, seed: int, request: int):
    """The (B, m) right-hand sides of one request: the supplies (the first
    `sources` rows, '<') times U(1.0, 1.1), the demands times U(0.9, 1.0),
    which keeps every scenario feasible; drawn from (seed, request)."""
    m = data["num_constr"]
    rng = np.random.default_rng([seed, request])
    fac = np.empty((B, m))
    fac[:, :sources] = rng.uniform(1.0, 1.1, size=(B, sources))
    fac[:, sources:] = rng.uniform(0.9, 1.0, size=(B, m - sources))
    return data["rhs"][None, :] * fac
