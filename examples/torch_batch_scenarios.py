"""Example: solve a fleet of scenario LPs in one batched IPM on the card,
through ipx_tpu_torch, the port's counterpart of
examples/batch_scenarios.py.

Capability with no counterpart in the reference solver: many LPs sharing one
constraint matrix with perturbed rhs/cost solve simultaneously, the whole
interior point method running on the device (K5-K13).

    python examples/torch_batch_scenarios.py [--device cuda|torch_cpu]
"""
import argparse
import os
import sys

import numpy as np
import scipy.sparse as sp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(batch=16, device="cuda"):
    from ipx_tpu_torch.parallel.batch import BatchedLp, BatchedPhase1Solver
    from ipx_tpu_torch.testgen import production

    data = production(150, 120, nnz_per_col=5, seed=0)
    m, n = data["num_constr"], data["num_var"]
    A = sp.csc_matrix((data["Ax"], data["Ai"], data["Ap"]), shape=(m, n))

    rng = np.random.default_rng(1)
    b = data["rhs"][None, :] * rng.uniform(0.9, 1.1, size=(batch, m))
    c = np.zeros((batch, n + m))
    c[:, :n] = data["obj"][None, :] * rng.uniform(0.9, 1.1, size=(batch, n))
    lp = BatchedLp(A=A, b=b, c=c,
                   lb=np.concatenate([data["lb"], np.zeros(m)]),
                   ub=np.concatenate([data["ub"], np.full(m, np.inf)]))

    solver = BatchedPhase1Solver(lp, maxiter=100, device=device)
    out = solver.solve()
    print(f"{batch} scenarios on {solver.device}: "
          f"{int(out['done'].sum())} converged, "
          f"iterations {out['iters'].min()}..{out['iters'].max()}")
    print("objectives:", " ".join(f"{v:.4f}" for v in out["pobj"][:8]),
          "...")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    choices=("cuda", "torch_cpu", "cpu", "auto"))
    main(device=ap.parse_args().device)
