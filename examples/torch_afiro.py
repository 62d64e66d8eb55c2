"""Example: solve the Netlib problem afiro through the LpSolver API of
ipx_tpu_torch, the port's counterpart of examples/afiro.py.

Counterpart of the reference example (reference: example/afiro.cc). The LP:
9 constraints, 12 variables, optimal objective -464.75314.

    python examples/torch_afiro.py [--device cuda|torch_cpu|cpu|auto]

"--device" names Parameters.device; the default "cuda" runs the KKT solves
on the card, and raises without one.
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from ipx_tpu_torch import LpSolver, Parameters  # noqa: E402

INF = np.inf

num_var = 12
num_constr = 9
obj = [-0.2194, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, -0.32,
       -0.5564, 0.6, -0.48]
lb = [0.0] * num_var
ub = [80.0, 283.303, 283.303, 312.813, 349.187, INF, INF, INF,
      57.201, 500.0, 500.501, 357.501]
Ap = [0, 2, 6, 10, 14, 18, 20, 22, 24, 26, 28, 30, 32]
Ai = [0, 5, 1, 6, 7, 8, 2, 6, 7, 8, 3, 6, 7, 8, 4, 6, 7, 8,
      1, 2, 2, 3, 2, 4, 0, 6, 0, 5, 2, 5, 5, 7]
Ax = [-1.0, 0.301, 1.0, -1.0, 0.301, 1.06, 1.0, -1.0, 0.313, 1.06,
      1.0, -1.0, 0.313, 0.96, 1.0, -1.0, 0.326, 0.86, -1.0, 0.99078,
      1.00922, -1.0, 1.01802, -1.0, 1.4, 1.0, 0.109, -1.0,
      -0.419111, 1.0, 1.4, -1.0]
rhs = [0.0, 80.0, 0.0, 0.0, 0.0, 0.0, 0.0, 44.0, 300.0]
constr_type = "<<=<<=<<<"


def main(device="cuda"):
    parameters = Parameters(device=device)
    # parameters.crossover = 0   # turns off crossover
    # parameters.debug = 1       # more output
    solver = LpSolver(parameters)

    errflag = solver.load_model(num_var, obj, lb, ub, num_constr,
                                Ap, Ai, Ax, rhs, constr_type)
    if errflag:
        raise SystemExit(f"invalid model (errflag {errflag})")

    solver.solve()
    info = solver.get_info()
    if info.status_ipm in (1, 2):          # optimal or imprecise
        interior = solver.get_interior_solution()
        print("interior objective:", info.pobjval)
        print("x[:3] =", interior.x[:3])
    if info.status_crossover in (1, 2):
        basic = solver.get_basic_solution()
        print("vertex objective:", info.objval)
        print("vbasis =", basic.vbasis)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
