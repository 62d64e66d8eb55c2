"""BASELINE-scale scenario batch through ipx_tpu_torch: 1024 perturbed-RHS
LPs end to end, the port's counterpart of examples/batch_scenarios_1000.py.

Pipeline (no reference counterpart), all on the device "--device" names:
  1. the batched phase-1 IPM over all scenarios at once
     (BatchedPhase1Solver, K5-K13, per-scenario convergence masks,
     diag-era handoff),
  2. per-scenario warm-started finishes to vertex (basic) solutions
     (shared mean-scenario starting basis) through LpSolver.

The direct solves that check a sample of the finishes run on the host path
("cpu"), independent of the device. Run:

    python examples/torch_batch_scenarios_1000.py [--device cuda]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402


def main(device="cuda"):
    from ipx_tpu_torch import LpSolver, Parameters, kernels
    from ipx_tpu_torch.parallel.batch import (BatchedPhase1Solver,
                                              BatchedScenarioSolver)
    import ipx_tpu_torch.testgen as tg

    data = tg.transportation(60, 90, 0.05, seed=2)
    m = data["num_constr"]
    ns = 60                      # rows [0, ns) are '<' supplies, rest '>='
    rng = np.random.default_rng(0)
    B = 1024
    # feasibility-preserving perturbations: supplies scale up, demands
    # scale down (a random +/-10% of every row can exceed total supply)
    fac = np.empty((B, m))
    fac[:, :ns] = rng.uniform(1.0, 1.1, size=(B, ns))
    fac[:, ns:] = rng.uniform(0.9, 1.0, size=(B, m - ns))
    b_batch = data["rhs"][None, :] * fac

    t0 = time.perf_counter()
    # a shallow batched sweep to a loose tolerance; the warm-started
    # finishes close the gap (phase2_polish stays off, as in the reference)
    solver = BatchedScenarioSolver(
        data, b_batch, phase1_tol=3e-3, phase1_maxiter=12,
        parameters=Parameters(display=0, device=device))
    ph1 = BatchedPhase1Solver(solver.blp, feasibility_tol=solver.phase1_tol,
                              optimality_tol=solver.phase1_tol,
                              maxiter=solver.phase1_maxiter, device=device)
    out = ph1.solve(handoff="auto")
    t1 = time.perf_counter()
    print(f"batched phase 1 on {ph1.device}: {t1 - t0:.1f}s "
          f"(converged {int(np.asarray(out['done']).sum())}/{B} at tol "
          f"{solver.phase1_tol:g})", flush=True)
    kernels.reset_launches()
    t2 = time.perf_counter()
    results = solver._finish(out)
    launched = {k: v for k, v in kernels.LAUNCHES.items() if v}
    print(f"per-scenario finishes on {device!r}: "
          f"{time.perf_counter() - t2:.1f}s, kernel launches {launched}",
          flush=True)
    dt = time.perf_counter() - t0

    statuses = np.array([r[0] for r in results])
    ipm_status = np.array([r[1].status_ipm for r in results])
    iters = np.array([r[1].iter for r in results])
    objs = np.array([r[1].pobjval for r in results])
    print(f"\n{B} scenarios in {dt:.1f}s "
          f"({dt / B * 1000:.0f} ms/scenario incl. batched phases)")
    print(f"statuses: {int((statuses == 1000).sum())}/{B} solved, "
          f"{int((ipm_status == 1).sum())}/{B} optimal verdicts")
    print(f"finish IPM iterations: mean {iters.mean():.2f}, "
          f"p90 {np.percentile(iters, 90):.0f}, max {iters.max()}")
    print(f"objectives: min {objs.min():.4f} max {objs.max():.4f}")

    # cross-check a sample against independent direct solves
    sample = rng.choice(B, size=8, replace=False)
    worst = 0.0
    for k in sample:
        s = LpSolver(Parameters(display=0, device="cpu"))
        tg.load_into_solver({**data, "rhs": b_batch[k]}, s)
        assert s.solve() == 1000
        assert s.get_info().status_ipm == 1, int(k)
        assert ipm_status[k] == 1, int(k)
        ref = s.get_info().pobjval
        worst = max(worst, abs(objs[k] - ref) / max(1.0, abs(ref)))
    print(f"sampled objective check vs direct solves: max rel diff "
          f"{worst:.2e}")
    assert worst < 1e-6


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    choices=("cuda", "torch_cpu", "cpu", "auto"))
    main(ap.parse_args().device)
