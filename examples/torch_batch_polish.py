"""Scenario fleet with the shared-basis phase-2 polish, through
ipx_tpu_torch, the port's counterpart of examples/batch_polish.py.

Pipeline: batched diagonal-preconditioned phase 1 over all scenarios at
once -> one mean-scenario solve provides a basis -> the shared-basis
batched polish drives every scenario near complementarity with blocked
multi-RHS B/B' solves on the host and its step on the device -> per-scenario
warm-started finishes (phase 2 + crossover), all on the device "--device"
names. Run standalone:

    python examples/torch_batch_polish.py [--device cuda|torch_cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402


def main(device="cuda"):
    from ipx_tpu_torch import Parameters
    from ipx_tpu_torch.parallel.batch import BatchedScenarioSolver
    from ipx_tpu_torch.testgen import transportation

    data = transportation(80, 160, 0.05, seed=1)
    m = data["num_constr"]
    rng = np.random.default_rng(2)
    B = 8
    b_batch = data["rhs"][None, :] * rng.uniform(0.97, 1.06, size=(B, m))

    p = Parameters(display=0, device=device)
    solver = BatchedScenarioSolver(data, b_batch, parameters=p,
                                   phase2_polish=True)
    results = solver.solve()
    ok = sum(1 for st, _, _ in results if st == 1000)
    finish_iters = sum(i.iter for _, i, _ in results)
    print(f"{B} scenarios solved to vertex optima: {ok}/{B} optimal, "
          f"{finish_iters} total finish IPM iterations")
    for k, (st, info, _) in enumerate(results[:4]):
        print(f"  scenario {k}: objective {info.objval:.6e}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "torch_cpu"))
    main(ap.parse_args().device)
