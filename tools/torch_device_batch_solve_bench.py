"""The whole batched scenario phase 1 at the reference's scale on one
device, through ipx_tpu_torch: the counterpart of
tools/device_batch_solve_bench.py, whose measurement and JSON keys it
follows.

It runs the batched predictor-corrector IPM of
ipx_tpu_torch/parallel/batch.py (BatchedPhase1Solver: its starting point
K13, then steps of K5-K12 with the lane-masked batched CR K7 and K6's
applies) over B perturbed right-hand sides of transportation(src, snk,
density, seed), and prints one JSON line: scenarios/s, IPM iterations/s
and CR lane-matvecs/s (each CR trip applies the batched normal matrix over
all B lanes).

--device cuda (the default) is the card, or raises; --device torch_cpu
runs the same program with every kernel's plain version on the CPU (use
--maxsteps to bound it). The loop drives BatchedPhase1Solver's
_starting_point() and _ipm_step() as solve() does, with the one host read
of the done mask a step that solve() makes, and --handoff applies solve()'s
rule (stop once the CR budget saturates two steps in a row). One start and
one step run untimed first (warmup_s: the kernels' build and plans), then
the timed run starts afresh. The line carries the card's name and power
limit ("cpu" on torch_cpu), OMP_NUM_THREADS, the OpenBLAS pools' sizes and
the kernel launches of the timed run.

Usage:
    python tools/torch_device_batch_solve_bench.py --B 256
    python tools/torch_device_batch_solve_bench.py --device torch_cpu \\
        --B 256 --maxsteps 2
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_bench import (DEVICES, device_of, emit, host_fields,  # noqa: E402
                         launched, scenarios, snapshot, sync)

from ipx_tpu_torch import testgen as tg  # noqa: E402
from ipx_tpu_torch.parallel.batch import (  # noqa: E402
    BatchedPhase1Solver, BatchedScenarioSolver)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=DEVICES, default="cuda")
    ap.add_argument("--src", type=int, default=8000)
    ap.add_argument("--snk", type=int, default=12000)
    ap.add_argument("--density", type=float, default=0.001)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--B", type=int, default=256)
    ap.add_argument("--tol", type=float, default=1e-4)
    ap.add_argument("--cr-maxiter", type=int, default=500)
    ap.add_argument("--cr64-maxiter", type=int, default=None,
                    help="budget of the f64 finish of the mixed CR")
    ap.add_argument("--maxsteps", type=int, default=0,
                    help="0 = run to convergence (or the 100-step cap)")
    ap.add_argument("--handoff", action="store_true",
                    help="stop at the handoff point (the rule of "
                    "BatchedPhase1Solver.solve(handoff='auto')) instead of "
                    "convergence")
    args = ap.parse_args()
    dev = device_of(args.device)

    data = tg.transportation(args.src, args.snk, args.density, args.seed)
    m = data["num_constr"]
    B = args.B
    b_batch = scenarios(data, args.src, B)
    bss = BatchedScenarioSolver(data, b_batch, phase2_polish=False,
                                phase1_tol=args.tol)
    t0 = time.perf_counter()
    ph1 = BatchedPhase1Solver(bss.blp, feasibility_tol=args.tol,
                              optimality_tol=args.tol,
                              cr_maxiter=args.cr_maxiter, maxiter=100,
                              cr64_maxiter=args.cr64_maxiter,
                              device=args.device)
    sync(dev)
    setup_s = time.perf_counter() - t0

    # warm-up: a start and a step build the kernels and the plans
    t0 = time.perf_counter()
    S = ph1._ipm_step(ph1._starting_point())
    sync(dev)
    warmup_s = time.perf_counter() - t0
    del S

    # the timed run from a fresh starting point
    maxsteps = args.maxsteps if args.maxsteps > 0 else 100
    snap = snapshot()
    t_run0 = time.perf_counter()
    S = ph1._starting_point()
    bool(S["done"].all())
    start_s = time.perf_counter() - t_run0
    handoff_due = ph1.handoff_rule(S)
    step_times = []
    converged = handoff = False
    while len(step_times) < maxsteps:
        t1 = time.perf_counter()
        S = ph1._ipm_step(S)
        done = bool(S["done"].all())      # the one sync a step of solve()
        step_times.append(time.perf_counter() - t1)
        print(f"# step {len(step_times)}: {step_times[-1]:.3f}s",
              file=sys.stderr, flush=True)
        if done:
            converged = True
            break
        if args.handoff and handoff_due(S):
            handoff = True
            break
    sync(dev)
    wall_s = time.perf_counter() - t_run0
    launches = launched(snap)
    cr_trips = int(S["cr"])
    iters = S["iters"].cpu().numpy()
    steps = len(step_times)
    med_step = float(np.median(step_times[1:] if steps > 1
                               else step_times))

    out = {
        "device": args.device,
        "platform": S["X"].device.type,
        "m": int(m), "n": int(data["num_var"]), "B": B,
        "tol": args.tol,
        "steps": steps,
        "converged_all": converged,
        "handoff": handoff,
        "mu_med_final": float(np.median(S["mu"].cpu().numpy())),
        "done_count": int(S["done"].sum()),
        "mean_ipm_iters": float(iters.mean()),
        "cr_trips": cr_trips,
        "setup_s": setup_s,
        "warmup_s": warmup_s,
        "start_s": start_s,
        "wall_s": wall_s,
        "median_step_s": med_step,
        "steps_s": step_times[:3],
        "cr_matvec_lane_equiv_per_s": cr_trips * B / wall_s,
        "ipm_iters_per_s": float(iters.sum()) / wall_s,
        "scenarios_per_s": B / wall_s if converged else None,
        "launches": launches,
        **host_fields(dev),
    }
    emit(out, [])


if __name__ == "__main__":
    main()
