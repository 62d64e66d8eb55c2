"""The cost of finishing a scenario batch to vertex solutions from one
batched phase-1 state, under three finish strategies, through
ipx_tpu_torch: the counterpart of tools/batched_finish_bench.py, whose
strategies and keys it keeps.

  r3  per-scenario warm finishes only (each builds its own starting
      basis);
  r4  the mean scenario's shared basis and the batched polish without the
      low-rank correction, then the per-scenario finishes;
  r5  r4 with the polish's per-scenario low-rank correction of the
      shared-basis preconditioner (SharedBasisLowRank, parallel/batch2.py).

Phase 1 (BatchedPhase1Solver.solve(), to convergence), the polish's IPM
step and the finishes (the port's LpSolver) run on --device: "cuda" (the
default; the card, or raise) or "torch_cpu" (every kernel's plain version
on the CPU); the polish's shared-basis CR runs on the host. The
strategies are switched as the reference switches them, by swapping
BatchedScenarioSolver._solve_mean_basis (r3) and batch2.SharedBasisLowRank
(r4) on the port's modules, each restored afterwards. Every scenario is
also solved cold on the port's host path (device="cpu"), once, as the
yardstick of each strategy's objectives (|a - b| / max(1, |b|)).

It prints one JSON line with ms per scenario of each strategy and the
speedups; for r4 and r5 the lanes whose mu the polish left above where
it started, with their ratios (polish_mu_rise), and the diverged ones it
handed back unpolished (polish_reverted_lanes: above
SharedBasisBatchedPolish.DIVERGED); the card's name and power limit
("cpu" on torch_cpu), OMP_NUM_THREADS, the OpenBLAS pools' sizes (the
polish and the batched phase 1 run with the pools as they are:
native/threads.py's rule holds only inside LpSolver.solve()) and each
strategy's kernel launches. It exits 1 after its line when a finish or a
cold solve ends at a status other than 1000, or when an objective
differs by more than 1e-8.

Usage: python tools/torch_batched_finish_bench.py [--src 800 --snk 1200
           --B 64] [--device torch_cpu]
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_bench import (DEVICES, OBJ_RTOL, cold_solves,  # noqa: E402
                         device_of, emit, host_fields, launched, obj_rel,
                         scenarios, snapshot, sync)

from ipx_tpu_torch import Parameters  # noqa: E402
from ipx_tpu_torch import testgen as tg  # noqa: E402
from ipx_tpu_torch.parallel import batch as bmod  # noqa: E402
from ipx_tpu_torch.parallel import batch2 as b2  # noqa: E402


class _NoCorrection(b2.SharedBasisLowRank):
    """r4's SharedBasisLowRank: never active."""

    def __init__(self, *a, **k):
        self.active = False


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=DEVICES, default="cuda")
    ap.add_argument("--src", type=int, default=800)
    ap.add_argument("--snk", type=int, default=1200)
    ap.add_argument("--density", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--B", type=int, default=64)
    ap.add_argument("--phase1-tol", type=float, default=1e-4)
    args = ap.parse_args()
    dev = device_of(args.device)
    failures = []

    data = tg.transportation(args.src, args.snk, args.density, args.seed)
    m = data["num_constr"]
    B = args.B
    b_batch = scenarios(data, args.src, B)
    params = Parameters(display=0, device=args.device)

    def solver():
        return bmod.BatchedScenarioSolver(data, b_batch, parameters=params,
                                          phase2_polish=False,
                                          phase1_tol=args.phase1_tol)

    # one phase-1 state, the same input to every strategy
    ph1 = bmod.BatchedPhase1Solver(solver().blp,
                                   feasibility_tol=args.phase1_tol,
                                   optimality_tol=args.phase1_tol,
                                   maxiter=100, device=args.device)
    snap = snapshot()
    t0 = time.perf_counter()
    state = ph1.solve()
    sync(dev)
    t_phase1 = time.perf_counter() - t0
    phase1_launches = launched(snap)
    print(f"# phase 1: {t_phase1:.2f} s", file=sys.stderr, flush=True)

    cold_runs = cold_solves(data, b_batch)
    failures += [f"cold solve {k}: status {st}"
                 for k, (st, _) in enumerate(cold_runs) if st != 1000]
    cold = [info.pobjval for _, info in cold_runs]
    print(f"# {B} cold solves done", file=sys.stderr, flush=True)

    def run(tag, polish):
        s = solver()
        out = {k: v.copy() for k, v in state.items()}
        snap = snapshot()
        t0 = time.perf_counter()
        if polish:
            s.phase2_polish = True
            out = s._polish(out)
        res = s._finish(out)
        sync(dev)
        dt = time.perf_counter() - t0
        statuses = [st for st, _, _ in res]
        rel = max(obj_rel(info.pobjval, c)
                  for (_, info, _), c in zip(res, cold))
        failures.extend(
            f"{tag}: scenario {k}: status {st} (status_ipm "
            f"{info.status_ipm}, status_crossover {info.status_crossover}, "
            f"errflag {info.errflag}, {info.iter} IPM iterations)"
            for k, (st, info, _) in enumerate(res) if st != 1000)
        if rel > OBJ_RTOL:
            failures.append(f"{tag}: objectives differ from the cold "
                            f"solves' by {rel:.3e}")
        print(f"# {tag}: {dt:.2f} s, {statuses.count(1000)} of {B} "
              f"optimal", file=sys.stderr, flush=True)
        return dict(ms_per_scen=dt / B * 1000, total_s=dt,
                    optimal=statuses.count(1000),
                    mean_finish_iters=float(np.mean(
                        [info.iter for _, info, _ in res])),
                    max_obj_rel_diff=rel,
                    polish_steps=(len(s.polish.step_cr) if s.polish
                                  else None),
                    polish_cr_iters=(s.polish.total_cr_iters if s.polish
                                     else None),
                    polish_mu_rise=(s.polish.mu_rise if s.polish
                                    else None),
                    polish_reverted_lanes=(s.polish.reverted_lanes
                                           if s.polish else None),
                    launches=launched(snap))

    # r3: no shared basis, no polish: the per-scenario finishes alone
    saved = bmod.BatchedScenarioSolver._solve_mean_basis
    bmod.BatchedScenarioSolver._solve_mean_basis = lambda self: None
    try:
        r3 = run("r3", polish=False)
    finally:
        bmod.BatchedScenarioSolver._solve_mean_basis = saved
    # r4: the shared basis and the polish without the low-rank correction
    saved_lr = b2.SharedBasisLowRank
    b2.SharedBasisLowRank = _NoCorrection
    try:
        r4 = run("r4", polish=True)
    finally:
        b2.SharedBasisLowRank = saved_lr
    # r5: the whole pipeline, with the correction
    r5 = run("r5", polish=True)

    emit({"m": int(m), "n": int(data["num_var"]), "B": B,
          "device": args.device,
          "phase1_s": t_phase1,
          "phase1_steps": int(np.asarray(state["iters"]).max()),
          "phase1_done_count": int(np.sum(state["done"])),
          "phase1_launches": phase1_launches,
          "r3_finish_only": r3,
          "r4_shared_basis_polish": r4,
          "r5_polish_with_correction": r5,
          "speedup_r5_vs_r3": r3["ms_per_scen"] / r5["ms_per_scen"],
          "speedup_r5_vs_r4": r4["ms_per_scen"] / r5["ms_per_scen"],
          "cold_objs": cold,
          **host_fields(dev)}, failures)


if __name__ == "__main__":
    main()
