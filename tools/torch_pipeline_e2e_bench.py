"""The scenario-batch pipeline end to end through ipx_tpu_torch, against a
cold loop over the scenarios: the counterpart of
tools/pipeline_e2e_bench.py, whose keys it keeps.

Pipeline: the batched phase 1 (BatchedPhase1Solver.solve(handoff="auto"):
K5-K13 on --device) stopped at the handoff, then the warm-started
per-scenario finishes (BatchedScenarioSolver._finish: the port's LpSolver
on --device, phase 2 with K3 and K4 on the card, and crossover). Baseline:
every scenario solved cold on the port's host path (LpSolver,
device="cpu"). One start and one step of phase 1 run untimed first
(warmup_s: the kernels' build and plans). It prints one JSON line with
scenarios/s both ways, the largest objective difference between them
(|a - b| / max(1, |b|)), the pipeline's objectives, the card's name and
power limit ("cpu" on torch_cpu), OMP_NUM_THREADS, the OpenBLAS pools'
sizes and the kernel launches of phase 1 and of the finishes. It exits 1
after its line when a finish or a cold solve ends at a status other than
1000, or when an objective differs by more than 1e-8.

Usage:
    python tools/torch_pipeline_e2e_bench.py --src 8000 --snk 12000 --B 64
    python tools/torch_pipeline_e2e_bench.py --device torch_cpu ...
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
from ipx_tpu_torch.parallel.batch import (  # noqa: E402
    BatchedPhase1Solver, BatchedScenarioSolver)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=DEVICES, default="cuda")
    ap.add_argument("--src", type=int, default=8000)
    ap.add_argument("--snk", type=int, default=12000)
    ap.add_argument("--density", type=float, default=0.001)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--B", type=int, default=64)
    ap.add_argument("--cr-maxiter", type=int, default=300)
    ap.add_argument("--cr64-maxiter", type=int, default=100)
    ap.add_argument("--skip-cold", action="store_true")
    args = ap.parse_args()
    dev = device_of(args.device)
    failures = []

    data = tg.transportation(args.src, args.snk, args.density, args.seed)
    m = data["num_constr"]
    B = args.B
    b_batch = scenarios(data, args.src, B)
    out = {"m": int(m), "n": int(data["num_var"]), "B": B,
           "phase1_device": args.device}

    # -- the pipeline: batched phase 1 to the handoff, then warm finishes
    s = BatchedScenarioSolver(data, b_batch, phase2_polish=False,
                              parameters=Parameters(display=0,
                                                    device=args.device))
    ph1 = BatchedPhase1Solver(s.blp, feasibility_tol=1e-4,
                              optimality_tol=1e-4, maxiter=100,
                              cr_maxiter=args.cr_maxiter,
                              cr64_maxiter=args.cr64_maxiter,
                              device=args.device)
    t0 = time.perf_counter()
    ph1._ipm_step(ph1._starting_point())
    sync(dev)
    out["warmup_s"] = time.perf_counter() - t0

    snap = snapshot()
    t0 = time.perf_counter()
    state = ph1.solve(handoff="auto")
    t_ph1 = time.perf_counter() - t0
    out["phase1_launches"] = launched(snap)
    out["phase1_s"] = t_ph1
    out["phase1_steps"] = int(np.asarray(state["iters"]).max())
    out["phase1_cr_trips"] = int(state["cr"])
    out["phase1_mu_med"] = float(np.median(state["mu"]))
    out["phase1_platform"] = ph1.device.type
    print(f"# phase 1: {t_ph1:.2f} s", file=sys.stderr, flush=True)

    snap = snapshot()
    t0 = time.perf_counter()
    res = s._finish(state)
    sync(dev)
    t_fin = time.perf_counter() - t0
    out["finish_launches"] = launched(snap)
    print(f"# finishes: {t_fin:.2f} s", file=sys.stderr, flush=True)
    statuses = [st for st, _, _ in res]
    out["finish_s"] = t_fin
    out["finish_ms_per_scen"] = t_fin / B * 1000
    out["finish_mean_iters"] = float(np.mean([i.iter for _, i, _ in res]))
    out["optimal"] = statuses.count(1000)
    out["pipeline_s"] = t_ph1 + t_fin
    out["pipeline_scen_per_s"] = B / (t_ph1 + t_fin)
    objs = [i.pobjval for _, i, _ in res]
    out["objs"] = objs
    if out["optimal"] != B:
        failures.append(f"finish statuses {statuses}")

    # -- the baseline: each scenario cold on the host path --------------------
    if not args.skip_cold:
        t0 = time.perf_counter()
        cold = cold_solves(data, b_batch)
        t_cold = time.perf_counter() - t0
        failures += [f"cold solve {k}: status {st}"
                     for k, (st, _) in enumerate(cold) if st != 1000]
        cold_objs = [info.pobjval for _, info in cold]
        out["cold_s"] = t_cold
        out["cold_scen_per_s"] = B / t_cold
        out["cold_mean_iters"] = float(np.mean([i.iter for _, i in cold]))
        out["pipeline_vs_cold"] = t_cold / (t_ph1 + t_fin)
        rel = max(obj_rel(a, b) for a, b in zip(objs, cold_objs))
        out["max_obj_rel_diff"] = rel
        if rel > OBJ_RTOL:
            failures.append(f"pipeline objectives differ from the cold "
                            f"solves' by {rel:.3e}")
    emit({**out, **host_fields(dev)}, failures)


if __name__ == "__main__":
    main()
