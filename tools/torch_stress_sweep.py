"""Randomized stress sweep through ipx_tpu_torch: many small solves across
generators x seeds x parameter variants, each checked against scipy-HiGHS
objectives and the basic-solution invariants. The counterpart of
tools/stress_sweep.py, with its generators, variants and pass rule.

    python tools/torch_stress_sweep.py [--device cuda|torch_cpu|cpu|auto]
        [--n 30 | --seeds a-b] [--only transport|grid|production|staircase]
        [--quick]

--device is Parameters.device of every solve (default "cuda": the card, or
raise before any work; nothing falls back to the host). --seeds a-b runs
the seeds a to b, both included, in place of 0 to n - 1; --only runs one
generator; --quick the first three variants.

It prints a FAIL line for each solve that misses the rule, a line per
generator and a TOTAL line, then one JSON line: the card (nvidia-smi name
and power limit, or "cpu" on a machine without one), OMP_NUM_THREADS and
the OpenBLAS pools' sizes, total, failures (the tags of the solves that
failed), wall_s, and rows, one a solve: gen, seed, variant, status,
pobjval, objval, highs (HiGHS's objective, null where it found none),
highs_status, iter, kktiter1, kktiter2, dense_cols and the kernel launches
of that solve (kernels.LAUNCHES, with the applies inside other kernels'
launches under "inside"). With dense columns (dense_cols > 0) phase 1
stays on the host (kkt/diag.py:_prepare_device, the reference's rule), so
such a solve launches no cr_step. It exits 1 after its line if any solve
failed.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_bench import emit, highs, host_fields, launched, machine, \
    snapshot  # noqa: E402

from ipx_tpu_torch import LpSolver, Parameters, backend  # noqa: E402
from ipx_tpu_torch.status import Status  # noqa: E402
from ipx_tpu_torch.testgen import grid_flow, load_into_solver, \
    production, staircase, transportation  # noqa: E402

GENS = [
    ("transport", lambda s: transportation(40 + s % 37, 60 + s % 53,
                                           0.1 + 0.002 * (s % 9), s)),
    ("grid", lambda s: grid_flow(5 + s % 9, 6 + s % 11, s)),
    ("production", lambda s: production(60 + s % 80, 50 + s % 60,
                                        3 + s % 4, s)),
    ("staircase", lambda s: staircase(4 + s % 7, 10 + s % 13,
                                      2 + s % 3, s)),
]

VARIANTS = [
    {},
    {"dualize": 1},
    {"scale": 0},
    {"crash_basis": 0},
    {"lu_kernel": 1},
    {"update_heuristic": 0},
]


def seed_range(text: str) -> range:
    """--seeds "a-b": the seeds a to b, both included."""
    a, _, b = text.partition("-")
    return range(int(a), int(b or a) + 1)


def passes(ref, status: int, info) -> bool:
    """tools/stress_sweep.py's rule: where HiGHS solved the LP, status
    1000, the objective within 1e-6 relative of HiGHS's and the basic
    solution's infeasibilities under 1e-6; where HiGHS found it infeasible
    or unbounded, or failed, any status."""
    if ref.status == 0:
        return (status == int(Status.SOLVED)
                and abs(info.pobjval - ref.fun)
                <= 1e-6 * max(1.0, abs(ref.fun))
                and info.primal_infeas < 1e-6
                and info.dual_infeas < 1e-6)
    return True


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=backend.DEVICES, default="cuda")
    ap.add_argument("--n", type=int, default=30, help="seeds per generator")
    ap.add_argument("--seeds", type=seed_range, default=None,
                    help="a-b: the seeds a to b, in place of --n")
    ap.add_argument("--only", choices=[name for name, _ in GENS])
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    dev = machine(args.device)
    variants = VARIANTS[:3] if args.quick else VARIANTS
    seeds = args.seeds if args.seeds is not None else range(args.n)

    t_start = time.perf_counter()
    rows, failures = [], []
    for name, gen in GENS:
        if args.only and name != args.only:
            continue
        for seed in seeds:
            data = gen(seed)
            ref = highs(data, "highs")[1]
            for var in variants:
                p = Parameters(display=0, device=args.device, **var)
                s = LpSolver(p)
                if load_into_solver(data, s) != 0:
                    raise RuntimeError(f"{name} seed={seed}: load_model "
                                       f"failed")
                snap = snapshot()
                status = s.solve()
                info = s.get_info()
                rows.append({
                    "gen": name, "seed": seed, "variant": var,
                    "status": status, "pobjval": info.pobjval,
                    "objval": info.objval,
                    "highs": float(ref.fun) if ref.status == 0 else None,
                    "highs_status": int(ref.status), "iter": info.iter,
                    "kktiter1": info.kktiter1, "kktiter2": info.kktiter2,
                    "dense_cols": info.dense_cols,
                    "launches": launched(snap)})
                if not passes(ref, status, info):
                    tag = f"{name} seed={seed} var={var}"
                    failures.append(tag)
                    print(f"FAIL {tag}: status={status} "
                          f"obj={info.pobjval} ref={ref.fun} "
                          f"pinf={info.primal_infeas} "
                          f"dinf={info.dual_infeas}", flush=True)
        print(f"{name}: done ({len(rows)} solves so far, {len(failures)} "
              f"failures)", flush=True)
    wall = time.perf_counter() - t_start
    print(f"TOTAL {len(rows)} solves, {len(failures)} failures", flush=True)
    emit({"device": args.device, **host_fields(dev), "total": len(rows),
          "wall_s": wall, "rows": rows}, failures)


if __name__ == "__main__":
    main()
