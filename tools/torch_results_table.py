"""Per-instance results table through ipx_tpu_torch: the counterpart of
tools/results_table.py, with its instances, time limits and columns.

It solves the testgen families at the reference's sizes with default
parameters on --device and records status, objective (the interior
point's, Info.pobjval, cross-checked against HiGHS where HiGHS runs
in-process), wall-clock, IPM iterations, CR iteration counts and the Info
time breakdown: transportation (network), staircase, grid (network flow),
production (dense-ish columns) and assignment (degenerate).

    python tools/torch_results_table.py [--device cuda|torch_cpu|cpu|auto]
        [--quick] [--out PATH]

--device is Parameters.device of every solve (default "cuda": the card, or
raise before any work; nothing falls back to the host). The table goes to
--out, by default docs/RESULTS_torch_<device>[_quick].tbl; its header
names the card (nvidia-smi name and power limit, or "cpu" on a machine
without one). The reference's docs/RESULTS*.tbl are never written. A
small solve on --device before the table keeps the process's first
launches out of its first row. HiGHS (scipy's highs-ipm) runs in-process
where m <= 50 000 and nnz <= 2 500 000, else in a subprocess that reports
only its wall time and status.

The last line printed is one JSON object: the card, OMP_NUM_THREADS, the
OpenBLAS pools' sizes, the tier, the table's path, and rows, one an
instance, with the table's fields (relHiGHS and hg_time null where not
measured), Info.objval, dense_cols and the kernel launches of that solve.
It exits 1 after its line if a solve ends at a status other than 1000 or
more than 1e-6 relative from HiGHS's objective (tools/stress_sweep.py's
tolerance).

    python tools/torch_results_table.py --device cuda            (ref sizes)
    python tools/torch_results_table.py --device torch_cpu --quick
"""
import argparse
import json
import os
import subprocess
import sys
import time

TOOLS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TOOLS)
sys.path.insert(0, TOOLS)
from torch_bench import emit, highs, host_fields, launched, machine, \
    snapshot, sync  # noqa: E402

from ipx_tpu_torch import LpSolver, Parameters, backend  # noqa: E402
from ipx_tpu_torch import testgen as tg  # noqa: E402

OBJ_RTOL = 1e-6
# name -> instance, by tier (tools/results_table.py:32-47)
TIERS = {
    "quick": {
        "transport(300,450)": lambda: tg.transportation(300, 450, 0.02, 1),
        "staircase(20,150)": lambda: tg.staircase(20, 150, seed=1),
        "grid(40,40)": lambda: tg.grid_flow(40, 40, seed=1),
        "production(500,60)": lambda: tg.production(500, 60, seed=1),
        "assignment(60)": lambda: tg.assignment(60, seed=1),
    },
    "ref": {
        "transport(8000,12000)":
            lambda: tg.transportation(8000, 12000, 0.001, 1),
        "transport(40000,60000)":
            lambda: tg.transportation(40000, 60000, 2e-4, 1),
        "staircase(120,1500)": lambda: tg.staircase(120, 1500, seed=1),
        "staircase(300,2000)": lambda: tg.staircase(300, 2000, seed=1),
        "grid(200,200)": lambda: tg.grid_flow(200, 200, seed=1),
        "production(20000,2000)":
            lambda: tg.production(20000, 2000, seed=1),
        "assignment(300)": lambda: tg.assignment(300, seed=1),
    },
}
TIME_LIMIT = {"quick": 120.0, "ref": 1200.0}


def run_ours(data, time_limit, device, dev):
    p = Parameters(display=0, device=device, time_limit=time_limit)
    s = LpSolver(p)
    if tg.load_into_solver(data, s) != 0:
        raise RuntimeError("load_model failed")
    snap = snapshot()
    sync(dev)
    t0 = time.perf_counter()
    status = s.solve()
    sync(dev)
    dt = time.perf_counter() - t0
    i = s.get_info()
    return dict(status=status, obj=i.pobjval, objval=i.objval, time=dt,
                iter=i.iter, k1=i.kktiter1, k2=i.kktiter2, t1=i.time_ipm1,
                t2=i.time_ipm2, tmx=i.time_maxvol, txo=i.time_crossover,
                dense_cols=i.dense_cols, launches=launched(snap))


_HIGHS_CHILD = r"""
import json, sys
sys.path.insert(0, %(tools)r)
import torch_bench
from torch_results_table import TIERS
t, st = torch_bench.highs_solve_time(TIERS[%(tier)r][%(name)r](), "highs-ipm")
print(json.dumps({"t": t, "status": st}))
"""


def run_highs(tier, name, timeout_s):
    """HiGHS's wall and status in a subprocess (scipy linprog has no time
    limit); None when it fails or runs past timeout_s."""
    code = _HIGHS_CHILD % {"tools": TOOLS, "tier": tier, "name": name}
    try:
        out = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True,
                             timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return None
    for line in (out.stdout or "").strip().splitlines()[::-1]:
        if line.startswith("{"):
            return json.loads(line)
    return None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=backend.DEVICES, default="cuda")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    dev = machine(args.device)
    tier = "quick" if args.quick else "ref"
    time_limit = TIME_LIMIT[tier]
    out = args.out or os.path.join(
        REPO, "docs", f"RESULTS_torch_{args.device}"
        + ("_quick" if args.quick else "") + ".tbl")
    run_ours(tg.transportation(30, 45, 0.3, 1), time_limit, args.device,
             dev)     # the process's first launches, out of the table

    hdr = (f"{'instance':24s} {'m':>7s} {'n':>8s} {'nnz':>9s} {'status':>6s} "
           f"{'objective':>16s} {'relHiGHS':>9s} {'time':>8s} {'hg_time':>8s}"
           f" {'iter':>5s} {'kkt1':>6s} {'kkt2':>6s} {'t_ipm1':>7s} "
           f"{'t_ipm2':>7s} {'t_mxv':>6s} {'t_xo':>6s}")
    lines = [hdr, "-" * len(hdr)]
    print(hdr, flush=True)
    rows, failures = [], []
    for name, make in TIERS[tier].items():
        data = make()
        m, n = data["num_constr"], data["num_var"]
        nnz = int(data["Ap"][-1])
        r = run_ours(data, time_limit, args.device, dev)
        # objective cross-check: in-process on small instances, subprocess
        # wall-clock comparison on the large tier
        rel = float("nan")
        hg_t = float("nan")
        if m <= 50000 and nnz <= 2_500_000:
            hg_t, res = highs(data, "highs-ipm")
            if res.status == 0:
                rel = abs(r["obj"] - res.fun) / max(1.0, abs(res.fun))
        else:
            h = run_highs(tier, name, time_limit + 300)
            if h:
                hg_t = h["t"]
        line = (f"{name:24s} {m:7d} {n:8d} {nnz:9d} {r['status']:>6d} "
                f"{r['obj']:16.8g} {rel:9.2e} {r['time']:8.2f} {hg_t:8.2f}"
                f" {r['iter']:5d} {r['k1']:6d} {r['k2']:6d} {r['t1']:7.2f} "
                f"{r['t2']:7.2f} {r['tmx']:6.2f} {r['txo']:6.2f}")
        lines.append(line)
        print(line, flush=True)
        if r["status"] != 1000:
            failures.append(f"{name}: status {r['status']}")
        elif rel > OBJ_RTOL:
            failures.append(f"{name}: objective {r['obj']!r} is {rel:.2e} "
                            f"from HiGHS's")
        rows.append({"instance": name, "m": m, "n": n, "nnz": nnz,
                     "status": r["status"], "objective": r["obj"],
                     "objval": r["objval"],
                     "relHiGHS": None if rel != rel else rel,
                     "time": r["time"],
                     "hg_time": None if hg_t != hg_t else hg_t,
                     "iter": r["iter"], "kkt1": r["k1"], "kkt2": r["k2"],
                     "t_ipm1": r["t1"], "t_ipm2": r["t2"],
                     "t_mxv": r["tmx"], "t_xo": r["txo"],
                     "dense_cols": r["dense_cols"],
                     "launches": r["launches"]})
    fields = host_fields(dev)
    with open(out, "w") as f:
        f.write(f"# ipx_tpu_torch per-instance results on device "
                f"\"{args.device}\" (testgen families at reference-like "
                f"sizes)\n# card: {fields['card']}; OMP_NUM_THREADS "
                f"{fields['OMP_NUM_THREADS']}; OpenBLAS pools "
                f"{fields['blas_pools']}, {fields['blas_in_solve']} in a "
                f"solve\n# regenerate: python tools/torch_results_table.py "
                f"--device {args.device}"
                + (" --quick" if args.quick else "") + "\n")
        f.write("# relHiGHS = |obj - obj_HiGHS-ipm| / max(1,|obj_HiGHS|); "
                "nan = comparator not run in-process (see hg_time)\n")
        f.write("\n".join(lines) + "\n")
    print(f"wrote {out}", flush=True)
    emit({"device": args.device, **fields, "tier": tier, "out": out,
          "rows": rows}, failures)


if __name__ == "__main__":
    main()
