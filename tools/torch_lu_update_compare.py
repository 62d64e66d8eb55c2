"""PFI against Forrest-Tomlin through ipx_tpu_torch: the counterpart of
tools/lu_update_compare.py, with its instances and columns.

It solves crossover- and update-heavy testgen instances on --device under
lu_kernel=0 (the native PFI with hypersparse solves) and lu_kernel=1
(Forrest-Tomlin), and writes the table to --out, by default
docs/LU_UPDATE_torch_<device>[_quick].tbl (docs/LU_UPDATE.tbl is the
reference tool's and is never written). The table's header names the
device and the card (nvidia-smi name and power limit, or "cpu" on a
machine without one). Both kernels must reach the same objective, to 1e-6
relative, on every instance (the reference tool's assertion).

    python tools/torch_lu_update_compare.py [--device cuda|torch_cpu|cpu|auto]
        [--quick] [--out PATH]

--device is Parameters.device of every solve (default "cuda": the card, or
raise before any work; nothing falls back to the host). The last line
printed is one JSON object: the card, OMP_NUM_THREADS, the OpenBLAS pools'
sizes, the table's path and rows, one a solve, with the table's fields,
obj (Info.pobjval, which the two kernels must share), Info.objval, kkt1
(Info.kktiter1), dense_cols and the kernel launches of that solve. It
exits 1 after its line if a solve ends at a status other than 1000 or the
two kernels' objectives differ by more than 1e-6 relative.
"""
import argparse
import os
import sys
import time

TOOLS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TOOLS)
sys.path.insert(0, TOOLS)
from torch_bench import emit, host_fields, launched, machine, snapshot, \
    sync  # noqa: E402

from ipx_tpu_torch import LpSolver, Parameters, backend  # noqa: E402
from ipx_tpu_torch import testgen as tg  # noqa: E402

OBJ_RTOL = 1e-6
KERNELS = ((0, "pfi"), (1, "ft"))


def instances(quick):
    if quick:
        yield "transport(300,450)", tg.transportation(300, 450, 0.02, 1)
        yield "grid(40,40)", tg.grid_flow(40, 40, seed=1)
    else:
        yield "transport(2000,3000)", tg.transportation(2000, 3000, 0.004, 1)
        yield "grid(120,120)", tg.grid_flow(120, 120, seed=1)
        yield "staircase(40,300)", tg.staircase(40, 300, seed=1)
        yield "production(2000,200)", tg.production(2000, 200, seed=1)


def run(data, lu_kernel, device, dev):
    s = LpSolver(Parameters(display=0, device=device, lu_kernel=lu_kernel))
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
                iter=i.iter, kkt1=i.kktiter1, kkt2=i.kktiter2,
                dense_cols=i.dense_cols, upd_ipm=i.updates_ipm,
                upd_xover=i.updates_crossover,
                t_luupd=i.time_lu_update, t_luinv=i.time_lu_invert,
                t_ftran=i.time_ftran, t_btran=i.time_btran,
                launches=launched(snap))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=backend.DEVICES, default="cuda")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    dev = machine(args.device)
    out = args.out or os.path.join(
        REPO, "docs", f"LU_UPDATE_torch_{args.device}"
        + ("_quick" if args.quick else "") + ".tbl")

    hdr = (f"{'instance':24s} {'kern':4s} {'status':6s} {'time':>8s} "
           f"{'iter':>5s} {'kkt2':>6s} {'upd_ipm':>8s} {'upd_xo':>7s} "
           f"{'t_upd':>7s} {'t_inv':>7s} {'t_ftran':>8s} {'t_btran':>8s}")
    lines = [hdr, "-" * len(hdr)]
    print(hdr, flush=True)
    rows, failures = [], []
    for name, data in instances(args.quick):
        objs = {}
        for lk, kern in KERNELS:
            r = run(data, lk, args.device, dev)
            objs[lk] = r["obj"]
            line = (f"{name:24s} {kern:4s} {r['status']:<6d} "
                    f"{r['time']:8.2f} {r['iter']:5d} {r['kkt2']:6d} "
                    f"{r['upd_ipm']:8d} {r['upd_xover']:7d} "
                    f"{r['t_luupd']:7.3f} {r['t_luinv']:7.3f} "
                    f"{r['t_ftran']:8.3f} {r['t_btran']:8.3f}")
            lines.append(line)
            print(line, flush=True)
            if r["status"] != 1000:
                failures.append(f"{name} {kern}: status {r['status']}")
            rows.append({"instance": name, "kern": kern, **r})
        rel = abs(objs[0] - objs[1]) / max(1.0, abs(objs[0]))
        if not rel < OBJ_RTOL:
            failures.append(f"{name}: PFI and FT objectives {rel:.2e} apart")
    fields = host_fields(dev)
    with open(out, "w") as f:
        f.write(f"# PFI (lu_kernel=0) vs Forrest-Tomlin (lu_kernel=1), "
                f"ipx_tpu_torch on device \"{args.device}\"\n"
                f"# card: {fields['card']}; OMP_NUM_THREADS "
                f"{fields['OMP_NUM_THREADS']}; OpenBLAS pools "
                f"{fields['blas_pools']}, {fields['blas_in_solve']} in a "
                f"solve\n# regenerate: python tools/torch_lu_update_compare.py"
                f" --device {args.device}"
                + (" --quick" if args.quick else "") + "\n"
                f"# both kernels reach the same objective on every instance "
                f"(1e-6 relative): "
                + ("yes" if not failures else "NO, see the failures") + "\n")
        f.write("\n".join(lines) + "\n")
    print(f"wrote {out}", flush=True)
    emit({"device": args.device, **fields, "out": out, "rows": rows},
         failures)


if __name__ == "__main__":
    main()
