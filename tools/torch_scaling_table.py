"""The row-blocked phase-1 CR at P = 1, 2, 4 and 8 row blocks, through
ipx_tpu_torch: the counterpart of tools/scaling_table.py.

It runs ShardedDiagCR (parallel/sharding.py; the Parameters.shards path)
on the normal equations of transportation(src, snk, 0.001, 1) (m = 20 000
by default) with weights U(0.5, 2) from default_rng(0), tol 0.0 and a
fixed 200 trips, best of 3 after a warm-up solve. On "cuda" each solve is
one cooperative launch of K15 (csrc/sharded.cu), with K14v's split sum and
K1's block products inside; on "torch_cpu" the plain versions run.

All P blocks live on the one device, so the arithmetic is the same at
every P: t_P / t_1 measures the cost of splitting into blocks (the split
sums and the per-block products), not scaling over several devices. It
prints its table and one JSON line with the card's name and power limit
("cpu" on torch_cpu), OMP_NUM_THREADS, the OpenBLAS pools' sizes and the
kernel launches and inner applies of the timed solves. It writes no file
(docs/SCALING.tbl is the reference tool's). It exits 1 after its line if
a solve stops before its 200 trips or ends with a residual that is not
finite.

Usage: python tools/torch_scaling_table.py [--device torch_cpu]
           [--src 8000 --snk 12000]
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_bench import (DEVICES, device_of, emit, host_fields,  # noqa: E402
                         launched, matrix_of, snapshot, sync)

from ipx_tpu_torch import testgen as tg  # noqa: E402
from ipx_tpu_torch.parallel.sharding import ShardedDiagCR  # noqa: E402

ITERS = 200
BLOCKS = (1, 2, 4, 8)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=DEVICES, default="cuda")
    ap.add_argument("--src", type=int, default=8000)
    ap.add_argument("--snk", type=int, default=12000)
    args = ap.parse_args()
    dev = device_of(args.device)
    failures = []

    data = tg.transportation(args.src, args.snk, 0.001, 1)
    A = matrix_of(data)
    m, n = A.shape
    rng = np.random.default_rng(0)
    W = rng.uniform(0.5, 2.0, size=n + m)
    A2 = A.copy()
    A2.data = A2.data ** 2
    diag = np.asarray(A2 @ W[:n]).ravel() + W[n:]
    rhs = rng.standard_normal(m)
    resscale = 1.0 / np.sqrt(W[n:])

    rows = []
    t1 = None
    for P in BLOCKS:
        cr = ShardedDiagCR(A, P, device=dev)
        cr.solve(W[:n], W[n:], diag, resscale, rhs, 0.0, 5)    # warm-up
        snap = snapshot()
        best = None
        for _ in range(3):
            sync(dev)
            t0 = time.perf_counter()
            y, iters, err = cr.solve(W[:n], W[n:], diag, resscale, rhs,
                                     0.0, ITERS)
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
            if iters != ITERS:
                failures.append(f"P={P}: {iters} trips (err {err}), not "
                                f"{ITERS}")
        # the scaled residual of the last solve, on the host
        r = resscale * (rhs - (A @ (W[:n] * (A.T @ y)) + W[n:] * y))
        res = float(np.max(np.abs(r)))
        if not np.isfinite(res):
            failures.append(f"P={P}: residual {res}")
        if t1 is None:
            t1 = best
        rows.append({"blocks": P, "wall_s": best, "matvec_per_s":
                     ITERS / best, "t_P_over_t_1": best / t1,
                     "trips": iters, "err": err, "residual": res,
                     "launches": launched(snap)})
        print(f"blocks={P}: {best:.4f}s {ITERS / best:.1f} matvec/s "
              f"t_P/t_1 {best / t1:.2f} residual {res:.3e}", flush=True)

    print(f"# Row-blocked phase-1 CR on one {args.device} device "
          f"(tools/torch_scaling_table.py)\n# m={m} n={n} nnz={A.nnz} "
          f"fixed {ITERS} CR trips, best of 3; the blocks share one device,"
          f"\n# so t_P/t_1 is the cost of splitting into blocks, not "
          f"scaling.\n{'blocks':>8s} {'wall_s':>8s} {'matvec/s':>10s} "
          f"{'t_P/t_1':>8s}")
    for row in rows:
        print(f"{row['blocks']:>8d} {row['wall_s']:>8.4f} "
              f"{row['matvec_per_s']:>10.1f} {row['t_P_over_t_1']:>8.2f}")
    emit({"device": args.device, "m": int(m), "n": int(n), "nnz": A.nnz,
          "trips": ITERS, "rows": rows, **host_fields(dev)}, failures)


if __name__ == "__main__":
    main()
