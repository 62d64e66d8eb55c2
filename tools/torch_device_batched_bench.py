"""The batched normal-matrix apply over a sweep of B, through
ipx_tpu_torch: the counterpart of tools/device_batched_bench.py.

It measures C V = A (W_s * (A' V)) + W_slack * V at the bench's instance
(transportation(sources, sinks, density, 1), m = 20 000), in float32,
through K6 (kernels.normal_apply_batched, csrc/spmm.cu) on --device: K
applies back to back on a fixed V after a warm-up, best of 3, in
lane-applies per second (B per apply). Beside it:

  native  the port's native single-vector apply (kkt/normal_matrix.py,
          ipx_tpu_torch/native), looped over the batch: the host's best
          batch path;
  scipy   one batched product A' U, scaled, then A U (host, float64).

It also says which of K6's two forms kernels.NormalBatchedPlan took at
this A: one fused launch that never writes U, or the two K5 launches
(kernels.k6_fused). The reference normalises V inside one jitted loop;
here V stays fixed, since the normalisation would add launches that are
not the apply. It prints a table and one JSON line with the card's name
and power limit ("cpu" on torch_cpu), OMP_NUM_THREADS, the OpenBLAS
pools' sizes and K6's launches.

Usage: python tools/torch_device_batched_bench.py [--device torch_cpu]
           [--sources 8000 --sinks 12000] [--batches 8 32 64 128 256 512]
"""
import argparse
import os
import sys
import time

import numpy as np
import scipy.sparse as sp
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_bench import (DEVICES, best_rate, device_of, emit,  # noqa: E402
                         host_fields, launched, matrix_of,
                         native_matvec_rate, snapshot)

from ipx_tpu_torch import kernels  # noqa: E402
from ipx_tpu_torch import testgen as tg  # noqa: E402
from ipx_tpu_torch.ops.spmv import NormalMatrixDevice  # noqa: E402

K = 20      # applies a timed loop


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=DEVICES, default="cuda")
    ap.add_argument("--sources", type=int, default=8000)
    ap.add_argument("--sinks", type=int, default=12000)
    ap.add_argument("--density", type=float, default=0.001)
    ap.add_argument("--batches", type=int, nargs="*",
                    default=[8, 32, 64, 128, 256, 512])
    args = ap.parse_args()
    dev = device_of(args.device)

    data = tg.transportation(args.sources, args.sinks, args.density, 1)
    A = matrix_of(data)
    m, n = A.shape
    print(f"# transportation m={m} n={n} nnz={A.nnz}")
    rng = np.random.default_rng(1)
    W = rng.uniform(0.5, 2.0, size=n + m)

    native_rate = native_matvec_rate(data)
    print(f"# host native single-vector: {native_rate:.1f} matvec/s")

    AIc = sp.hstack([A, sp.eye(m)], format="csc")
    AIr = AIc.tocsr()
    nmd = NormalMatrixDevice(A, dev, torch.float32)
    if dev.type == "cuda":
        form = kernels.normal_plan_of(nmd.op_At, nmd.op_A).fused
    else:
        form = kernels.k6_fused(nmd.op_At)
    form = "fused" if form else "two K5 launches"
    print(f"# device: {args.device}; K6's form at this A: {form}")
    print(f"{'B':>5} {'dev_ms':>9} {'dev_mv/s':>12} {'scipy_ms':>9} "
          f"{'scipy_mv/s':>11} {'dev/native':>10}")
    rows = []
    snap = snapshot()
    for B in args.batches:
        V = rng.standard_normal((m, B))
        Wb = torch.from_numpy(np.ascontiguousarray(np.broadcast_to(
            W[:, None], (n + m, B)))).to(torch.float32).to(dev)
        Vd = torch.from_numpy(V).to(torch.float32).to(dev)

        def loop():
            for _ in range(K):
                nmd.apply_batched(Wb, Vd)
        rate = best_rate(loop, K * B, dev)

        t0 = time.perf_counter()
        U = AIc.T @ V
        U *= W[:, None]
        AIr @ U
        scipy_dt = time.perf_counter() - t0
        dev_ms = B / rate * 1e3
        print(f"{B:5d} {dev_ms:9.3f} {rate:12.1f} {scipy_dt * 1e3:9.2f} "
              f"{B / scipy_dt:11.1f} {rate / native_rate:10.2f}")
        rows.append({"B": B, "device_ms": dev_ms,
                     "device_lane_applies_per_s": rate,
                     "scipy_ms": scipy_dt * 1e3,
                     "scipy_lane_applies_per_s": B / scipy_dt,
                     "device_vs_native": rate / native_rate})
    emit({"device": args.device, "m": int(m), "n": int(n), "nnz": A.nnz,
          "applies_per_timing": K, "k6_form": form,
          "native_matvec_per_s": native_rate, "rows": rows,
          "launches": launched(snap), **host_fields(dev)}, [])


if __name__ == "__main__":
    main()
