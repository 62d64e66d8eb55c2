"""Level-scheduled sparse triangular solves on ipx_tpu_torch, the
counterpart of tools/device_trisolve_proto.py.

    python tools/torch_trisolve_proto.py [cuda|torch_cpu] [src snk dens]

(defaults: cuda 8000 12000 0.001). It solves transportation(src, snk, dens,
seed=1) through ipx_tpu_torch.LpSolver(device="cpu", crossover=0), builds B
from the final basis, factors it with scipy's splu (COLAMD), computes the
level schedules of L (forward) and U (backward) (ops/trisolve.py) and runs
each sweep through K17 level_solve (csrc/trisolve.cu) on "cuda", or through
its plain version on "torch_cpu", for B = 1, 256 and 1024 right-hand
sides. As in the reference tool, no row or column permutation is applied:
the sweeps solve with L and U, not with B. It checks the L sweep against
scipy's spsolve_triangular and prints one JSON line with the reference
tool's keys (times per call in ms, from the host clock around work that
ends in a synchronize; compile_B*_s is the first call's time), and:

  library_*        torch.triangular_solve(V, T.to_sparse_csr(), upper)
                   on the same inputs, the yardstick (cuSPARSE on the
                   card); the port never calls it. If the installed build
                   refuses it, library_error holds the message;
  event_*, device_*  (cuda) the median CUDA-event time of one full solve,
                   and its device time per call from torch.profiler;
  bound_full_solve_B*_ms  the least time of a full solve on the card: the
                   bytes of both schedules (12 per entry, 20 per row) plus
                   V read and X written per sweep, over 3.35 TB/s;
  launches_full_solve     the K17 launches of one full solve: 2, one a
                   sweep (the L sweep, then the U sweep), each walking all
                   of its levels inside its one launch;
  OMP_NUM_THREADS  beside the host baselines, which the OpenMP
                   spin-waiting of the port's process slows (PERF.md §5).

OpenMP reads its environment at start-up, so run the tool once per
setting, as tools/torch_profile.py is run:

    python tools/torch_trisolve_proto.py cuda
    env OMP_NUM_THREADS=4 python tools/torch_trisolve_proto.py cuda
"""
import json
import os
import statistics
import sys
import time

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from ipx_tpu_torch import (LpSolver, Parameters, backend,  # noqa: E402
                           kernels)
from ipx_tpu_torch.ops.trisolve import (basis_factors,  # noqa: E402
                                        level_schedule, level_solve)
from ipx_tpu_torch.testgen import (load_into_solver,  # noqa: E402
                                   transportation)
from torch_profile import _device_us, card_name  # noqa: E402

HBM_BYTES_PER_S = 3.35e12     # NVIDIA's H100 SXM data sheet


def factors(src, snk, dens):
    """(basis, L, U) of transportation(src, snk, dens, 1) solved on the
    host path without crossover, L and U from splu of its final B."""
    s = LpSolver(Parameters(display=0, device="cpu", crossover=0))
    load_into_solver(transportation(src, snk, dens, 1), s)
    if s.solve() != 1000:
        raise RuntimeError("the LP solve did not reach status 1000")
    return (s.basis, *basis_factors(s.basis))


def schedule_bytes(sched) -> int:
    return sum(t.numel() * t.element_size() for t in (
        sched.rows, sched.entry_ptr, sched.cols, sched.vals, sched.inv_diag))


def main():
    which = sys.argv[1] if len(sys.argv) > 1 else "cuda"
    src = int(sys.argv[2]) if len(sys.argv) > 2 else 8000
    snk = int(sys.argv[3]) if len(sys.argv) > 3 else 12000
    dens = float(sys.argv[4]) if len(sys.argv) > 4 else 0.001
    if which == "cuda":
        dev = backend.cuda_device()       # the card, or raise
        card = card_name()
        sync = torch.cuda.synchronize
    elif which == "torch_cpu":
        dev, card = torch.device("cpu"), "cpu"
        sync = lambda: None               # noqa: E731
    else:
        raise SystemExit(f"backend must be cuda or torch_cpu, got {which!r}")

    basis, L, U = factors(src, snk, dens)
    m = L.shape[0]
    sL = level_schedule(L, True, dev)
    sU = level_schedule(U, False, dev)
    # the yardstick only: where the installed build refuses it, the line
    # says why
    lib_error = None
    try:
        L_lib, U_lib = _sparse(L, dev), _sparse(U, dev)
    except Exception as e:
        lib_error = f"{type(e).__name__}: {e}"

    def full(V):
        return level_solve(sU, level_solve(sL, V))

    rng = np.random.default_rng(0)
    out = {"backend": which, "m": m, "levels_L": sL.nlev,
           "levels_U": sU.nlev, "Rmax": sL.Rmax, "Emax": sL.Emax,
           "nnzL": int(L.nnz), "nnzU": int(U.nnz), "card": card}
    for Bw in (1, 256, 1024):
        V = torch.from_numpy(rng.standard_normal((m, Bw))).to(dev)
        t0 = time.perf_counter()
        X = level_solve(sL, V)
        sync()
        out[f"compile_B{Bw}_s"] = round(time.perf_counter() - t0, 4)
        k = min(Bw, 8)
        ref = spla.spsolve_triangular(L, V[:, :k].cpu().numpy(), lower=True)
        err = float(np.max(np.abs(X[:, :k].cpu().numpy() - ref))
                    / max(1.0, np.abs(ref).max()))
        out[f"relerr_B{Bw}"] = float(f"{err:.2e}")
        reps = 50 if Bw == 1 else 20
        out[f"lvl_solveL_B{Bw}_ms"] = wall_ms(lambda: level_solve(sL, V),
                                              reps, sync)
        full(V)
        sync()
        before = kernels.LAUNCHES["level_solve"]
        out[f"full_solve_B{Bw}_ms"] = wall_ms(lambda: full(V), reps, sync)
        out["launches_full_solve"] = (kernels.LAUNCHES["level_solve"]
                                      - before) // reps
        nbytes = (schedule_bytes(sL) + schedule_bytes(sU)
                  + 2 * 2 * m * Bw * 8)
        out[f"bound_full_solve_B{Bw}_ms"] = 1e3 * nbytes / HBM_BYTES_PER_S
        if which == "cuda":
            out[f"event_full_solve_B{Bw}_ms"] = event_ms(lambda: full(V),
                                                         reps)
            out[f"device_full_solve_B{Bw}_ms"] = device_ms(lambda: full(V),
                                                           reps)
        if lib_error is None:
            def lib_L(V=V):
                return torch.triangular_solve(V, L_lib, upper=False)[0]

            def lib_full(V=V):
                return torch.triangular_solve(lib_L(V), U_lib, upper=True)[0]
            try:
                XL = lib_L()
                sync()
                out[f"library_relerr_B{Bw}"] = float(
                    f"{float((XL - X).abs().max() / X.abs().max()):.2e}")
                out[f"library_solveL_B{Bw}_ms"] = wall_ms(lib_L, reps, sync)
                out[f"library_full_solve_B{Bw}_ms"] = wall_ms(lib_full, reps,
                                                              sync)
            except Exception as e:
                lib_error = f"{type(e).__name__}: {e}"
        del V, X
    if lib_error is not None:
        out["library_error"] = lib_error

    # host baselines: the port's native paths
    out["OMP_NUM_THREADS"] = os.environ.get("OMP_NUM_THREADS", "-")
    b1 = rng.standard_normal(m)
    t0 = time.perf_counter()
    for _ in range(50):
        basis.solve_dense(b1, "N")
    out["host_native_solve_ms"] = round((time.perf_counter() - t0) / 50
                                        * 1000, 4)
    for Bw in (256, 1024):
        V = np.ascontiguousarray(rng.standard_normal((m, Bw)))
        t0 = time.perf_counter()
        for _ in range(5):
            basis.lu.solve_dense_block(V, False)
        out[f"host_blocked_solve{Bw}_ms"] = round(
            (time.perf_counter() - t0) / 5 * 1000, 4)
    print(json.dumps(out), flush=True)


def _sparse(T, dev):
    """T as a torch sparse CSR tensor on `dev`, for the library yardstick."""
    T = sp.csr_matrix(T)
    return torch.sparse_csr_tensor(
        torch.from_numpy(T.indptr.astype(np.int64)),
        torch.from_numpy(T.indices.astype(np.int64)),
        torch.from_numpy(T.data), size=T.shape).to(dev)


def wall_ms(fn, reps, sync) -> float:
    """Milliseconds per call of fn() on the host clock, ending in sync()."""
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return round((time.perf_counter() - t0) / reps * 1000, 4)


def event_ms(fn, reps) -> float:
    """Median milliseconds of one fn() between two CUDA events."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return round(statistics.median(times), 4)


def device_ms(fn, reps) -> float:
    """Device time per call of fn() from torch.profiler: the self time of
    its CUDA kernels over `reps` calls."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return round(_device_us(prof)[0] / reps / 1e3, 4)


if __name__ == "__main__":
    main()
