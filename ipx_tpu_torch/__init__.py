"""ipx_tpu_torch — the interior-point LP solver of ipx_tpu on PyTorch and CUDA.

The port of ``ipx_tpu`` to one NVIDIA H100. It keeps its own copy of the
host pipeline (presolve, IPM, iterate, LU, maxvolume, crossover,
checkpoints and the native C++ library in native/), each module naming the
ipx_tpu file it follows, and replaces the modules that ran on the TPU: the
phase-1 CR loop, the phase-2 N N' product, the batched scenario IPM and the
sharded solves run through hand-written CUDA kernels (csrc/) on the device
that ``Parameters.device`` names. It imports torch, and nothing of jax or
of ipx_tpu.
"""
import os as _os

# On small VMs the Linux scheduler can leave an OpenMP team timesharing ONE
# cpu (measured: 20x slowdown of every parallel region in the native
# kernels). Bind threads to distinct places unless the user set a policy.
# (The native library also sets this in a dlopen constructor; doing it here
# too covers the case where another extension initialized libgomp first.)
#
# Multi-process caveat (ADVICE r3): the setdefault is process-wide and
# affects every OpenMP runtime loaded into this process (numpy/MKL/...).
# When several solver processes share one machine (e.g. a multi-process
# batch driver), each spreads over the SAME places and can recreate the
# timesharing contention this targets — export distinct OMP_PLACES per
# worker in that configuration, or set OMP_PROC_BIND explicitly to
# override this default. Skipped when the user already pinned placement.
if not (_os.environ.get("OMP_PLACES") or _os.environ.get(
        "GOMP_CPU_AFFINITY")):
    _os.environ.setdefault("OMP_PROC_BIND", "spread")


def _tune_malloc() -> None:
    """Keep large allocations on the heap instead of per-allocation mmaps.

    The solver's hot path creates O(n+m)-sized temporaries every call;
    glibc serves those from mmap and returns them to the OS on free, so
    every reuse pays fresh page faults + kernel zeroing (measured 200-800ms
    per call of a ~25ms vector kernel at m=200k). Raising the mmap/trim
    thresholds makes the heap retain and reuse the pages."""
    try:
        import ctypes
        libc = ctypes.CDLL(None, use_errno=True)
        M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
        libc.mallopt(M_MMAP_THRESHOLD, 1 << 30)
        libc.mallopt(M_TRIM_THRESHOLD, 1 << 30)
    except Exception:
        pass


_tune_malloc()

from .info import Info  # noqa: E402
from .lp_solver import LpSolver  # noqa: E402
from .parameters import Parameters  # noqa: E402
from .status import (IPX_BASIC, IPX_NONBASIC, IPX_NONBASIC_LB,  # noqa: E402
                     IPX_NONBASIC_UB, IPX_SUPERBASIC, Errflag, SolveStatus,
                     Status)
from .user_model import BasicSolution, InteriorSolution  # noqa: E402
from .version import __version__  # noqa: E402

__all__ = [
    "LpSolver", "Parameters", "Info", "Status", "SolveStatus", "Errflag",
    "BasicSolution", "InteriorSolution", "__version__",
    "IPX_BASIC", "IPX_NONBASIC", "IPX_NONBASIC_LB", "IPX_NONBASIC_UB",
    "IPX_SUPERBASIC",
]
