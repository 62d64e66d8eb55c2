"""The BLAS thread pools during a solve.

Three thread pools share the CPUs of a solve: libgomp's (torch's copy,
which the OpenMP regions of ipxlu.cc also use) and the OpenBLAS pools of
numpy and scipy, each one thread per CPU by default. The BLAS workers spin
for a while after each BLAS call (the IPM's objectives and norms, the
phase-2 CR's dots), and an OpenMP region waits for its slowest thread, so a
region of several threads loses whenever a spinning BLAS worker holds a CPU
it needs. On an NVIDIA H100 host with 8 CPUs, the 20k transportation LP
took 8.2-8.5 s on "cuda" and 4.5-5.0 s on "cpu" with the pools one thread
per CPU, and 1.46-1.61 s and 1.31-1.45 s with them on one thread in the
solve (tools/torch_profile.py --what threads; PERF.md §5).

The rule (blas_threads): unless the user set the pools' size
(OPENBLAS_NUM_THREADS, GOTO_NUM_THREADS or OMP_NUM_THREADS, which OpenBLAS
reads when it loads), LpSolver.solve runs every OpenBLAS pool loaded in the
process on one thread (quiet_blas) and gives each its own count back after
the solve. The native regions keep OpenMP's own team, every CPU of the
affinity mask.
"""
from __future__ import annotations

import ctypes
import os
from contextlib import contextmanager
from functools import lru_cache
from typing import Mapping, Optional

# what OpenBLAS reads for its pool's size when it loads
USER_VARS = ("OPENBLAS_NUM_THREADS", "GOTO_NUM_THREADS", "OMP_NUM_THREADS")
# the symbol prefixes of OpenBLAS builds: plain, and numpy's and scipy's
# wheels (scipy_openblas, 64-bit integers with the 64_ suffix)
_PREFIXES = ("openblas", "scipy_openblas")


def blas_threads(env: Mapping[str, str]) -> Optional[int]:
    """Threads of the BLAS pools during a solve under the environment
    `env`: None (leave the pools as they are) when the user set their size,
    else 1."""
    return None if any(env.get(k) for k in USER_VARS) else 1


@lru_cache(maxsize=None)
def blas_pools() -> tuple:
    """(get, set) of the thread count of each OpenBLAS library mapped into
    this process, as ctypes functions; none where /proc/self/maps is not
    there. Found once, at the first solve: the port has imported numpy and
    scipy by then."""
    try:
        with open("/proc/self/maps") as f:
            paths = sorted({line.split()[-1] for line in f
                            if "openblas" in line.rsplit("/", 1)[-1].lower()})
    except OSError:
        return ()
    pools = []
    for path in paths:
        try:
            lib = ctypes.CDLL(path, mode=os.RTLD_NOLOAD | os.RTLD_LAZY)
        except OSError:
            continue
        for prefix in _PREFIXES:
            for suffix in ("", "64_"):
                get = getattr(lib, f"{prefix}_get_num_threads{suffix}", None)
                put = getattr(lib, f"{prefix}_set_num_threads{suffix}", None)
                if get is not None and put is not None:
                    get.restype, get.argtypes = ctypes.c_int, []
                    put.restype, put.argtypes = None, [ctypes.c_int]
                    pools.append((get, put))
    return tuple(pools)


@contextmanager
def quiet_blas():
    """The OpenBLAS pools at blas_threads(os.environ) threads inside the
    block (unchanged when that is None), their own counts after it."""
    k = blas_threads(os.environ)
    pools = blas_pools() if k is not None else ()
    saved = [get() for get, _ in pools]
    for _, put in pools:
        put(k)
    try:
        yield
    finally:
        for (_, put), n in zip(pools, saved):
            put(n)
