"""Builds the port's CUDA kernel library with nvcc at first use.

The library goes to ``ipx_tpu_torch/_build/`` and is rebuilt when a source
under ``csrc/`` is newer than it. It has a plain C interface and is bound
with ctypes (kernels.py), so no PyTorch header is compiled and a build takes
seconds. Run ``python ipx_tpu_torch/build.py [--force]`` to build by hand.
"""
from __future__ import annotations

import glob
import os
import shutil
import subprocess
import sys

_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_DIR, "csrc")
BUILD_DIR = os.path.join(_DIR, "_build")
LIB = os.path.join(BUILD_DIR, "libipxt_kernels.so")
LOG = os.path.join(BUILD_DIR, "build.log")
# sm_90a: the Hopper target with its architecture-specific instructions
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME); the CUDA kernels "
                       "of ipx_tpu_torch cannot be built")


def is_stale() -> bool:
    if not os.path.exists(LIB):
        return True
    newest = max(os.path.getmtime(p)
                 for p in sources() + glob.glob(os.path.join(CSRC, "*.cuh")))
    return os.path.getmtime(LIB) < newest


def build(force: bool = False) -> str:
    """Compiles the library if needed; returns its path or raises. Each
    source is compiled by its own nvcc, all started together, and the
    objects are then linked into the library."""
    if not force and not is_stale():
        return LIB
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    jobs = []
    for src in sources():
        obj = os.path.join(BUILD_DIR, os.path.basename(src) + f".{tag}.o")
        cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-c", "-Xcompiler",
               "-fPIC", "-Xptxas", "-v", "-o", obj, src]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    tmp = f"{LIB}.{tag}"
    link = [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp,
            *(obj for _, obj, _ in jobs)]
    log, failed = [], []
    for cmd, _, proc in jobs:
        out, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} ({proc.returncode}):\n{out[-4000:]}")
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True)
        log.append(" ".join(link) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link ({proc.returncode}):\n"
                          f"{proc.stderr[-4000:]}")
    for _, obj, _ in jobs:
        if os.path.exists(obj):
            os.remove(obj)
    with open(LOG, "w") as f:
        f.write("\n".join(log))
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, LIB)     # atomic: a concurrent loader sees old or new
    return LIB


if __name__ == "__main__":
    print(build(force="--force" in sys.argv))
