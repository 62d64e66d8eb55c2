"""Builds the port's two native libraries at first use, into
``ipx_tpu_torch/_build/``, never next to their sources:

* ``libipxt_kernels.so`` (build): the CUDA kernels of ``csrc/``, with nvcc
  for sm_90a. It has a plain C interface and is bound with ctypes
  (kernels.py), so no PyTorch header is compiled and a build takes seconds;
* ``libipxlu.so`` (build_native): the host LU and vector kernels of
  ``native/ipxlu.cc``, with g++, as ipx_tpu/native/build.py builds its own.

A library is rebuilt when one of its sources is newer than it. Processes
that build at once (test workers) take turns on the library's lock file;
each build writes a temporary file and renames it into place, so a loader
sees the old library or the new one. Run
``python ipx_tpu_torch/build.py [--native] [--force]`` to build by hand.
"""
from __future__ import annotations

import fcntl
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
NATIVE_SRC = os.path.join(_DIR, "native", "ipxlu.cc")
NATIVE_LIB = os.path.join(BUILD_DIR, "libipxlu.so")
# sm_90a: the Hopper target with its architecture-specific instructions
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _fresh(lib: str, deps: list) -> bool:
    return (os.path.exists(lib)
            and os.path.getmtime(lib) >= max(map(os.path.getmtime, deps)))


def _build(lib: str, deps: list, compile_to, force: bool) -> str:
    """Runs compile_to(tmp) under lib's lock unless lib is newer than every
    file of `deps`, then renames tmp to lib; returns lib or raises."""
    if not force and _fresh(lib, deps):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(lib + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not force and _fresh(lib, deps):    # built while this one waited
            return lib
        tmp = f"{lib}.{os.getpid()}.tmp"
        compile_to(tmp)
        os.replace(tmp, lib)     # atomic: a concurrent loader sees old or new
    return lib


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


def _nvcc_to(tmp: str) -> None:
    """Each source compiled by its own nvcc, all started together, and the
    objects then linked into tmp."""
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    jobs = []
    for src in sources():
        obj = os.path.join(BUILD_DIR, os.path.basename(src) + f".{tag}.o")
        cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-c", "-Xcompiler",
               "-fPIC", "-Xptxas", "-v", "-o", obj, src]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
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


def _gxx_to(tmp: str) -> None:
    base = ["g++", "-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
            "-o", tmp, NATIVE_SRC]
    try:
        try:
            subprocess.run(base[:1] + ["-fopenmp"] + base[1:], check=True,
                           capture_output=True, text=True)
        except subprocess.CalledProcessError:
            # toolchains without libgomp: serial build
            subprocess.run(base, check=True, capture_output=True, text=True)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"ipxlu native build failed:\n{e.stderr}") from e
    except FileNotFoundError as e:
        raise RuntimeError("g++ not found; native LU unavailable") from e


def build(force: bool = False) -> str:
    """Compiles the CUDA kernel library if needed; returns its path or
    raises."""
    deps = sources() + glob.glob(os.path.join(CSRC, "*.cuh"))
    return _build(LIB, deps, _nvcc_to, force)


def build_native(force: bool = False) -> str:
    """Compiles libipxlu.so if needed; returns its path or raises."""
    return _build(NATIVE_LIB, [NATIVE_SRC], _gxx_to, force)


if __name__ == "__main__":
    target = build_native if "--native" in sys.argv else build
    print(target(force="--force" in sys.argv))
