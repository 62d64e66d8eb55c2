"""Where the KKT solves run: resolves ``Parameters.device`` to a torch device.

There is no silent fallback. ``"cuda"``, the default of
``Parameters.device``, raises when there is no card or when the kernel
library does not build or load; ``"torch_cpu"`` runs the
same device path on the CPU with the kernels' plain PyTorch versions;
``"cpu"`` is the reference's host path. ``"auto"`` picks ``"cuda"`` when a
card is present and A has at least MIN_NNZ_AUTO nonzeros, and the host path
otherwise (the contract of ipx_tpu's DeviceNormalCR.worthwhile). The
batched and the sharded solves, which have no host path, resolve with
their own rules (resolve_batched, resolve_sharded), and over a mesh of
processes by resolve_mesh's.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import kernels

# Minimum problem size for the device path to pay off in auto mode: the
# reference's value, not a measurement on a card. At the one size measured so
# far, the 20k-row transportation LP (nnz 192 004), the device path takes
# about the host path's time once a solve quiets the BLAS pools
# (native/threads.py; PERF.md, "Where the time goes"); a sweep of sizes
# would set this value.
MIN_NNZ_AUTO = 20_000

DEVICES = ("auto", "cuda", "torch_cpu", "cpu")


def cuda_device() -> torch.device:
    """The card, with the kernel library built and loaded; raises if either
    is missing."""
    if not torch.cuda.is_available():
        raise RuntimeError('device="cuda" but torch.cuda.is_available() is '
                           'False')
    kernels.load()
    return torch.device("cuda", torch.cuda.current_device())


def require(device: str) -> None:
    """Raises unless `device` is one of DEVICES and, for "cuda", the card
    and the kernel library are there: LpSolver.solve checks this before any
    work and ends at INTERNAL_ERROR when it raises, so a solve that asked
    for the card never runs on the host."""
    if device not in DEVICES:
        raise ValueError(f"unknown device {device!r}; expected one of "
                         f"{DEVICES}")
    if device == "cuda":
        cuda_device()


def resolve(device: str, model=None) -> Optional[torch.device]:
    """The torch device of the device path, or None for the host path.
    `model` is needed only for "auto"."""
    if device == "cuda":
        return cuda_device()
    if device == "torch_cpu":
        return torch.device("cpu")
    if device == "cpu":
        return None
    if device == "auto":
        nnz = model.A.nnz if model is not None and model.A is not None else 0
        if torch.cuda.is_available() and nnz >= MIN_NNZ_AUTO:
            return cuda_device()
        return None
    raise ValueError(f"unknown device {device!r}; expected one of {DEVICES}")


def resolve_batched(device: str) -> torch.device:
    """The torch device of the batched phase 1 (parallel/batch.py), which has
    no host path of its own: "cuda" is the card or raises, "torch_cpu" and
    "cpu" are the plain versions on the CPU, and "auto" is the card when one
    is present (the reference runs where jax's accelerator is)."""
    if device == "auto":
        device = "cuda" if torch.cuda.is_available() else "cpu"
    if device == "cuda":
        return cuda_device()
    if device in ("torch_cpu", "cpu"):
        return torch.device("cpu")
    raise ValueError(f"unknown device {device!r}; expected one of {DEVICES}")


def resolve_sharded(device: str) -> torch.device:
    """The torch device of the row blocks of the sharded solves
    (Parameters.shards > 1, parallel/sharding.py), which have no host path
    of their own: "cuda" is the card or raises, "torch_cpu" the CPU with
    the plain versions, and "auto" and "cpu" the card when one is present,
    else the CPU (the reference's mesh is jax's default platform, whatever
    Parameters.device says)."""
    if device in ("auto", "cpu"):
        device = "cuda" if torch.cuda.is_available() else "torch_cpu"
    if device == "cuda":
        return cuda_device()
    if device == "torch_cpu":
        return torch.device("cpu")
    raise ValueError(f"unknown device {device!r}; expected one of {DEVICES}")


def resolve_mesh(device: str, shards: int):
    """The mesh of processes (parallel/mesh.py) that takes both phases'
    blocks of a solve with Parameters.shards = shards, or None for the
    blocks on one device (resolve_sharded): the active mesh (`with mesh:`)
    when its rows axis has `shards` ranks; its ranks must be where
    resolve_sharded(device) is (the card or the CPU), else this raises. A
    mesh is only ever the caller's: without an active one the blocks stay on
    one device, however many cards there are."""
    from .parallel import mesh as _mesh
    active = _mesh.active_mesh()
    if active is None or active.axis_size("rows") != shards:
        return None
    where = resolve_sharded(device)
    if active.device.type != where.type:
        raise ValueError(f"Parameters.device {device!r} puts the blocks on "
                         f"{where.type}, the active mesh is on "
                         f"{active.devices}")
    return active


def sharded_place(device: str, shards: int) -> tuple:
    """(mesh, device, key) of a solve's sharded blocks: resolve_mesh's mesh
    or None, the device the blocks are on, and the key under which the
    model keeps its sharded solvers (kkt/diag.py, kkt/basis_precond.py)."""
    mesh = resolve_mesh(device, shards)
    where = resolve_sharded(device) if mesh is None else mesh.device
    key = (shards, str(where) if mesh is None else f"mesh {mesh.uid}")
    return mesh, where, key
