"""Where the KKT solves run: resolves ``Parameters.device`` to a torch device.

There is no silent fallback. ``"cuda"`` raises when there is no card or
when the kernel library does not build or load; ``"torch_cpu"`` runs the
same device path on the CPU with the kernels' plain PyTorch versions;
``"cpu"`` is the reference's host path. ``"auto"`` picks ``"cuda"`` when a
card is present and A has at least MIN_NNZ_AUTO nonzeros, and the host path
otherwise (the contract of ipx_tpu's DeviceNormalCR.worthwhile).
"""
from __future__ import annotations

from typing import Optional

import torch

from . import kernels

# Minimum problem size for the device path to pay off in auto mode: the
# reference's value, not a measurement on a card. At the one size measured so
# far, the 20k-row transportation LP (nnz 192 004), the device path was
# slower end to end than the host path in the default OpenMP setting
# (PERF.md, "Where the time goes").
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
