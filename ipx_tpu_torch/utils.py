"""Small dense helpers (reference: src/utils.{h,cc}).

The port's copy of ipx_tpu/utils.py.
"""
from __future__ import annotations

import numpy as np


def onenorm(x: np.ndarray) -> float:
    return float(np.sum(np.abs(x))) if x.size else 0.0


def infnorm(x: np.ndarray) -> float:
    return float(np.max(np.abs(x))) if x.size else 0.0


def multirange_indices(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Concatenation of [starts[k], starts[k]+lens[k]) ranges without a
    Python loop (the classic cumsum trick)."""
    total = int(lens.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    steps = np.ones(total, dtype=np.int64)
    startpos = np.zeros(len(lens), dtype=np.int64)
    startpos[1:] = np.cumsum(lens[:-1])
    nz = lens > 0
    firsts = startpos[nz]
    svals = starts[nz]
    steps[firsts] = svals
    steps[firsts[1:]] -= (svals + lens[nz] - 1)[:-1]
    return np.cumsum(steps)


def sortperm(values: np.ndarray, reverse: bool = False) -> np.ndarray:
    """Stable argsort (reference: src/utils.h Sortperm); used for crossover
    push order and crash-basis weight order."""
    v = np.asarray(values)
    if reverse:
        # stable decreasing order: negate sort keys of the stable increasing
        # argsort of the reversed array trick; simplest correct stable form:
        idx = np.argsort(-v, kind="stable")
        return idx
    return np.argsort(v, kind="stable")
