"""Indexed (hypersparse) vector: dense values plus optional nonzero pattern.

Counterpart of the reference indexed vector (reference:
src/indexed_vector.{h,cc}): consumers iterate the pattern when the vector is
"sparse" (nnz <= 0.1 * dim, reference: src/ipx_internal.h:19-21) and the full
array otherwise. Here the dense storage is a numpy array so dense consumers
get vectorized ops for free.

The port's copy of ipx_tpu/basis/indexed_vector.py.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

HYPERSPARSE_THRESHOLD = 0.1


class IndexedVector:
    __slots__ = ("values", "pattern", "_patbuf")

    def __init__(self, dim: int):
        self.values = np.zeros(dim)
        self.pattern: Optional[np.ndarray] = None   # None = dense

    @property
    def dim(self) -> int:
        return self.values.shape[0]

    def sparse(self) -> bool:
        return self.pattern is not None

    def nnz(self) -> int:
        if self.pattern is not None:
            return int(self.pattern.size)
        return int(np.count_nonzero(self.values))

    def set_dense(self, values: np.ndarray) -> None:
        self.values = values
        self.pattern = None

    def set_sparse(self, values: np.ndarray, pattern: np.ndarray) -> None:
        """Takes a full-length value array with nonzeros at `pattern`."""
        self.values = values
        if pattern.size <= HYPERSPARSE_THRESHOLD * values.shape[0]:
            self.pattern = pattern
        else:
            self.pattern = None

    def clear(self) -> None:
        if self.pattern is not None and self.pattern.size:
            self.values[self.pattern] = 0.0
        else:
            self.values[:] = 0.0
        self.pattern = np.empty(0, dtype=np.int64)

    def nonzero_indices(self) -> np.ndarray:
        if self.pattern is not None:
            return self.pattern
        return np.nonzero(self.values)[0]
