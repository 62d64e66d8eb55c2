"""Sparse matrix-vector products on a torch device (port of ipx_tpu/ops/spmv.py).

Four kernels live behind the wrappers here, each with its plain PyTorch
version beside it:

* K1 ``csr_spmv``: y = A x over CSR rows (csrc/spmv.cu). Replaces
  ``ipx_tpu/ops/spmv.py:apply_csr`` (gather, lane-major cumsum, boundary
  difference) and ``apply_csr_tree``. It serves A (CSR) and A' (the CSC of
  A read as the CSR of A').
* K2 ``normal_apply``: C v = A (W_s * (A' v)) + W_slack * v together with
  v.Cv (two launches of K1 with epilogues). Replaces
  ``NormalMatrixDevice.apply`` / ``normal_apply_tree`` and the fused dot of
  ``ipx_tpu/ops/device_cr.py`` ``cr.C``.
* K5 ``csr_spmm``: Y = A U for a batch U of shape (cols, B), B contiguous
  (csrc/spmm.cu). Replaces ``apply_csr_batched`` / ``apply_csr_batched_tree``
  (a take of the rows of U and a sorted segment_sum) for A, A' and A.^2.
* K6 ``normal_apply_batched``: C V = A (W_s * (A' V)) + W_slack * V for V of
  shape (m, B) and per-lane weights W of shape (n+m, B), with the column dots
  V.CV (two launches of K5 with epilogues). Replaces
  ``NormalMatrixDevice.apply_batched`` / ``normal_apply_batched_tree``.

All four are memory-bound on the H100: K1 and K2 move about 12-16 bytes of
index and value per nonzero plus a gather of x that stays in L2, K5 and K6
gather one row of B values per nonzero; csrc/spmv.cu and csrc/spmm.cu say
what the designs do about it. A wrapper takes the plain version only for a
tensor on the CPU; for a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from .. import kernels

NP_DTYPE = {torch.float64: np.float64, torch.float32: np.float32}


def lanes_per_row(indptr: np.ndarray) -> int:
    """Lanes that sum one row in K1: the power of two at or above the mean
    row length, within [2, 32]."""
    rows = len(indptr) - 1
    mean = (indptr[-1] - indptr[0]) / rows if rows else 0.0
    vec = 2
    while vec < 32 and vec < mean:
        vec *= 2
    return vec


class CsrOperand:
    """One CSR matrix on a device: indptr (int64), indices (int32) and vals
    (float64 or float32), plus the row id of every nonzero for the plain
    version."""

    def __init__(self, indptr, indices, data, num_cols: int,
                 device: torch.device, dtype: torch.dtype):
        indptr = np.asarray(indptr, dtype=np.int64)
        self.rows = len(indptr) - 1
        self.cols = int(num_cols)
        self.vec = lanes_per_row(indptr)
        self.indptr = torch.from_numpy(indptr).to(device)
        self.indices = torch.from_numpy(
            np.ascontiguousarray(indices, dtype=np.int32)).to(device)
        self.vals = torch.from_numpy(
            np.ascontiguousarray(data, dtype=NP_DTYPE[dtype])).to(device)
        self.row_ids = torch.from_numpy(np.repeat(
            np.arange(self.rows, dtype=np.int64), np.diff(indptr))).to(device)


def csr_spmv_plain(op: CsrOperand, x: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: gather, multiply, scatter-add by row."""
    y = torch.zeros(op.rows, dtype=x.dtype, device=x.device)
    return y.index_add_(0, op.row_ids, op.vals * x.index_select(0, op.indices))


def csr_spmv(op: CsrOperand, x: torch.Tensor) -> torch.Tensor:
    """K1: y = op @ x."""
    if x.device.type == "cpu":
        return csr_spmv_plain(op, x)
    return kernels.csr_spmv(op, x)


class NormalMatrixDevice:
    """A and A' on one device, for C v = A (W_s * (A' v)) + W_slack * v."""

    def __init__(self, A_csc: sp.csc_matrix, device: torch.device,
                 dtype: torch.dtype = torch.float64):
        A_csc = sp.csc_matrix(A_csc)
        A_csc.sort_indices()
        A_csr = A_csc.tocsr()
        A_csr.sort_indices()
        self.m, self.n = A_csc.shape
        self.op_A = CsrOperand(A_csr.indptr, A_csr.indices, A_csr.data,
                               self.n, device, dtype)
        # the CSC arrays of A are the CSR arrays of A'
        self.op_At = CsrOperand(A_csc.indptr, A_csc.indices, A_csc.data,
                                self.m, device, dtype)

    @classmethod
    def from_model(cls, model, device: torch.device,
                   dtype: torch.dtype = torch.float64) -> "NormalMatrixDevice":
        """The operands of `model.A`, built once per (device, dtype) and kept
        on the model. An entry is tied to the matrix object it was built
        from: Model.clear() leaves unknown attributes in place, and a solver
        that loads another LP presolves it into a new matrix."""
        cache = model.__dict__.setdefault("_torch_normal", {})
        key = (str(device), dtype)
        entry = cache.get(key)
        if entry is None or entry[0] is not model.A:
            entry = cache[key] = (model.A, cls(model.A, device, dtype))
        return entry[1]

    def apply(self, W: torch.Tensor, v: torch.Tensor):
        """(C v, v.Cv) with W of length n+m; the dot is a 0-d tensor. The
        counterpart of ipx_tpu's NormalMatrixDevice.apply for the parity
        tests; the CR loop calls kernels.normal_apply directly."""
        return normal_apply(self, W, v)

    def apply_batched(self, W: torch.Tensor, V: torch.Tensor):
        """(C V, column dots V.CV) for V of shape (m, B) and W of shape
        (n+m, B): K6, the counterpart of ipx_tpu's apply_batched."""
        return normal_apply_batched(self, W, V)

    def apply_batched_struct(self, U: torch.Tensor) -> torch.Tensor:
        """A U for U of shape (n, B): K5."""
        return csr_spmm(self.op_A, U)

    def applyT_batched_struct(self, V: torch.Tensor) -> torch.Tensor:
        """A' V for V of shape (m, B): K5."""
        return csr_spmm(self.op_At, V)


def normal_apply_plain(nmd: NormalMatrixDevice, W: torch.Tensor,
                       v: torch.Tensor):
    """Plain version of K2."""
    n = nmd.n
    u = csr_spmv_plain(nmd.op_At, v) * W[:n]
    out = csr_spmv_plain(nmd.op_A, u) + W[n:] * v
    return out, torch.dot(v, out)


def normal_apply(nmd: NormalMatrixDevice, W: torch.Tensor, v: torch.Tensor):
    """K2: (C v, v.Cv). Used by the tests and chip_smoke.py; the CR loop
    keeps v.Cv as block partials that its next pass sums."""
    if v.device.type == "cpu":
        return normal_apply_plain(nmd, W, v)
    dot = torch.empty(1, dtype=v.dtype, device=v.device)
    out = kernels.normal_apply(nmd.op_At, nmd.op_A, W, v, dot=dot)
    return out, dot[0]


def csr_spmm_plain(op: CsrOperand, U: torch.Tensor) -> torch.Tensor:
    """Plain version of K5: gather rows of U, scale, scatter-add by row."""
    Y = torch.zeros((op.rows, U.shape[1]), dtype=U.dtype, device=U.device)
    return Y.index_add_(0, op.row_ids,
                        op.vals[:, None] * U.index_select(0, op.indices))


def csr_spmm(op: CsrOperand, U: torch.Tensor) -> torch.Tensor:
    """K5: Y = op @ U for U of shape (op.cols, B)."""
    if U.device.type == "cpu":
        return csr_spmm_plain(op, U)
    return kernels.csr_spmm(op, U)


def normal_apply_batched_plain(nmd: NormalMatrixDevice, W: torch.Tensor,
                               V: torch.Tensor):
    """Plain version of K6."""
    n = nmd.n
    U = csr_spmm_plain(nmd.op_At, V) * W[:n]
    out = csr_spmm_plain(nmd.op_A, U) + W[n:] * V
    return out, torch.sum(V * out, dim=0)


def normal_apply_batched(nmd: NormalMatrixDevice, W: torch.Tensor,
                         V: torch.Tensor):
    """K6: (C V, column dots V.CV). The batched CR on the card launches
    kernels.normal_apply_batched itself and keeps the dots as partials."""
    if V.device.type == "cpu":
        return normal_apply_batched_plain(nmd, W, V)
    dots = torch.empty(V.shape[1], dtype=V.dtype, device=V.device)
    out = kernels.normal_apply_batched(nmd.op_At, nmd.op_A, W, V, dots=dots)
    return out, dots
