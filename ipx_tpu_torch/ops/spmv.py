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
  V.CV: one fused launch that never writes W_s * (A' V) where A's columns
  are short (kernels.NormalBatchedPlan), else two launches of K5 with
  epilogues. Replaces ``NormalMatrixDevice.apply_batched`` /
  ``normal_apply_batched_tree``.

All four are memory-bound on the H100: K1 and K2 move about 12-16 bytes of
index and value per nonzero plus a gather of x that stays in L2, K5 and K6
gather one row of B values per nonzero; csrc/spmv.cu and csrc/spmm.cu say
what the designs do about it. A wrapper takes the plain version only for a
tensor on the CPU; for a CUDA tensor it launches the kernel or raises.

A CsrOperand built with column `bounds` is the split layout of K4 and K14v
(csrc/nnt.cu): each row's entries cut into the blocks' segments, the
blocks' sums added in block order. ``split_spmv`` is K14v's wrapper and
``split_spmv_plain`` the plain version of both kernels' split sums.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from .. import kernels

NP_DTYPE = {torch.float64: np.float64, torch.float32: np.float32}


def lanes_per_row(indptr: np.ndarray) -> int:
    """Lanes that sum one row in K2, K4 and K14v (an operand's `vec`): the
    power of two at or above the mean row length, within [2, 32]. K1's
    plans take the one at or below it (kernels.k1_lanes)."""
    rows = len(indptr) - 1
    mean = (indptr[-1] - indptr[0]) / rows if rows else 0.0
    vec = 2
    while vec < 32 and vec < mean:
        vec *= 2
    return vec


class CsrOperand:
    """One CSR matrix on a device: indptr (int64), indices (int32) and vals
    (float64 or float32), plus the row id of every nonzero for the plain
    version.

    With `bounds`, the split layout of K4 and K14v: the columns cut into P
    contiguous blocks at the offsets bounds[0] = 0 <= ... <= bounds[P] =
    num_cols (an int64 vector on the host), each row's entries of block p
    being those with a column in [bounds[p], bounds[p + 1]); the column
    indices of each row must then be sorted, so that a block's entries are
    one segment of the row. Without, P = 1. `slots` is each nonzero's place
    in the (P, rows) per-segment sums of the plain version. `sq_rows` is
    the sum of the squared row lengths, which K6's plan reads on A' (the
    gathers of its fused form)."""

    def __init__(self, indptr, indices, data, num_cols: int,
                 device: torch.device, dtype: torch.dtype, bounds=None):
        indptr = np.asarray(indptr, dtype=np.int64)
        indices = np.ascontiguousarray(indices, dtype=np.int32)
        self.rows = len(indptr) - 1
        self.cols = int(num_cols)
        self.vec = lanes_per_row(indptr)
        self.sq_rows = int(np.sum(np.diff(indptr) ** 2))
        self.indptr = torch.from_numpy(indptr).to(device)
        self.indices = torch.from_numpy(indices).to(device)
        self.vals = torch.from_numpy(
            np.ascontiguousarray(data, dtype=NP_DTYPE[dtype])).to(device)
        rows = np.repeat(np.arange(self.rows, dtype=np.int64),
                         np.diff(indptr))
        self.row_ids = torch.from_numpy(rows).to(device)
        bounds = np.array([0, self.cols] if bounds is None else bounds,
                          dtype=np.int64)
        if (bounds.ndim != 1 or len(bounds) < 2 or bounds[0] != 0
                or bounds[-1] != self.cols or np.any(np.diff(bounds) < 0)):
            raise ValueError(f"bounds {bounds.tolist()} do not cut the "
                             f"{self.cols} columns into blocks")
        self.bounds, self.P = bounds, len(bounds) - 1
        # the interior bounds, which K4 and K14v read from the host
        self.inner = np.ascontiguousarray(bounds[1:-1])
        self.inner_ptr = self.inner.ctypes.data
        if self.P == 1:
            self.slots = self.row_ids
        else:
            seg = np.searchsorted(self.inner, indices, side="right")
            self.slots = torch.from_numpy(seg * self.rows + rows).to(device)


def csr_spmv_plain(op: CsrOperand, x: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: gather, multiply, scatter-add by row."""
    y = torch.zeros(op.rows, dtype=x.dtype, device=x.device)
    return y.index_add_(0, op.row_ids, op.vals * x.index_select(0, op.indices))


def csr_spmv(op: CsrOperand, x: torch.Tensor) -> torch.Tensor:
    """K1: y = op @ x."""
    if x.device.type == "cpu":
        return csr_spmv_plain(op, x)
    return kernels.csr_spmv(op, x)


def split_spmv_plain(op: CsrOperand, x: torch.Tensor,
                     scale=None) -> torch.Tensor:
    """Plain version of the split sums of K4 and K14v: each row's sum over
    each block's segment, then those P sums added in block order, times
    `scale` if given."""
    parts = torch.zeros(op.P * op.rows, dtype=x.dtype, device=x.device)
    parts.index_add_(0, op.slots, op.vals * x.index_select(0, op.indices))
    parts = parts.view(op.P, op.rows)
    y = parts[0]
    for p in range(1, op.P):
        y = y + parts[p]
    return y * scale if scale is not None else y


def split_spmv(op: CsrOperand, x: torch.Tensor, scale=None) -> torch.Tensor:
    """K14v: scale * (((s_0 + s_1) + ...) + s_{P-1}) per row of `op`, s_p
    the row's sum over block p's segment (float64)."""
    if x.device.type == "cpu":
        return split_spmv_plain(op, x, scale)
    return kernels.block_spmv_sum(op, x, scale)


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
        on the model (Model.clear drops them). An entry is tied to the
        matrix object it was built from, for a caller that sets model.A
        itself."""
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
