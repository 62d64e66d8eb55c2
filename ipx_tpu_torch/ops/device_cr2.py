"""Phase-2 (basis-preconditioned) CR with the N N' product on a torch
device (port of ipx_tpu/ops/device_cr2.py).

The splitted-normal operator C = I + inv(B) N N' inv(B') is split between
host and device as in the reference: the CR recurrences and the B / B'
triangular solves, sequential and of data-dependent sparsity, run on the
host; the N N' product runs on the device, with one m-vector crossing each
way per CR iteration.

K4 ``nnt`` is that product, z = N (N' w) (csrc/nnt.cu): one C call per
apply through an NntPlan, built once per prepare(), which checks the
operands once and moves w and z through pinned host buffers. It replaces
``_apply_seg`` and ``DeviceSplittedCR._build.nnt`` of the reference, whose
fixed-capacity padding and segment ids existed so that jax compiled one
program for every factorization; here the operands are simply rebuilt at
each prepare(). The column-blocked N N' of parallel/sharding.py takes the
same plan with P > 1 blocks.
"""
from __future__ import annotations

from functools import partial
from time import monotonic, perf_counter

import numpy as np
import torch

from .. import kernels
from .spmv import CsrOperand, csr_spmv_plain

F64 = torch.float64


def nnt_plain(Nt: CsrOperand, N: CsrOperand, w: torch.Tensor) -> torch.Tensor:
    """Plain version of K4."""
    return csr_spmv_plain(N, csr_spmv_plain(Nt, w))


def nnt(Nt: CsrOperand, N: CsrOperand, w: torch.Tensor) -> torch.Tensor:
    """K4 once: z = N (N' w), with `Nt` the CSR operand of N' (a plan of
    one use; the solvers keep an NntPlan)."""
    if w.device.type == "cpu":
        return nnt_plain(Nt, N, w)
    return kernels.NntKernel(Nt, N).launch(w)


class NntPlan:
    """K4 for one operand: z = sum_{p<P} N_p (N_p' w) in block order, `Nt`
    the CSR operand of N', `N` that of N split at the P - 1 column bounds
    (ops/spmv.py), float64. On the card a kernels.NntKernel and pinned host
    buffers for w and z: apply(w) is one copy in, one ctypes call and one
    copy out, all three on the stream current at construction (the
    kernel's), and one synchronize of that stream. On the CPU
    ("torch_cpu") `plain`, the plain version of the same product
    (nnt_plain, or block_nnt_plain over the column blocks), and no pinned
    buffers."""

    def __init__(self, Nt: CsrOperand, N: CsrOperand, plain):
        self.device = N.vals.device
        self.Nt, self.N, self.m = Nt, N, N.rows
        self._plain = plain
        self._kernel = None
        if self.device.type == "cpu":
            return
        self._kernel = kernels.NntKernel(Nt, N)
        self._w_host = torch.empty(self.m, dtype=F64, pin_memory=True)
        self._z_host = torch.empty(self.m, dtype=F64, pin_memory=True)
        self._w_np, self._z_np = self._w_host.numpy(), self._z_host.numpy()
        self._w = torch.empty(self.m, dtype=F64, device=self.device)
        self._stream = torch.cuda.current_stream(self.device)

    def __call__(self, w: torch.Tensor) -> torch.Tensor:
        """z for w on the plan's device; on the card z is the kernel's
        buffer, which the next apply overwrites."""
        if self._kernel is None:
            return self._plain(w)
        return self._kernel.launch(w)

    def apply(self, w: np.ndarray) -> np.ndarray:
        """z for a host vector w, as a new host array."""
        if self._kernel is None:
            return self._plain(torch.from_numpy(
                np.ascontiguousarray(w, dtype=np.float64))).numpy()
        self._w_np[:] = w
        with torch.cuda.stream(self._stream):
            self._w.copy_(self._w_host, non_blocking=True)
            self._z_host.copy_(self._kernel.launch(self._w),
                               non_blocking=True)
        self._stream.synchronize()
        return self._z_np.copy()


class DeviceSplittedCR:
    """Host-looped phase-2 CR with the N N' product on the device.

    One instance per KKT solver; prepare() is called per factorization with
    the current SplittedNormalMatrix (its N, uscale and free positions).
    """

    def __init__(self, model, device: torch.device):
        self.m = model.num_rows
        self.n = model.num_cols
        self.device = device
        self._basis = None          # set by prepare()
        self.time_B = 0.0
        self.time_Bt = 0.0
        self.time_NNt = 0.0

    def prepare(self, splitted) -> None:
        """Uploads N' and N of a prepared SplittedNormalMatrix (the same
        operator as its host _apply) and builds their NntPlan."""
        N = splitted.N.tocsc(copy=True)
        N.sort_indices()
        Ncsr = N.tocsr()
        Ncsr.sort_indices()
        # the CSC arrays of N are the CSR arrays of N'
        self._Nt = CsrOperand(N.indptr, N.indices, N.data, self.m,
                              self.device, F64)
        self._N = CsrOperand(Ncsr.indptr, Ncsr.indices, Ncsr.data,
                             N.shape[1], self.device, F64)
        self._plan = NntPlan(self._Nt, self._N,
                             partial(nnt_plain, self._Nt, self._N))
        self._basis = splitted._basis
        self._uscale = np.asarray(splitted.uscale)
        self._freepos = np.asarray(splitted.free_positions)

    # -- one operator application: host B solves + device NN' --------------
    def _apply(self, v: np.ndarray) -> np.ndarray:
        s = self._uscale
        t0 = perf_counter()
        w = self._basis.solve_dense(v / s, "T")
        self.time_Bt += perf_counter() - t0
        t0 = perf_counter()
        z = self._plan.apply(w)
        self.time_NNt += perf_counter() - t0
        t0 = perf_counter()
        y = self._basis.solve_dense(z, "N")
        self.time_B += perf_counter() - t0
        out = y / s + v
        if self._freepos.size:
            out[self._freepos] = 0.0
        return out

    def solve(self, rhs: np.ndarray, tol: float, maxiter: int,
              deadline: float = 0.0, warm: np.ndarray = None):
        """Returns (lhs, iters, errflag); contract of the native cr_basis
        (inf-norm termination, 201 iter limit, 202 not posdef, 205 nan,
        999 past `deadline` in time.monotonic() seconds). `warm` optionally
        starts from a slot-space solution of the SAME prepared operator,
        kept only when its residual beats the zero start."""
        m = self.m
        if maxiter < 0:
            maxiter = m + 100
        self.time_B = self.time_Bt = self.time_NNt = 0.0
        rhs = np.asarray(rhs, dtype=np.float64)
        lhs = np.zeros(m)
        r = rhs.copy()
        if warm is not None and np.all(np.isfinite(warm)):
            Cw = self._apply(np.asarray(warm, dtype=np.float64))
            rw = rhs - Cw
            if np.max(np.abs(rw)) < np.max(np.abs(rhs)):
                lhs = np.asarray(warm, dtype=np.float64).copy()
                r = rw
        Cr = self._apply(r)
        cdot = float(r @ Cr)
        d = r.copy()
        cd = Cr.copy()
        denom = float(Cr @ Cr)
        it = 0
        err = 0
        while True:
            resnorm = float(np.max(np.abs(r))) if m else 0.0
            if np.isfinite(resnorm) and resnorm <= tol:
                break
            if it >= maxiter:
                err = 201
                break
            if deadline > 0.0 and it % 5 == 0 and monotonic() > deadline:
                err = 999
                break
            if not np.isfinite(resnorm):
                err = 205
                break
            if cdot <= 0.0:
                err = 202
                break
            alpha = cdot / denom
            if not np.isfinite(alpha):
                err = 205
                break
            lhs += alpha * d          # in place: lhs, r are this solve's
            r -= alpha * cd
            Cr = self._apply(r)
            cdot_new = float(r @ Cr)
            beta = cdot_new / cdot
            d = r + beta * d
            cd = Cr + beta * cd
            denom = float(cd @ cd)
            cdot = cdot_new
            it += 1
        return lhs, it, err
