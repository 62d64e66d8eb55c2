"""The port's hand-written CUDA kernels (csrc/), bound with ctypes.

``load()`` builds the library with nvcc at first use (build.py) and binds it
once. Each launcher below checks device, dtype, shape and contiguity of what
it is given, launches on the current CUDA stream of the tensors' device,
raises if the C entry returns a CUDA error, and then adds one to its
kernel's entry in ``LAUNCHES``. Outputs and scratch are allocated here with
``torch.empty``, never inside a kernel. Nothing in this module runs on the
CPU: the plain PyTorch versions sit beside the wrappers in ``ops/`` that
dispatch on a tensor's device, and a launcher given anything but a CUDA
tensor raises.

Kernels: K1 ``csr_spmv`` (SpmvPlan, checked once per operand and one
ctypes call a launch; BlockSpmvPlan, the P block products of a row-blocked
vector apply in one launch), K2 ``normal_apply`` (csrc/spmv.cu; the
stand-alone apply with its dot in one cooperative launch, csrc/cr.cu), K3
``cr_step`` (CrStep: a whole CR solve, its K2 applies inside, in one
cooperative launch, csrc/cr.cu), K4 ``nnt`` (NntKernel, one C call per N N'
apply over P >= 1 column blocks, csrc/nnt.cu); for the batched
phase 1, K5 ``csr_spmm`` (its plain products of 256 bytes a row of U and
more in a tiled form, k5_form), K6 ``normal_apply_batched``
(NormalBatchedPlan: one fused launch an apply where the operand's column
lengths allow it, csrc/spmm.cu), K7
``batched_cr_step`` (csrc/batch_cr.cu), K8 ``step_batch`` and K9
``ipm_update`` (csrc/ipm_step.cu); for the rest of the batched IPM step, in
float64, K10 ``ipm_prologue`` (csrc/ipm_prologue.cu), K11 ``newton_rhs``
and K12 ``newton_recover`` (csrc/newton.cu) and K13 ``starting_point``
(one cooperative launch, csrc/start.cu); for the sharded solves, in
float64, K14 ``block_sum``, K15 ``sharded_cr_step`` (ShardedCrStep: a whole row-blocked CR solve, its
vector applies inside, in one cooperative launch) and K16
``sharded_batched_cr_step`` (ShardedBatchedCrStep, its apply through
BlockNormalBatchedPlan: one fused launch where A's columns are short)
(csrc/sharded.cu) and K14v ``block_spmv_sum``, the vector apply's psum
fused into its first pass (csrc/nnt.cu);
for the level-scheduled triangular solve, in float64, K17 ``level_solve``
(a whole sweep in one launch, csrc/trisolve.cu). Batched arrays are (rows,
B) with the B lanes contiguous.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build as _build, trace

# launches per kernel since the last reset_launches()
LAUNCHES = dict.fromkeys(("csr_spmv", "normal_apply", "cr_step", "nnt",
                          "csr_spmm", "normal_apply_batched",
                          "batched_cr_step", "step_batch", "ipm_update",
                          "ipm_prologue", "newton_rhs", "newton_recover",
                          "starting_point", "block_sum", "sharded_cr_step",
                          "sharded_batched_cr_step", "level_solve",
                          "block_spmv_sum"), 0)
# Applies that ran inside another kernel's launches since the last
# reset_launches(), not launches (LAUNCHES counts those): K2's inside K3's
# cooperative solves and K14v's and K1's (one each an apply) inside K15's,
# as the kernels count them in their state, read once a solve (CrStep.solve,
# ShardedCrStep.solve); and K14's sums inside K16's fused applies, one an
# apply that did work (ShardedBatchedCrStep.solve).
# On those paths the inner kernels are not launched on their own.
INSIDE = dict.fromkeys(("normal_apply", "block_spmv_sum", "csr_spmv",
                        "block_sum"), 0)

_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}
_lib = None


def reset_launches() -> None:
    for counts in (LAUNCHES, INSIDE):
        for name in counts:
            counts[name] = 0


def load() -> ctypes.CDLL:
    """Builds (if stale) and binds the kernel library; raises on failure."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(_build.build())
        _declare(lib)
        _lib = lib
    return _lib


def _declare(lib: ctypes.CDLL) -> None:
    P, I, I64, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, \
        ctypes.c_double
    for t in _SUFFIX.values():
        f = getattr(lib, f"ipxt_csr_spmv_{t}")
        f.argtypes = [I64] + [P] * 10 + [I, P]
        f.restype = I
        f = getattr(lib, f"ipxt_reduce_sum_{t}")
        f.argtypes = [I64, P, P, P]
        f.restype = I
        f = getattr(lib, f"ipxt_cr_step_{t}")
        f.argtypes = [I, I64, I64, I64, D] + [P] * 11 + [I64, P, P]
        f.restype = I
        f = getattr(lib, f"ipxt_normal_apply_{t}")
        f.argtypes = ([I64] + [P] * 3 + [I, I64] + [P] * 3 + [I] + [P] * 5
                      + [I64, P, P])
        f.restype = I
        f = getattr(lib, f"ipxt_cr_solve_{t}")
        f.argtypes = ([I64, I64, D] + [P] * 11 + [I64, P, I64] + [P] * 3
                      + [I] + [P] * 3 + [I, P, P, P])
        f.restype = I
        f = getattr(lib, f"ipxt_csr_spmm_{t}")
        f.argtypes = [I64, I64] + [P] * 10 + [I, I, P]
        f.restype = I
        f = getattr(lib, f"ipxt_csr_spmm_tile_{t}")
        f.argtypes = [I64, I64] + [P] * 5 + [I] * 3 + [P]
        f.restype = I
        f = getattr(lib, f"ipxt_normal_batched_{t}")
        f.argtypes = [I64, I64] + [P] * 12 + [I, P]
        f.restype = I
        f = getattr(lib, f"ipxt_lane_sum_{t}")
        f.argtypes = [I64, I64, P, P, P]
        f.restype = I
        f = getattr(lib, f"ipxt_bcr_step_{t}")
        f.argtypes = [I, I64, I64, I64, I64] + [P] * 10 + [I64, P, I64, P, P]
        f.restype = I
        f = getattr(lib, f"ipxt_step_batch_{t}")
        f.argtypes = [I64, I64] + [P] * 11 + [I64, P, P, P]
        f.restype = I
        f = getattr(lib, f"ipxt_muaff_{t}")
        f.argtypes = [I64, I64] + [P] * 12 + [D, P, I64, P, P]
        f.restype = I
        f = getattr(lib, f"ipxt_ipm_update_{t}")
        f.argtypes = [I64, I64, I64] + [P] * 18
        f.restype = I
    f64 = {"ipxt_ipm_prologue_f64": [I64] * 3 + [P] * 22 + [I64, P, P]
           + [D] * 5 + [P],
           "ipxt_lane_mu_f64": [I64, I64] + [P] * 7 + [I64, P, D, P],
           "ipxt_newton_rhs_f64": [I64] * 3 + [P] * 21,
           "ipxt_normal_rhs_f64": [I64] * 3 + [P] * 5,
           "ipxt_newton_dx_f64": [I64] * 3 + [P] * 5,
           "ipxt_newton_recover_f64": [I64] * 3 + [P] * 22,
           "ipxt_starting_point_f64": [I64] * 3 + [P] * 17 + [I64, P, D, D,
                                                               P],
           "ipxt_starting_point_coop_f64": [I64] * 3 + [P] * 17
           + [I64, P, D, D, P],
           "ipxt_block_sum_f64": [I64, I64] + [P] * 5,
           "ipxt_scr_step_f64": [I, I64, I64, I64, I64, I64, I64, D, I]
           + [P] * 12
           + [I64, P, P, P],
           "ipxt_scr_solve_f64": [I64, I, I64, D, I] + [P] * 12
           + [I64, P, P, I64, P, P, P, I] + [P] * 11,
           "ipxt_block_normal_batched_f64": [I] + [P] * 5 + [I64] + [P] * 9
           + [I, P],
           "ipxt_sbcr_step_f64": [I, I64, I64, I64, I64, I64, D] + [P] * 11
           + [I64, P, P, P],
           "ipxt_level_solve_f64": [I64, P, I64] + [P] * 8,
           "ipxt_level_sweep_f64": [I64, I64, P, I64, I] + [P] * 8,
           "ipxt_nnt_f64": [I64, P, P, P, I] * 2 + [I] + [P] * 4 + [I, P],
           "ipxt_block_spmv_sum_f64": [I64, P, P, P, I, I] + [P] * 6}
    for name, argtypes in f64.items():
        f = getattr(lib, name)
        f.argtypes = argtypes
        f.restype = I
    lib.ipxt_block_spmv_f64.argtypes = [I] + [P] * 13
    lib.ipxt_block_spmv_f64.restype = I
    lib.ipxt_red_blocks.argtypes = [I64, I64]
    lib.ipxt_red_blocks.restype = I64
    lib.ipxt_lane_blocks.argtypes = [I64, I64]
    lib.ipxt_lane_blocks.restype = I64
    lib.ipxt_bcr_state_len.argtypes = [I64]
    lib.ipxt_bcr_state_len.restype = I64
    lib.ipxt_spmv_blocks.argtypes = [I64, I]
    lib.ipxt_spmv_blocks.restype = I64
    lib.ipxt_cr_blocks.argtypes = [I64]
    lib.ipxt_cr_blocks.restype = I64
    lib.ipxt_scr_blocks.argtypes = [I64]
    lib.ipxt_scr_blocks.restype = I64
    lib.ipxt_sbcr_state_len.argtypes = [I64]
    lib.ipxt_sbcr_state_len.restype = I64
    lib.ipxt_cr_state_len.argtypes = []
    lib.ipxt_cr_state_len.restype = I64
    lib.ipxt_error_string.argtypes = [I]
    lib.ipxt_error_string.restype = ctypes.c_char_p


# -- checks -------------------------------------------------------------------
def _check(t, name: str, device: torch.device, dtype: torch.dtype,
           shape) -> None:
    """Raises unless `t` is a contiguous tensor of `device`, `dtype` and
    `shape` (a tuple, or an int for a vector)."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _lanes(x: torch.Tensor, name: str) -> int:
    """B of an (rows, B) batch."""
    if x.dim() != 2:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"(rows, B)")
    return x.shape[1]


def _device_of(x: torch.Tensor) -> torch.device:
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        where = x.device if isinstance(x, torch.Tensor) else type(x).__name__
        raise ValueError(f"CUDA kernels take CUDA tensors, got {where}")
    if x.dtype not in _SUFFIX:
        raise ValueError(f"CUDA kernels take float64 or float32, got "
                         f"{x.dtype}")
    return x.device


def _check_operand(op, device: torch.device, dtype: torch.dtype) -> None:
    _check(op.indptr, "indptr", device, torch.int64, op.rows + 1)
    _check(op.indices, "indices", device, torch.int32, op.vals.numel())
    _check(op.vals, "vals", device, dtype, op.vals.numel())
    if op.vec not in (2, 4, 8, 16, 32):
        raise ValueError(f"lanes per row must be a power of two in [2, 32], "
                         f"got {op.vec}")


def _raise_if(err: int, what: str) -> None:
    if err:
        msg = _lib.ipxt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# -- K1 / K2 / K4 -------------------------------------------------------------
THREADS = 256         # threads of a block (kThreads, csrc/common.cuh)


def _blocks_for(n: int, per: int) -> int:
    return -(-n // per)


def spmv_blocks(op) -> int:
    """Length of the partials a launch over operand `op` at its own lanes
    per row (op.vec, as K2 takes it) writes: its CUDA blocks
    (ipxt_spmv_blocks of csrc/spmv.cu)."""
    return _blocks_for(op.rows, THREADS // op.vec)


def k1_lanes(op) -> int:
    """Lanes per row of K1's plans: the power of two at or below the mean
    row length of `op`, within [2, 32]. On A of the 20k LP (9.6 nonzeros a
    row) 8 lanes take 18-20% less device time than the 16 of ops/spmv.py's
    lanes_per_row, which K2, K4 and K14v keep (PERF.md §6)."""
    return k1_lanes_of(op.vals.numel(), op.rows)


def k1_lanes_of(nnz: int, rows: int) -> int:
    """k1_lanes of an operand of `rows` rows and `nnz` nonzeros."""
    mean = nnz / rows if rows else 0.0
    vec = 2
    while vec < 32 and 2 * vec <= mean:
        vec *= 2
    return vec


class SpmvPlan:
    """K1 bound to one CSR operand `op` of ops/spmv.py, float64 or float32:
    the operand is checked, the C function bound and the current stream of
    its device taken once, here; a call then checks only what it is given
    and makes one ctypes call. `vec` (lanes per row) defaults to
    k1_lanes(op). csr_spmv and K2 go through the plans cached on the
    operand (plan_of), which launch on the stream that was current when they
    were built."""

    def __init__(self, op, vec: int = None):
        device, dtype = _device_of(op.vals), op.vals.dtype
        _check_operand(op, device, dtype)
        vec = k1_lanes(op) if vec is None else vec
        if vec not in (2, 4, 8, 16, 32):
            raise ValueError(f"lanes per row must be a power of two in "
                             f"[2, 32], got {vec}")
        lib = load()
        self.op, self.device, self.dtype, self.vec = op, device, dtype, vec
        self.nblk = _blocks_for(op.rows, THREADS // vec)
        self._shape = {"x": torch.Size([op.cols]),
                       "state": torch.Size([int(lib.ipxt_cr_state_len())])}
        self._rows = torch.Size([op.rows])
        self._fn = getattr(lib, f"ipxt_csr_spmv_{_SUFFIX[dtype]}")
        self._head = (op.rows, op.indptr.data_ptr(), op.indices.data_ptr(),
                      op.vals.data_ptr())
        self._stream = _stream(device)

    def _ptr(self, t, name: str, shape=None):
        """The pointer of `t` (None for None) once it is a contiguous tensor
        of the plan's device and dtype and of `shape` (the rows of op)."""
        if t is None:
            return None
        shape = self._rows if shape is None else shape
        if not (isinstance(t, torch.Tensor) and t.dtype == self.dtype
                and t.shape == shape and t.device == self.device
                and t.is_contiguous()):
            _check(t, name, self.device, self.dtype, tuple(shape))
        return t.data_ptr()

    def __call__(self, x, out=None, rowscale=None, addw=None, addv=None,
                 partials=None, state=None) -> torch.Tensor:
        """out = (op @ x) * rowscale + addw * addv, into `out` if given,
        with the block partials of addv.out in `partials` (length nblk);
        each epilogue optional. `state` is a CR loop's: once it says done,
        the launch returns at once. Counts nothing: csr_spmv counts K1's
        launches, normal_apply K2's."""
        if (addw is None) != (addv is None):
            raise ValueError("addw and addv go together")
        if partials is not None and addv is None:
            raise ValueError("partials need addv")
        xp = self._ptr(x, "x", self._shape["x"])
        if out is None:
            out = torch.empty(self._rows, dtype=self.dtype,
                              device=self.device)
            yp = out.data_ptr()
        else:
            yp = self._ptr(out, "out")
        err = self._fn(*self._head, xp, self._ptr(rowscale, "rowscale"),
                       self._ptr(addw, "addw"), self._ptr(addv, "addv"), yp,
                       self._ptr(partials, "partials",
                                 torch.Size([self.nblk])),
                       self._ptr(state, "state", self._shape["state"]),
                       self.vec, self._stream)
        _raise_if(err, "csr_spmv")
        return out


def plan_of(op, vec: int = None) -> SpmvPlan:
    """The SpmvPlan of operand `op` at `vec` lanes per row (by default
    k1_lanes(op), K1's; K2 asks for op.vec), built at its first use and kept
    on the operand."""
    vec = k1_lanes(op) if vec is None else vec
    plans = op.__dict__.setdefault("_spmv_plans", {})
    if vec not in plans:
        plans[vec] = SpmvPlan(op, vec)
    return plans[vec]


def csr_spmv(op, x: torch.Tensor, out=None, addw=None, addv=None,
             partials=None, state=None) -> torch.Tensor:
    """K1: y = op @ x on the card, into `out` if given; with addw and addv,
    y = op @ x + addw * addv and, with `partials`, the block partials of
    addv.y (a block product of the sharded solves). `state` is a CR loop's:
    once it says done, the launch returns at once. Through the operand's
    plan: one ctypes call."""
    y = plan_of(op)(x, out, addw=addw, addv=addv, partials=partials,
                    state=state)
    LAUNCHES["csr_spmv"] += 1
    return y


def normal_apply(At, A, W: torch.Tensor, v: torch.Tensor, out=None,
                 u=None, partials=None, state=None, dot=None,
                 one_launch: bool = True):
    """K2: out = A (W[:n] * (A' v)) + W[n:] * v, with the block partials of
    v.out in `partials`; with `dot` (a 1-element tensor) also their sum.
    `At` is A' as a CSR operand (n rows), `A` is A (m rows).

    With `dot` and no `state` (spmv.normal_apply, the stand-alone apply of
    the tests and chip_smoke.py), one cooperative launch computes both
    halves and the sum (ipxt_normal_apply, csrc/cr.cu); `one_launch`
    False takes the three-launch form instead (two K1 launches and
    reduce_sum, csrc/spmv.cu), for the comparisons. K3's host-issued form
    passes `partials` and `state`, never `dot`, and takes the two K1
    launches. Either form counts one apply in LAUNCHES."""
    device = _device_of(v)
    n, m = At.rows, A.rows
    _check(W, "W", device, v.dtype, n + m)
    e = lambda k: torch.empty(k, dtype=v.dtype, device=device)  # noqa: E731
    plan_t, plan = plan_of(At, At.vec), plan_of(A, A.vec)
    out = e(m) if out is None else out
    u = e(n) if u is None else u
    partials = e(plan.nblk) if partials is None else partials
    if dot is not None:
        _check(dot, "dot", device, v.dtype, 1)
    if dot is not None and state is None and one_launch:
        _check(v, "v", device, v.dtype, m)
        _check(out, "out", device, v.dtype, m)
        _check(u, "u", device, v.dtype, n)
        _check(partials, "partials", device, v.dtype, plan.nblk)
        fn = getattr(_lib, f"ipxt_normal_apply_{_SUFFIX[v.dtype]}")
        err = fn(n, At.indptr.data_ptr(), At.indices.data_ptr(),
                 At.vals.data_ptr(), At.vec, m, A.indptr.data_ptr(),
                 A.indices.data_ptr(), A.vals.data_ptr(), A.vec,
                 W.data_ptr(), v.data_ptr(), u.data_ptr(), out.data_ptr(),
                 partials.data_ptr(), plan.nblk, dot.data_ptr(),
                 _stream(device))
        _raise_if(err, "normal_apply (one launch)")
        LAUNCHES["normal_apply"] += 1
        return out
    plan_t(v, u, rowscale=W[:n], state=state)
    plan(u, out, addw=W[n:], addv=v, partials=partials, state=state)
    if dot is not None:
        fn = getattr(_lib, f"ipxt_reduce_sum_{_SUFFIX[v.dtype]}")
        _raise_if(fn(partials.numel(), partials.data_ptr(), dot.data_ptr(),
                     _stream(device)), "reduce_sum")
    LAUNCHES["normal_apply"] += 1
    return out


MAX_SPLIT = 8         # blocks a split operand may have (csrc/nnt.cu)


def _op_args(op) -> tuple:
    """The arguments by which a C entry of csrc/nnt.cu takes a CSR
    operand: rows, indptr, indices, vals and lanes per row."""
    return (op.rows, op.indptr.data_ptr(), op.indices.data_ptr(),
            op.vals.data_ptr(), op.vec)


def _check_split(op, device: torch.device) -> None:
    """A float64 CSR operand in the split layout of ops/spmv.py (which
    checks its bounds when it is built) that csrc/nnt.cu takes: at most
    MAX_SPLIT blocks."""
    _check_operand(op, device, F64)
    if not 1 <= op.P <= MAX_SPLIT:
        raise ValueError(f"the split kernels take 1 to {MAX_SPLIT} blocks, "
                         f"got {op.P}")


class NntKernel:
    """K4 bound to one operand: z = sum_{p<P} N_p (N_p' w), the P column
    blocks summed in block order, in one C call (csrc/nnt.cu). `Nt` is N' as
    a CSR operand, `N` the CSR operand of N split at the P - 1 column
    bounds (P = 1: N (N' w)); float64. The operands are checked, u and z
    allocated, the argument tuple packed and the current stream taken once,
    here; launch(w) then checks w and makes one ctypes call, one
    cooperative launch with a grid-wide barrier between the halves. The z
    it returns is this object's and the next launch overwrites it."""

    def __init__(self, Nt, N):
        device = _device_of(N.vals)
        load()
        _check_operand(Nt, device, F64)
        _check_split(N, device)
        if (Nt.rows, Nt.cols) != (N.cols, N.rows):
            raise ValueError(f"Nt is {Nt.rows} x {Nt.cols}, N is {N.rows} x "
                             f"{N.cols}: not N' and N")
        self.device, self.m = device, N.rows
        self.u = torch.empty(Nt.rows, dtype=F64, device=device)
        self.z = torch.empty(N.rows, dtype=F64, device=device)
        self._keep = (Nt, N)            # alive while the pointers are used
        self._head = (*_op_args(Nt), *_op_args(N), N.P, N.inner_ptr)
        self._tail = (self.u.data_ptr(), self.z.data_ptr())
        self._stream = _stream(device)

    def launch(self, w: torch.Tensor, cooperative: bool = True
               ) -> torch.Tensor:
        """z for w. `cooperative` False takes the C entry's two-launch form
        instead, which the solvers never ask for: chip_smoke.py times the
        two forms in turns, and the cooperative one is kept as the faster
        (PERF.md §6)."""
        _check(w, "w", self.device, F64, self.m)
        err = _lib.ipxt_nnt_f64(*self._head, w.data_ptr(), *self._tail,
                                int(cooperative), self._stream)
        _raise_if(err, "nnt")
        LAUNCHES["nnt"] += 1
        return self.z


# -- K3 -----------------------------------------------------------------------
class CrStep:
    """K3: one CR solve (csrc/cr.cu) on one card, on C = A diag(W[:n]) A' +
    diag(W[n:]) with preconditioner 1/invd. `At` is A' as a CSR operand (n
    rows), `A` is A (m rows), both summed at their own lanes per row (op.vec,
    K2's).

    Owns the loop's m-vectors, the per-block partials, K2's (n,) scratch u
    and the scalar state, all allocated once per solve. `residual` starts as
    a copy of `rhs`. solve() runs the whole loop, its K2 applies inside, in
    one cooperative launch; solve(cooperative=False) runs the host-issued
    passes and K2 launches instead, which the solvers never ask for: the card
    tests and chip_smoke.py hold the two forms bit for bit."""

    PRECOND, INIT, PASS_A, PASS_B, PASS_C, RECHECK = range(6)
    # state slots (csrc/common.cuh)
    IT, ERR, DONE, APPLIES = 3, 4, 5, 6
    RECHECK_EVERY = 5   # kRecheckEvery of csrc/cr.cu
    POLL = 5            # trips between the host-issued form's reads of done

    def __init__(self, At, A, W: torch.Tensor, invd: torch.Tensor,
                 resscale: torch.Tensor, rhs: torch.Tensor):
        device, dtype = _device_of(rhs), rhs.dtype
        lib = load()
        m = rhs.numel()
        _check(rhs, "rhs", device, dtype, m)
        _check(invd, "invd", device, dtype, m)
        _check(resscale, "resscale", device, dtype, m)
        _check_operand(At, device, dtype)
        _check_operand(A, device, dtype)
        n = At.rows
        if (A.rows, At.cols, A.cols) != (m, m, n):
            raise ValueError(f"At is {At.rows} x {At.cols}, A {A.rows} x "
                             f"{A.cols}: not A' and A of {m} rows")
        _check(W, "W", device, dtype, n + m)
        e = lambda k: torch.empty(k, dtype=dtype, device=device)  # noqa: E731
        nblk, npc = int(lib.ipxt_cr_blocks(m)), spmv_blocks(A)
        self.At, self.A, self.W = At, A, W
        self.m, self.device, self.dtype = m, device, dtype
        self.residual = rhs.clone()
        self.lhs, self.sres, self.csres, self.step, self.cstep = (
            e(m) for _ in range(5))
        self.u = e(n)
        self.pa, self.pr, self.pc = e(2 * nblk), e(nblk), e(npc)
        # zeros made on the host: the state is copied up, not filled by a
        # device kernel
        self.state = torch.zeros(int(lib.ipxt_cr_state_len()),
                                 dtype=dtype).to(device)
        self._keep = (invd, resscale)   # alive while the pointers are used
        self._fn = getattr(lib, f"ipxt_cr_step_{_SUFFIX[dtype]}")
        self._solve = getattr(lib, f"ipxt_cr_solve_{_SUFFIX[dtype]}")
        self._stream = _stream(device)
        self._bufs = (invd.data_ptr(), resscale.data_ptr(),
                      self.lhs.data_ptr(), self.residual.data_ptr(),
                      self.sres.data_ptr(), self.csres.data_ptr(),
                      self.step.data_ptr(), self.cstep.data_ptr(),
                      self.pa.data_ptr(), self.pr.data_ptr(),
                      self.pc.data_ptr(), npc, self.state.data_ptr())
        self._ops = (n, At.indptr.data_ptr(), At.indices.data_ptr(),
                     At.vals.data_ptr(), At.vec, A.indptr.data_ptr(),
                     A.indices.data_ptr(), A.vals.data_ptr(), A.vec,
                     W.data_ptr(), self.u.data_ptr())

    def solve(self, maxiter: int, tol: float, cooperative: bool = True):
        """Runs the loop from the start and returns (lhs on the card,
        iterations, error code of the loop) from one read of the state. The
        cooperative launch adds the K2 applies it ran to INSIDE; a refused
        launch raises."""
        if not cooperative:
            return self._host_issued(maxiter, tol)
        err = self._solve(self.m, maxiter, tol, *self._bufs, *self._ops,
                          self._stream)
        _raise_if(err, "cr_step (cooperative solve)")
        LAUNCHES["cr_step"] += 1
        st = self.state.cpu()
        INSIDE["normal_apply"] += int(st[self.APPLIES])
        return self.lhs, int(st[self.IT]), int(st[self.ERR])

    def _launch(self, phase: int, k: int, maxiter: int, tol: float) -> None:
        """One pass of the host-issued form."""
        err = self._fn(phase, self.m, k, maxiter, tol, *self._bufs,
                       self._stream)
        _raise_if(err, f"cr_step phase {phase}")
        LAUNCHES["cr_step"] += 1

    def _host_issued(self, maxiter: int, tol: float):
        """The host issues each trip's passes and two K2 launches, and reads
        the stop flag every POLL trips."""
        def C_sres():   # Csres = C sres, partials of sres.Csres into pc
            normal_apply(self.At, self.A, self.W, self.sres, out=self.csres,
                         u=self.u, partials=self.pc, state=self.state)

        self._launch(self.PRECOND, 0, maxiter, tol)
        C_sres()
        self._launch(self.INIT, 0, maxiter, tol)
        k = 0
        while True:
            for phase in (self.PASS_A, self.PASS_B):
                self._launch(phase, k, maxiter, tol)
            C_sres()
            self._launch(self.PASS_C, k, maxiter, tol)
            if (k + 1) % self.RECHECK_EVERY == 0:
                self._launch(self.PRECOND, k, maxiter, tol)
                C_sres()
                self._launch(self.RECHECK, k, maxiter, tol)
            k += 1
            # trip `maxiter` always stops, so the loop ends by trip
            # maxiter + 1
            if (k % self.POLL == 0 or k > maxiter) and bool(
                    self.state[self.DONE].item()):
                st = self.state.cpu()
                return self.lhs, int(st[self.IT]), int(st[self.ERR])


# -- K5 / K6 ------------------------------------------------------------------
def lane_blocks(rows: int, chunks: int) -> int:
    """Row blocks of a batched pass over `rows` rows and `chunks` lane
    chunks: the number of per-lane partials it writes."""
    return int(load().ipxt_lane_blocks(rows, chunks))


def spmm_width(B: int, dtype: torch.dtype, *tensors) -> int:
    """Lanes a thread of K5 takes: one 16-byte vector where B and the
    pointers allow it, else 1."""
    v = 16 // torch.empty(0, dtype=dtype).element_size()
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors if t is not None)
    return v if B % v == 0 and aligned else 1


# K5's gathers a thread issues together (row_gather in csrc/spmm.cu): 2 on an
# operand whose rows average fewer than K5_UNROLL_BELOW nonzeros, 1 (one at a
# time) elsewhere; the same Y bit for bit either way. On the card 2 took 5-7%
# less device time on A' of the 20k LP (2 nonzeros a row), 1-4% less at 2 a
# row on other operands, 1-5% more at 3 to 5 a row, and 7% more on the LP's
# A U in f64 (9.6 a row) (PERF.md §6, tools/torch_profile.py --what k5).
K5_UNROLL_BELOW = 3.0


def k5_unroll(op) -> int:
    """The unroll K5 takes on operand `op`, from its mean row length."""
    return 2 if op.vals.numel() < K5_UNROLL_BELOW * op.rows else 1


# K5's tiled form (csr_spmm_tile_kernel in csrc/spmm.cu), the plain product
# Y = A U with no epilogue: a group of threads gathers a segment of
# K5_SEG_BYTES of a row of U a nonzero and streams over K5_GROUP_NZ
# nonzeros or so, its rows' indices staged in shared memory (K5_STAGE_NZ a
# block at most) and its gathers issued four at a time.
K5_SEG_BYTES = 256        # a lane tile
K5_STAGE_NZ = 2048        # kStageNz
K5_GROUP_NZ = 24
K5_TILE_ROWS = 256        # kTileRows
# The tiled form runs the plain products whose rows of U hold at least
# K5_SEG_BYTES (B >= 32 in f64, B >= 64 in f32); the row body
# (csr_spmm_kernel) runs the narrower ones, where it took less device time
# on the card (B = 4 and 8; at 32 in f32 on A U), and every launch with an
# epilogue, partials or a loop state, whose partial slots K6's and K16's
# fused forms repeat (PERF.md §6, tools/torch_profile.py --what k5).


def k5_form(B: int, itemsize: int, epilogue: bool) -> str:
    """"tile" (csr_spmm_tile_kernel) or "row" (csr_spmm_kernel): the form of
    K5 that a launch at B lanes of `itemsize` bytes takes, on any operand;
    `epilogue` is true when it has a rowscale, addw and addv, partials or a
    loop state."""
    return "row" if epilogue or B * itemsize < K5_SEG_BYTES else "tile"


def k5_tile(op, B: int, vw: int, itemsize: int) -> tuple:
    """(tpr, rpg) of the tiled form on `op` at B lanes, vw lanes a thread:
    threads a group, which gather one segment of at most K5_SEG_BYTES, and
    rows a group, about K5_GROUP_NZ nonzeros at the operand's mean row
    length, with the block's tile (256 // tpr groups) at most K5_TILE_ROWS
    rows and about half of K5_STAGE_NZ nonzeros."""
    tpr = min(B // vw, K5_SEG_BYTES // (vw * itemsize))
    groups = THREADS // tpr
    rpg = K5_TILE_ROWS // groups
    mean = op.vals.numel() / max(op.rows, 1)
    if mean > 0:
        rpg = min(rpg, int(K5_GROUP_NZ / mean),
                  int(K5_STAGE_NZ / (2 * groups * mean)))
    return tpr, max(rpg, 1)


def _spmm(op, U, Y, rowscale=None, addw=None, addv=None, partials=None,
          state=None, unroll=None, form=None, vw=None) -> None:
    """One launch of the batched CSR kernel with its optional epilogues, in
    the form k5_form picks unless `form` ("tile" or "row") says otherwise,
    the row body at `unroll` gathers a thread issues together (by default
    k5_unroll(op)). The card tests and tools/torch_profile.py --what k5 ask
    for each. `vw`, the lanes a thread takes, defaults to spmm_width's; 1
    is always valid (a mesh rank asks for it, parallel/mesh.py)."""
    device, dtype = U.device, U.dtype
    lib = load()
    _check_operand(op, device, dtype)
    B = _lanes(U, "U")
    _check(U, "U", device, dtype, (op.cols, B))
    _check(Y, "Y", device, dtype, (op.rows, B))
    for name, t in (("rowscale", rowscale), ("addw", addw), ("addv", addv)):
        if t is not None:
            _check(t, name, device, dtype, (op.rows, B))
    if (addw is None) != (addv is None):
        raise ValueError("addw and addv go together")
    if vw is None:
        vw = spmm_width(B, dtype, U, Y, rowscale, addw, addv, partials)
    elif vw != 1 and vw != spmm_width(B, dtype, U, Y, rowscale, addw, addv,
                                      partials):
        raise ValueError(f"K5 cannot take {vw} lanes a thread here")
    epilogue = any(t is not None for t in (rowscale, addw, partials, state))
    if form is None:
        form = k5_form(B, U.element_size(), epilogue)
    if form == "tile":
        if epilogue:
            raise ValueError("K5's tiled form takes no epilogue, partials "
                             "or state")
        tpr, rpg = k5_tile(op, B, vw, U.element_size())
        fn = getattr(lib, f"ipxt_csr_spmm_tile_{_SUFFIX[dtype]}")
        err = fn(op.rows, B, op.indptr.data_ptr(), op.indices.data_ptr(),
                 op.vals.data_ptr(), U.data_ptr(), Y.data_ptr(), vw, tpr,
                 rpg, _stream(device))
        _raise_if(err, "csr_spmm (tiled)")
        return
    if partials is not None:
        if addv is None:
            raise ValueError("partials need addv")
        _check(partials, "partials", device, dtype,
               (lane_blocks(op.rows, B // vw), B))
    if state is not None:
        _check(state, "state", device, dtype, int(lib.ipxt_bcr_state_len(B)))
    fn = getattr(lib, f"ipxt_csr_spmm_{_SUFFIX[dtype]}")
    err = fn(op.rows, B, op.indptr.data_ptr(), op.indices.data_ptr(),
             op.vals.data_ptr(), U.data_ptr(), _ptr(rowscale), _ptr(addw),
             _ptr(addv), Y.data_ptr(), _ptr(partials), _ptr(state), vw,
             k5_unroll(op) if unroll is None else unroll, _stream(device))
    _raise_if(err, "csr_spmm")


def csr_spmm(op, U: torch.Tensor, out=None, addw=None, addv=None,
             partials=None, state=None, vw=None) -> torch.Tensor:
    """K5: Y = op @ U for U of shape (op.cols, B), on the card, into `out`
    if given; with addw and addv, Y = op @ U + addw * addv and, with
    `partials`, the per-block partials of the column dots addv.Y (a block
    product of the sharded solves). `state` is a CR loop's: once it says
    done, the launch returns at once. `vw` as for _spmm."""
    device = _device_of(U)
    Y = torch.empty((op.rows, _lanes(U, "U")), dtype=U.dtype,
                    device=device) if out is None else out
    _spmm(op, U, Y, addw=addw, addv=addv, partials=partials, state=state,
          vw=vw)
    LAUNCHES["csr_spmm"] += 1
    return Y


# The fused K6 gathers sum_k len_k^2 rows of V, len_k the nonzeros of column
# k of A, where the two launches gather 2 nnz(A) and write and read back the
# (n, B) array U. It runs where sum_k len_k^2 <= K6_FUSED_RATIO * nnz(A):
# the transportation LPs (every column 2 nonzeros) have a ratio of 2; one
# dense column of an m-row LP makes it about m. 4 admits columns of up to 4
# nonzeros on average, the longest at which the fused launch still beat the
# two launches on the card (PERF.md §6, tools/torch_profile.py --what k6).
K6_FUSED_RATIO = 4.0


def k6_fused(At) -> bool:
    """The rule of NormalBatchedPlan on the operand A' (whose rows are the
    columns of A), from its row lengths on the host (CsrOperand.sq_rows)."""
    return At.sq_rows <= K6_FUSED_RATIO * At.vals.numel()


class NormalBatchedPlan:
    """K6 bound to one operand pair, float64 or float32: C V = A (W[:n] *
    (A' V)) + W[n:] * V for V of shape (m, B), with the per-block partials of
    the column dots V.CV. `At` is A' as a CSR operand (n rows), `A` is A
    (m rows). The operands are checked, the form picked (k6_fused: one fused
    launch that never writes U = W[:n] * (A' V), or the two K5 launches) and
    the C arguments packed once, here. A failed launch raises; nothing
    retries it in the other form."""

    def __init__(self, At, A):
        device, dtype = _device_of(A.vals), A.vals.dtype
        _check_operand(At, device, dtype)
        _check_operand(A, device, dtype)
        if (At.rows, At.cols) != (A.cols, A.rows):
            raise ValueError(f"At is {At.rows} x {At.cols}, A is {A.rows} x "
                             f"{A.cols}: not A' and A")
        lib = load()
        self.At, self.A, self.device, self.dtype = At, A, device, dtype
        self.n, self.m = At.rows, A.rows
        self.fused = k6_fused(At)
        self._fused_fn = getattr(lib, f"ipxt_normal_batched_{_SUFFIX[dtype]}")
        self._ops = (A.indptr.data_ptr(), A.indices.data_ptr(),
                     A.vals.data_ptr(), At.indptr.data_ptr(),
                     At.indices.data_ptr(), At.vals.data_ptr())

    def width(self, W, V, out, partials=None) -> int:
        """Lanes a thread takes (spmm_width): the second launch's of the
        two-launch form, whose U torch.empty aligns, and the fused one's."""
        return spmm_width(V.shape[1], self.dtype, V, W, W[self.n:], out,
                          partials)

    def partials_shape(self, W, V, out) -> tuple:
        """Shape of the per-lane partials for these buffers: the row blocks
        of K5's grid over the m rows at this width, by B."""
        B = _lanes(V, "V")
        return (lane_blocks(self.m, B // self.width(W, V, out)), B)

    def __call__(self, W, V, out=None, U=None, partials=None, state=None,
                 fused=None) -> torch.Tensor:
        """out = C V, into `out` if given, with the partials of V.out in
        `partials` if given. `fused` overrides the plan's form (chip_smoke.py
        and the card tests time and hold the two against each other); `U`
        is the two-launch form's (n, B) scratch, allocated if not given.
        `state` is a CR loop's: once it says done, the launch returns at
        once."""
        n, m = self.n, self.m
        B = _lanes(V, "V")
        device, dtype = self.device, self.dtype
        _check(V, "V", device, dtype, (m, B))
        _check(W, "W", device, dtype, (n + m, B))
        out = torch.empty((m, B), dtype=dtype, device=device) \
            if out is None else out
        _check(out, "out", device, dtype, (m, B))
        fused = self.fused if fused is None else fused
        if not fused:
            U = torch.empty((n, B), dtype=dtype, device=device) \
                if U is None else U
            _spmm(self.At, V, U, rowscale=W[:n], state=state)
            _spmm(self.A, U, out, addw=W[n:], addv=V, partials=partials,
                  state=state)
            return out
        vw = self.width(W, V, out, partials)
        if partials is not None:
            _check(partials, "partials", device, dtype,
                   (lane_blocks(m, B // vw), B))
        if state is not None:
            _check(state, "state", device, dtype,
                   int(_lib.ipxt_bcr_state_len(B)))
        err = self._fused_fn(m, B, *self._ops, V.data_ptr(), W.data_ptr(),
                             W[n:].data_ptr(), out.data_ptr(),
                             _ptr(partials), _ptr(state), vw,
                             _stream(device))
        _raise_if(err, "normal_apply_batched (fused)")
        return out


def normal_plan_of(At, A) -> NormalBatchedPlan:
    """The NormalBatchedPlan of the pair (At, A), built at its first use and
    kept on A (the plan holds At, so the key stays At's)."""
    plans = A.__dict__.setdefault("_k6_plans", {})
    if id(At) not in plans:
        plans[id(At)] = NormalBatchedPlan(At, A)
    return plans[id(At)]


def normal_apply_batched(At, A, W: torch.Tensor, V: torch.Tensor, out=None,
                         U=None, partials=None, state=None, dots=None):
    """K6: out = A (W[:n] * (A' V)) + W[n:] * V for V of shape (m, B), with
    the per-block partials of the column dots V.out in `partials`; with
    `dots` (a (B,) tensor) also their sums, a warp a lane. Through the
    pair's plan (normal_plan_of): one fused launch, or two K5 launches where
    the plan's rule says so. The batched CR passes `partials`, never
    `dots`: the sum (lane_sum in csrc/spmm.cu) serves
    spmv.normal_apply_batched."""
    device = _device_of(V)
    plan = normal_plan_of(At, A)
    if partials is None:
        out = torch.empty_like(V) if out is None else out
        partials = torch.empty(plan.partials_shape(W, V, out),
                               dtype=V.dtype, device=device)
    out = plan(W, V, out=out, U=U, partials=partials, state=state)
    if dots is not None:
        B = _lanes(V, "V")
        _check(dots, "dots", device, V.dtype, B)
        fn = getattr(_lib, f"ipxt_lane_sum_{_SUFFIX[V.dtype]}")
        _raise_if(fn(partials.shape[0], B, partials.data_ptr(),
                     dots.data_ptr(), _stream(device)), "lane_sum")
    LAUNCHES["normal_apply_batched"] += 1
    return out


# -- K7 -----------------------------------------------------------------------
class BatchedCrStep:
    """K7: the passes of one batched CR solve (csrc/batch_cr.cu) on one card.

    Owns the loop's (m, B) arrays, the per-lane partials, the state and,
    where K6's plan takes the two launches, their (n, B) scratch U, all
    allocated once per solve. `R` starts as a copy of `rhs`. `invd` and
    `resscale` are (m, B) and `tol` is (B,), all of rhs's dtype; `W` is the
    (n + m, B) weight of the K6 that the host launches on `S` between kPassB
    and kBeta (`normal_apply`)."""

    INIT, START, PASS_CA, CHECK, PASS_B, BETA = range(6)
    # state slots (csrc/common.cuh)
    IT, DONE = 3, 5

    def __init__(self, At, A, W: torch.Tensor, invd: torch.Tensor,
                 resscale: torch.Tensor, tol: torch.Tensor,
                 rhs: torch.Tensor):
        device, dtype = _device_of(rhs), rhs.dtype
        lib = load()
        n, m = At.rows, A.rows
        B = _lanes(rhs, "rhs")
        _check(rhs, "rhs", device, dtype, (m, B))
        _check(invd, "invd", device, dtype, (m, B))
        _check(resscale, "resscale", device, dtype, (m, B))
        _check(tol, "tol", device, dtype, B)
        _check(W, "W", device, dtype, (n + m, B))
        e = lambda *s: torch.empty(s, dtype=dtype, device=device)  # noqa: E731
        self.At, self.A, self.W = At, A, W
        self.m, self.B = m, B
        self.R = rhs.clone()
        self.Y, self.S, self.CS, self.D, self.CD = (e(m, B) for _ in range(5))
        self.plan = normal_plan_of(At, A)
        # the fused K6 never writes U: 98 MB in f32 at m = 20 000,
        # n = 96 002, B = 256
        self.U = None if self.plan.fused else e(n, B)
        self.npa = lane_blocks(m, B)
        self.pa = e(2, B, self.npa)     # lane-major (csrc/batch_cr.cu)
        self.pc = e(*self.plan.partials_shape(W, self.S, self.CS))
        # zeros made on the host: the state is copied up, not filled by a
        # device kernel
        self.state = torch.zeros(int(lib.ipxt_bcr_state_len(B)),
                                 dtype=dtype).to(device)
        self._keep = (invd, resscale, tol)   # alive while the loop runs
        self._fn = getattr(lib, f"ipxt_bcr_step_{_SUFFIX[dtype]}")
        self._args = (invd.data_ptr(), resscale.data_ptr(), tol.data_ptr(),
                      self.Y.data_ptr(), self.R.data_ptr(),
                      self.S.data_ptr(), self.CS.data_ptr(),
                      self.D.data_ptr(), self.CD.data_ptr(),
                      self.pa.data_ptr(), self.npa, self.pc.data_ptr(),
                      self.pc.shape[0], self.state.data_ptr(),
                      _stream(device))

    def launch(self, phase: int, k: int, maxiter: int) -> None:
        err = self._fn(phase, self.m, self.B, k, maxiter, *self._args)
        _raise_if(err, f"batched_cr_step phase {phase}")
        LAUNCHES["batched_cr_step"] += 1

    def normal_apply(self) -> None:
        """CS = C S and the partials of S.CS, through K6."""
        normal_apply_batched(self.At, self.A, self.W, self.S, out=self.CS,
                             U=self.U, partials=self.pc, state=self.state)

    def done(self) -> bool:
        trace.count("host_syncs")
        return bool(self.state[self.DONE].item())

    def result(self):
        """(Y on the card, trips)."""
        trace.count("host_syncs")
        return self.Y, int(self.state[self.IT].item())


# -- K8 / K9 ------------------------------------------------------------------
def _check_step(arrays, fins, device, dtype, nm, B) -> None:
    for name, t in arrays.items():
        _check(t, name, device, dtype, (nm, B))
    for name, t in fins.items():
        _check(t, name, device, torch.bool, nm)


def step_batch(XL, XU, ZL, ZU, DXL, DXU, DZL, DZU, finl, finu):
    """K8: per-lane (maxp, maxd), the largest steps to the boundary of the
    (XL, XU) and (ZL, ZU) pairs, capped at 1."""
    device, dtype = _device_of(XL), XL.dtype
    nm, B = XL.shape[0], _lanes(XL, "XL")
    arrays = dict(XL=XL, XU=XU, ZL=ZL, ZU=ZU, DXL=DXL, DXU=DXU, DZL=DZL,
                  DZU=DZU)
    _check_step(arrays, dict(finl=finl, finu=finu), device, dtype, nm, B)
    npb = lane_blocks(nm, B)
    e = lambda *s: torch.empty(s, dtype=dtype, device=device)  # noqa: E731
    partials, maxp, maxd = e(2, npb, B), e(B), e(B)
    fn = getattr(load(), f"ipxt_step_batch_{_SUFFIX[dtype]}")
    err = fn(nm, B, *(t.data_ptr() for t in arrays.values()),
             finl.data_ptr(), finu.data_ptr(), partials.data_ptr(), npb,
             maxp.data_ptr(), maxd.data_ptr(), _stream(device))
    _raise_if(err, "step_batch")
    LAUNCHES["step_batch"] += 1
    return maxp, maxd


def muaff(XL, XU, ZL, ZU, DXL, DXU, DZL, DZU, finl, finu, maxp, maxd,
          num_fin: int):
    """K8's second kernel: per-lane mean complementarity after the affine
    step, (sum of the finite (X + maxp DX)(Z + maxd DZ)) / max(num_fin, 1)."""
    device, dtype = _device_of(XL), XL.dtype
    nm, B = XL.shape[0], _lanes(XL, "XL")
    arrays = dict(XL=XL, XU=XU, ZL=ZL, ZU=ZU, DXL=DXL, DXU=DXU, DZL=DZL,
                  DZU=DZU)
    _check_step(arrays, dict(finl=finl, finu=finu), device, dtype, nm, B)
    _check(maxp, "maxp", device, dtype, B)
    _check(maxd, "maxd", device, dtype, B)
    npb = lane_blocks(nm, B)
    partials = torch.empty((npb, B), dtype=dtype, device=device)
    out = torch.empty(B, dtype=dtype, device=device)
    fn = getattr(load(), f"ipxt_muaff_{_SUFFIX[dtype]}")
    err = fn(nm, B, *(t.data_ptr() for t in arrays.values()),
             finl.data_ptr(), finu.data_ptr(), maxp.data_ptr(),
             maxd.data_ptr(), float(num_fin), partials.data_ptr(), npb,
             out.data_ptr(), _stream(device))
    _raise_if(err, "muaff")
    LAUNCHES["step_batch"] += 1
    return out


def ipm_update(X, XL, XU, Y, ZL, ZU, DX, DXL, DXU, DY, DZL, DZU, alphap,
               alphad, done, finl, finu) -> None:
    """K9: the masked iterate update of a batched IPM step, in place."""
    device, dtype = _device_of(X), X.dtype
    nm, B = X.shape[0], _lanes(X, "X")
    _lanes(Y, "Y")
    m = Y.shape[0]
    _check_step(dict(X=X, XL=XL, XU=XU, ZL=ZL, ZU=ZU, DX=DX, DXL=DXL,
                     DXU=DXU, DZL=DZL, DZU=DZU), dict(finl=finl, finu=finu),
                device, dtype, nm, B)
    _check(Y, "Y", device, dtype, (m, B))
    _check(DY, "DY", device, dtype, (m, B))
    _check(alphap, "alphap", device, dtype, B)
    _check(alphad, "alphad", device, dtype, B)
    _check(done, "done", device, torch.bool, B)
    fn = getattr(load(), f"ipxt_ipm_update_{_SUFFIX[dtype]}")
    err = fn(nm, m, B, *(t.data_ptr() for t in (
        X, XL, XU, Y, ZL, ZU, DX, DXL, DXU, DY, DZL, DZU, alphap, alphad,
        done, finl, finu)), _stream(device))
    _raise_if(err, "ipm_update")
    LAUNCHES["ipm_update"] += 1


# -- K10-K13: the rest of the batched IPM step, float64 -----------------------
F64 = torch.float64
# rows of the per-lane outputs of K10 and K13
PROLOGUE_ROWS = ("mu", "pobj", "dobj", "gap", "pres", "dres", "regval", "tol")
START_ROWS = ("xshift", "fixup", "zshift", "xsum", "zsum", "mu", "hx", "hz")


def red_blocks(rows: int, B: int) -> int:
    """Row blocks of a reducing pass of K10 or K13: the last axis of its
    partials."""
    return int(load().ipxt_red_blocks(rows, B))


def _check_f64(device, shapes: dict, masks: dict = None) -> None:
    """Checks float64 arrays {name: (tensor, shape)} and bool masks."""
    for name, (t, shape) in shapes.items():
        _check(t, name, device, F64, shape)
    for name, (t, shape) in (masks or {}).items():
        _check(t, name, device, torch.bool, shape)


def _dims(X, Y):
    """(n, m, B) of an iterate with X of shape (n + m, B), Y (m, B)."""
    _lanes(Y, "Y")
    nm, B, m = X.shape[0], _lanes(X, "X"), Y.shape[0]
    return nm - m, m, B


def ipm_prologue(AX, ATY, X, XL, XU, Y, ZL, ZU, done, bT, cT, lb, ub, finl,
                 finu, feas_b, feas_c, opt_tol, kkt_tol, num_fin: int):
    """K10: the residuals, the convergence test and the KKT weights of one
    step from the K5 products AX = A X[:n] and ATY = A' Y. Returns (RB, RC,
    RL, RU, W, resscale, lane, done): lane has the rows PROLOGUE_ROWS of B
    values, done the lanes done after this test."""
    device = _device_of(X)
    n, m, B = _dims(X, Y)
    nm = n + m
    _check_f64(device, dict(
        AX=(AX, (m, B)), ATY=(ATY, (n, B)), X=(X, (nm, B)), XL=(XL, (nm, B)),
        XU=(XU, (nm, B)), Y=(Y, (m, B)), ZL=(ZL, (nm, B)), ZU=(ZU, (nm, B)),
        bT=(bT, (m, B)), cT=(cT, (nm, B)), lb=(lb, nm), ub=(ub, nm)),
        dict(finl=(finl, nm), finu=(finu, nm), done=(done, B)))
    e = lambda *s: torch.empty(s, dtype=F64, device=device)  # noqa: E731
    RB, RC, RL, RU, W, rs = (e(m, B), e(nm, B), e(nm, B), e(nm, B),
                             e(nm, B), e(m, B))
    nblk = red_blocks(nm, B)
    partials, lane = e(11, B, nblk), e(len(PROLOGUE_ROWS), B)
    done_out = torch.empty(B, dtype=torch.bool, device=device)
    err = _lib.ipxt_ipm_prologue_f64(
        n, m, B, *(t.data_ptr() for t in (
            AX, ATY, X, XL, XU, Y, ZL, ZU, bT, cT, lb, ub, finl, finu, done,
            RB, RC, RL, RU, W, rs, partials)), nblk, lane.data_ptr(),
        done_out.data_ptr(), float(feas_b), float(feas_c), float(opt_tol),
        float(kkt_tol), float(max(num_fin, 1)), _stream(device))
    _raise_if(err, "ipm_prologue")
    LAUNCHES["ipm_prologue"] += 1
    return RB, RC, RL, RU, W, rs, lane, done_out


def lane_mu(XL, XU, ZL, ZU, finl, finu, num_fin: int) -> torch.Tensor:
    """K10's complementarity alone: per-lane mu of an (n + m, B) state."""
    device = _device_of(XL)
    nm, B = XL.shape[0], _lanes(XL, "XL")
    _check_f64(device, dict(XL=(XL, (nm, B)), XU=(XU, (nm, B)),
                            ZL=(ZL, (nm, B)), ZU=(ZU, (nm, B))),
               dict(finl=(finl, nm), finu=(finu, nm)))
    nblk = red_blocks(nm, B)
    partials = torch.empty((2, B, nblk), dtype=F64, device=device)
    out = torch.empty(B, dtype=F64, device=device)
    err = load().ipxt_lane_mu_f64(
        nm, B, *(t.data_ptr() for t in (XL, XU, ZL, ZU, finl, finu,
                                        partials)), nblk, out.data_ptr(),
        float(max(num_fin, 1)), _stream(device))
    _raise_if(err, "lane_mu")
    LAUNCHES["ipm_prologue"] += 1
    return out


def newton_rhs(op_A, RC, RL, RU, XL, XU, ZL, ZU, W, RB, finl, finu,
               sigma=None, mu=None, DXL=None, DZL=None, DXU=None, DZU=None):
    """K11: SL, SU, RHS1 and the normal right-hand side rhs = A (W RHS1)[:n]
    + (W RHS1)[n:] - RB, the product by K5. Predictor without `sigma`;
    the corrector takes sigma and mu (B,) and the predictor's DXL, DZL, DXU,
    DZU. Returns (SL, SU, RHS1, rhs)."""
    device = _device_of(RC)
    n, m, B = _dims(RC, RB)
    nm = n + m
    arrays = dict(RC=RC, RL=RL, RU=RU, XL=XL, XU=XU, ZL=ZL, ZU=ZU, W=W)
    corr = dict(DXL=DXL, DZL=DZL, DXU=DXU, DZU=DZU)
    if sigma is not None:
        arrays.update(corr)
    elif any(t is not None for t in corr.values()) or mu is not None:
        raise ValueError("the predictor takes no corrector terms")
    shapes = {k: (t, (nm, B)) for k, t in arrays.items()}
    shapes["RB"] = (RB, (m, B))
    if sigma is not None:
        shapes.update(sigma=(sigma, B), mu=(mu, B))
    _check_f64(device, shapes, dict(finl=(finl, nm), finu=(finu, nm)))
    _check_operand(op_A, device, F64)
    if (op_A.rows, op_A.cols) != (m, n):
        raise ValueError(f"op_A is {op_A.rows} x {op_A.cols}, expected "
                         f"{m} x {n}")
    e = lambda *s: torch.empty(s, dtype=F64, device=device)  # noqa: E731
    SL, SU, RHS1, WR, rhs = e(nm, B), e(nm, B), e(nm, B), e(nm, B), e(m, B)
    err = _lib.ipxt_newton_rhs_f64(
        n, m, B, *(_ptr(t) for t in (RC, RL, RU, XL, XU, ZL, ZU, W, finl,
                                     finu, sigma, mu, DXL, DZL, DXU, DZU, SL,
                                     SU, RHS1, WR)), _stream(device))
    _raise_if(err, "newton_rhs")
    AWR = csr_spmm(op_A, WR[:n])
    err = _lib.ipxt_normal_rhs_f64(n, m, B, AWR.data_ptr(), WR.data_ptr(),
                                   RB.data_ptr(), rhs.data_ptr(),
                                   _stream(device))
    _raise_if(err, "normal_rhs")
    LAUNCHES["newton_rhs"] += 1
    return SL, SU, RHS1, rhs


def newton_recover(op_A, ATDY, DY, RHS1, W, RB, RC, RL, RU, SL, SU, XL, XU,
                   ZL, ZU, finl, finu):
    """K12: the direction from the CR's DY and the K5 product ATDY = A' DY,
    with A DX[:n] by K5 between its two passes. Returns (DX, DXL, DXU, DYn,
    DZL, DZU), DYn = -DY."""
    device = _device_of(RC)
    n, m, B = _dims(RC, RB)
    nm = n + m
    shapes = {k: (t, (nm, B)) for k, t in dict(
        RHS1=RHS1, W=W, RC=RC, RL=RL, RU=RU, SL=SL, SU=SU, XL=XL, XU=XU,
        ZL=ZL, ZU=ZU).items()}
    shapes.update(ATDY=(ATDY, (n, B)), DY=(DY, (m, B)), RB=(RB, (m, B)))
    _check_f64(device, shapes, dict(finl=(finl, nm), finu=(finu, nm)))
    _check_operand(op_A, device, F64)
    if (op_A.rows, op_A.cols) != (m, n):
        raise ValueError(f"op_A is {op_A.rows} x {op_A.cols}, expected "
                         f"{m} x {n}")
    e = lambda *s: torch.empty(s, dtype=F64, device=device)  # noqa: E731
    DX, DXL, DXU, DZL, DZU, DYn = (e(nm, B), e(nm, B), e(nm, B), e(nm, B),
                                   e(nm, B), e(m, B))
    err = _lib.ipxt_newton_dx_f64(n, m, B, ATDY.data_ptr(), RHS1.data_ptr(),
                                  W.data_ptr(), DX.data_ptr(),
                                  _stream(device))
    _raise_if(err, "newton_dx")
    ADX = csr_spmm(op_A, DX[:n])
    err = _lib.ipxt_newton_recover_f64(
        n, m, B, *(t.data_ptr() for t in (
            ATDY, DY, RB, RC, RL, RU, SL, SU, XL, XU, ZL, ZU, finl, finu, ADX,
            DX, DXL, DXU, DYn, DZL, DZU)), _stream(device))
    _raise_if(err, "newton_recover")
    LAUNCHES["newton_recover"] += 1
    return DX, DXL, DXU, DYn, DZL, DZU


def starting_point(X0, ATDY, DY, ATY, Y, cT, lb, ub, finl, finu, rho,
                   cooperative: bool = True):
    """K13: the starting point's masked passes from the clamped zero point
    X0, the primal solve's DY and A' DY and the dual solve's Y and A' Y.
    Returns (X, XL, XU, Y, ZL, ZU, lane), lane with the rows START_ROWS.
    One cooperative launch that writes the iterate once; cooperative=False
    runs the seven launches of the earlier form instead, bit for bit the
    same (chip_smoke.py and the card tests hold the two together)."""
    device = _device_of(X0)
    n, m, B = _dims(X0, Y)
    nm = n + m
    _check_f64(device, dict(
        X0=(X0, (nm, B)), ATDY=(ATDY, (n, B)), DY=(DY, (m, B)),
        ATY=(ATY, (n, B)), Y=(Y, (m, B)), cT=(cT, (nm, B)), lb=(lb, nm),
        ub=(ub, nm)), dict(finl=(finl, nm), finu=(finu, nm)))
    e = lambda *s: torch.empty(s, dtype=F64, device=device)  # noqa: E731
    X, XL, XU, ZL, ZU, Yo = (e(nm, B), e(nm, B), e(nm, B), e(nm, B),
                             e(nm, B), e(m, B))
    nblk = red_blocks(nm, B)
    partials, lane = e(4, B, nblk), e(len(START_ROWS), B)
    args = (n, m, B, *(t.data_ptr() for t in (
        X0, ATDY, DY, ATY, Y, cT, lb, ub, finl, finu, X, XL, XU, Yo, ZL, ZU,
        partials)), nblk, lane.data_ptr(), float(rho), 1.0 - float(rho))
    if cooperative:
        err = _lib.ipxt_starting_point_coop_f64(*args, _stream(device))
    else:
        err = _lib.ipxt_starting_point_f64(*args, _stream(device))
    _raise_if(err, "starting_point")
    LAUNCHES["starting_point"] += 1
    return X, XL, XU, Yo, ZL, ZU, lane


# -- K14-K16: the sharded solves, float64 -------------------------------------
def block_sum(parts: torch.Tensor, scale=None, out=None, state=None):
    """K14: out = scale * (((parts[0] + parts[1]) + parts[2]) + ...), the
    blocks summed in order, for parts of shape (P, *shape) and scale and
    out of `shape`; without scale, the plain sum. `state` is a CR loop's:
    once it says done, the launch returns at once."""
    device = _device_of(parts)
    shape = tuple(parts.shape[1:])
    _check(parts, "parts", device, F64, (parts.shape[0],) + shape)
    if scale is not None:
        _check(scale, "scale", device, F64, shape)
    out = torch.empty(shape, dtype=F64, device=device) if out is None else out
    _check(out, "out", device, F64, shape)
    if state is not None:
        _check_state(state, device)
    err = load().ipxt_block_sum_f64(
        parts.shape[0], out.numel(), parts.data_ptr(), _ptr(scale),
        out.data_ptr(), _ptr(state), _stream(device))
    _raise_if(err, "block_sum")
    LAUNCHES["block_sum"] += 1
    return out


def block_spmv_sum(op, x: torch.Tensor, scale=None, out=None, state=None):
    """K14v: out[i] = scale[i] * (((s_0 + s_1) + ...) + s_{P-1}), s_p the
    sum over row i's entries of block p of op (the split layout of
    ops/spmv.py) of vals * x (csrc/nnt.cu): for `op` the whole A' split at
    the row blocks' bounds, the scaled psum of the blocks' A_p' v_p in one
    launch. `state` is a CR loop's: once it says done, the launch returns at
    once."""
    device = _device_of(x)
    _check_split(op, device)
    _check(x, "x", device, F64, op.cols)
    if scale is not None:
        _check(scale, "scale", device, F64, op.rows)
    out = torch.empty(op.rows, dtype=F64, device=device) if out is None \
        else out
    _check(out, "out", device, F64, op.rows)
    if state is not None:
        _check_state(state, device)
    err = _lib.ipxt_block_spmv_sum_f64(
        *_op_args(op), op.P, op.inner_ptr, x.data_ptr(), _ptr(scale),
        out.data_ptr(), _ptr(state), _stream(device))
    _raise_if(err, "block_spmv_sum")
    LAUNCHES["block_spmv_sum"] += 1
    return out


def _check_state(state, device) -> None:
    """A CR loop's state as the block products read it: float64, at least
    the scalar slots of common.cuh."""
    n = int(_lib.ipxt_cr_state_len())
    if state.device != device or state.dtype != F64 or state.numel() < n \
            or not state.is_contiguous():
        raise ValueError("state is not a float64 CR state on " + str(device))


def _offsets(values, device) -> torch.Tensor:
    """(P + 1) int64 prefix offsets of `values`, on the card."""
    off = [0]
    for v in values:
        off.append(off[-1] + int(v))
    return torch.tensor(off, dtype=torch.int64).to(device)


def _slices(t: torch.Tensor, sizes) -> list:
    """Consecutive slices of `t` along its first axis, of the given sizes."""
    out, r0 = [], 0
    for k in sizes:
        out.append(t[r0:r0 + k])
        r0 += k
    return out


def block_layout(rows, vecs) -> tuple:
    """(row_off, blk_off) of the block products' one launch over P row
    blocks of rows[p] rows summed with vecs[p] lanes a row (k1_lanes of the
    block): the prefix offsets of the rows and of the CUDA blocks, block p
    taking as many as its own K1 launch would, which are also the offsets
    of its partials."""
    row_off, blk_off = [0], [0]
    for r, vec in zip(rows, vecs):
        row_off.append(row_off[-1] + int(r))
        blk_off.append(blk_off[-1] + _blocks_for(int(r), THREADS // vec))
    return row_off, blk_off


class BlockSpmvPlan:
    """K1 over the P row blocks of a row-blocked vector apply in one launch
    (csrc/spmv.cu): out_p = A_p u + W_slack_p v_p into block p's rows of
    out, and with `partials` the block partials of v_p.out_p in the slots
    that P separate K1 launches would write (block_layout), float64. `A` are
    the blocks' CSR operands (A_p with the block's rows and n columns, at
    most MAX_SPLIT of them); u (n,), out, W_slack and v (m,); `state` a CR
    loop's, once it says done the launch returns at once. The operands and
    buffers are checked, the argument tuple packed and the current stream
    taken once, here; launch() makes one ctypes call. Each block keeps its
    own lanes per row (k1_lanes), so out and partials equal those of P
    csr_spmv launches bit for bit."""

    def __init__(self, A, u, out, W_slack, v, partials=None, state=None):
        device = _device_of(u)
        P, n, rows = len(A), u.numel(), [op.rows for op in A]
        if not 1 <= P <= MAX_SPLIT:
            raise ValueError(f"the block products take 1 to {MAX_SPLIT} "
                             f"blocks, got {P}")
        for op in A:
            _check_operand(op, device, F64)
            if op.cols != n:
                raise ValueError(f"a block has {op.cols} columns, u {n}")
        m, vecs = sum(rows), [k1_lanes(op) for op in A]
        _check_f64(device, dict(u=(u, n), out=(out, m), W_slack=(W_slack, m),
                                v=(v, m)))
        row_off, blk_off = block_layout(rows, vecs)
        if partials is not None:
            _check(partials, "partials", device, F64, blk_off[-1])
        load()
        if state is not None:
            _check_state(state, device)
        # host arrays the C entry reads during each call
        self._host = (np.array(row_off, dtype=np.int64),
                      np.array(blk_off, dtype=np.int64),
                      np.array(vecs, dtype=np.int32),
                      *(np.array([getattr(op, k).data_ptr() for op in A],
                                 dtype=np.uint64)
                        for k in ("indptr", "indices", "vals")))
        self._keep = (A, u, out, W_slack, v, partials, state)
        # the block products' operands as the C entries take them, which
        # K15's cooperative solve takes too
        self.host_args = tuple(a.ctypes.data for a in self._host)
        self._args = (P, *self.host_args,
                      u.data_ptr(), W_slack.data_ptr(), v.data_ptr(),
                      out.data_ptr(), _ptr(partials), _ptr(state),
                      _stream(device))

    def launch(self) -> None:
        _raise_if(_lib.ipxt_block_spmv_f64(*self._args), "block products")
        LAUNCHES["csr_spmv"] += 1


def _block_products(prod, A, u, out, W_slack, v, partials, state) -> None:
    """The second pass of a row-blocked apply in P launches: A_p u +
    W_slack_p v_p by `prod` (K5, or K1 where the tests compare BlockSpmvPlan
    with it) into the block's rows of out, with the block's partials of
    v.out into partials[p] if given."""
    rows = [op.rows for op in A]
    partials = [None] * len(A) if partials is None else partials
    for op, o_p, w_p, v_p, pc in zip(A, _slices(out, rows),
                                     _slices(W_slack, rows),
                                     _slices(v, rows), partials):
        prod(op, u, out=o_p, addw=w_p, addv=v_p, partials=pc, state=state)


def block_normal_apply(At, A, W_struct, W_slack, v, out=None):
    """out = C v over row blocks for v of shape (m,), in two launches: u =
    W_struct * sum_p A_p' v_p by one K14v launch on `At`, the whole A' split
    at the row blocks' bounds, then the P block products A_p u + W_slack_p
    v_p by one K1 launch (BlockSpmvPlan). `A` are the blocks' operands (A_p
    with the block's rows); out is allocated here if not given."""
    if At.P != len(A):
        raise ValueError(f"At is split into {At.P} blocks, A into {len(A)}")
    out = torch.empty_like(v) if out is None else out
    u = block_spmv_sum(At, v, W_struct)
    BlockSpmvPlan(A, u, out, W_slack, v).launch()
    return out


def block_normal_apply_batched(At, A, W_struct, W_slack, V, out=None,
                               parts=None, U=None, partials=None,
                               state=None):
    """out = C V over row blocks for V of shape (m, B), in the three-stage
    form's 2P + 1 launches: A_p' V_p by K5 into parts[p], their ordered sum
    scaled by W_struct by K14 into U, then the block products of
    _block_products by K5. `At` and `A` are the blocks' operands (A_p' with
    n rows, A_p with the block's rows); `partials` the blocks' slices;
    scratch not given is allocated here. BlockNormalBatchedPlan runs it where
    A's columns are long, and for the comparisons with its fused form."""
    rows = [op.rows for op in A]
    n, B = W_struct.shape[0], _lanes(V, "V")
    e = lambda *s: torch.empty(s, dtype=F64, device=V.device)  # noqa: E731
    out = e(*V.shape) if out is None else out
    parts = e(len(A), n, B) if parts is None else parts
    for op, v_p, part in zip(At, _slices(V, rows), parts):
        csr_spmm(op, v_p, out=part, state=state)
    U = block_sum(parts, W_struct, out=U, state=state)
    _block_products(csr_spmm, A, U, out, W_slack, V, partials, state)
    return out


def _ptrs(ops, key: str) -> np.ndarray:
    """The device pointers of one array of each operand, as a host array
    that a C entry reads."""
    return np.array([getattr(op, key).data_ptr() for op in ops],
                    dtype=np.uint64)


class BlockNormalBatchedPlan:
    """K16's normal apply bound to one row-blocked operator, float64: out =
    A (W_struct * (A' V)) + W_slack * V over the P row blocks for V of shape
    (m, B), with the per-block, per-lane partials of the column dots V.out,
    laid out as the blocks' K5 launches lay them out (block p's
    lane_blocks(rows_p, B // vw) rows, end to end). `At_split` is the whole
    A' split at the row blocks' bounds, `At` and `A` the blocks' A_p' and
    A_p. The operands are checked, the form picked (takes_fused: one fused
    launch, csrc/sharded.cu, that writes neither the (P, n, B) parts nor the
    (n, B) U; else the three-stage form, block_normal_apply_batched) and the
    C arguments packed once, here; the two forms agree bit for bit. A failed
    launch raises; nothing retries it in the other form."""

    def __init__(self, At_split, At, A):
        P = len(A)
        if not 1 <= P <= MAX_SPLIT or len(At) != P or At_split.P != P:
            raise ValueError(f"{P} row blocks A_p, {len(At)} A_p' and an A' "
                             f"split into {At_split.P}: not one operator of "
                             f"1 to {MAX_SPLIT} blocks")
        device = _device_of(A[0].vals)
        _check_split(At_split, device)
        for op in (*At, *A):
            _check_operand(op, device, F64)
        rows = [op.rows for op in A]
        row_off = np.cumsum([0] + rows).astype(np.int64)
        n = At_split.rows
        if (At_split.cols != row_off[-1] or any(op.cols != n for op in A)
                or not np.array_equal(At_split.bounds, row_off)):
            raise ValueError("A' is not split at the row blocks' bounds")
        load()
        self.At, self.A, self.device = At, A, device
        self.n, self.m, self.rows = n, int(row_off[-1]), rows
        self.fused = self.takes_fused(At_split)
        # host arrays the C entry reads during each call
        self._host = (row_off, *(_ptrs(A, k) for k in
                                 ("indptr", "indices", "vals")))
        self._keep = (At_split,)        # alive while the pointers are used
        self._t = (At_split.indptr.data_ptr(), At_split.indices.data_ptr(),
                   At_split.vals.data_ptr())
        self._grids = {}                # (B, vw): blk_off of the K5 grids

    @staticmethod
    def takes_fused(At_split) -> bool:
        """The plan's rule, K6's (k6_fused) on the whole A': the fused launch
        where the sum of A's squared column lengths is at most
        K6_FUSED_RATIO nnz(A), which it gathers."""
        return k6_fused(At_split)

    def width(self, W_struct, W_slack, V, out, partials=None) -> int:
        """Lanes a thread takes (spmm_width), the blocks' K5 launches' and
        the fused launch's: V, W_slack, out and the partials are read in
        both, and their row blocks' slices are aligned when B is even."""
        return spmm_width(V.shape[1], F64, V, W_struct, W_slack, out,
                          partials)

    def partials_rows(self, B: int, vw: int) -> list:
        """Rows of each block's partials at B lanes and width vw."""
        return [lane_blocks(r, B // vw) for r in self.rows]

    def __call__(self, W_struct, W_slack, V, out=None, partials=None,
                 state=None, parts=None, U=None, fused=None) -> torch.Tensor:
        """out = C V, into `out` if given, with the blocks' partials of
        V.out in `partials` ((sum of partials_rows, B)) if given. `fused`
        overrides the plan's form (chip_smoke.py and the card tests time
        and hold the two against each other); `parts` and `U` are the
        three-stage form's scratch, allocated if not given. `state` is a CR
        loop's: once it says done, the launches return at once. The fused
        launch counts as K16's."""
        n, m, device = self.n, self.m, self.device
        B = _lanes(V, "V")
        out = torch.empty((m, B), dtype=F64, device=device) \
            if out is None else out
        _check_f64(device, dict(W_struct=(W_struct, (n, B)),
                                W_slack=(W_slack, (m, B)), V=(V, (m, B)),
                                out=(out, (m, B))))
        vw = self.width(W_struct, W_slack, V, out, partials)
        npc = self.partials_rows(B, vw)
        if partials is not None:
            _check(partials, "partials", device, F64, (sum(npc), B))
        if state is not None:
            _check(state, "state", device, F64,
                   int(_lib.ipxt_bcr_state_len(B)))
        if not (self.fused if fused is None else fused):
            return block_normal_apply_batched(
                self.At, self.A, W_struct, W_slack, V, out, parts, U,
                None if partials is None else _slices(partials, npc), state)
        if (B, vw) not in self._grids:
            self._grids[(B, vw)] = np.cumsum([0] + npc).astype(np.int64)
        row_off, indptr, indices, vals = self._host
        err = _lib.ipxt_block_normal_batched_f64(
            len(self.rows), row_off.ctypes.data,
            self._grids[(B, vw)].ctypes.data, indptr.ctypes.data,
            indices.ctypes.data, vals.ctypes.data, B, *self._t,
            V.data_ptr(), W_struct.data_ptr(), W_slack.data_ptr(),
            out.data_ptr(), _ptr(partials), _ptr(state), vw, _stream(device))
        _raise_if(err, "block normal apply (fused)")
        LAUNCHES["sharded_batched_cr_step"] += 1
        return out


def block_plan_of(At_split, At, A) -> BlockNormalBatchedPlan:
    """The BlockNormalBatchedPlan of a row-blocked operator, built at its
    first use and kept on `At_split` (keyed by its blocks' operands)."""
    plans = At_split.__dict__.setdefault("_k16_plans", {})
    key = (id(At[0]), id(A[0]))
    if key not in plans:
        plans[key] = BlockNormalBatchedPlan(At_split, At, A)
    return plans[key]


class _ShardedStep:
    """What the step objects of K15 and K16 share, allocated once per solve
    on the card of `rhs`: the loop's vectors of rhs's shape (`r` starts as
    a copy of rhs), the partials at their one-card layout over all P row
    blocks (`rows`: `pa` of shape `pa_shape`, one partial block per K15-K16
    reduction block `nblk[p]` of each row block; `pc`, the block products'
    partials, `npc[p]` rows per row block), the prefix offsets of the rows
    and of both partials, and the state, zeros of `state_len`.

    The host-issued form (_host_issued) runs INIT, the normal apply, START,
    then TRIP (the passes of one trip, the normal apply where APPLY stands)
    until the state says done, which it reads at STOP every `poll` trips.

    Over a mesh of processes (parallel/mesh.py) a rank runs the same loop
    on row block `rank.i` alone; `rank` is its link to the ranks of its row
    group: `rank.rows`, the rows of all P blocks, and `rank.gather(t,
    what)`, every rank's flat t in rank order, (P, t.numel()) on t's card
    or on the host. The other blocks' partials then come from the other
    ranks (_share), and the state is read every trip, since the ranks'
    gathers go on in lockstep until the loop ends. On one card `rank` is
    None and nothing is exchanged."""

    APPLY, STOP = -1, -2
    IT, DONE = 3, 5                 # state slots (csrc/common.cuh)
    POLL = 5                        # trips between reads of done, one card

    def __init__(self, rows, W_struct, W_slack, rhs, nblk, npc, pa_shape,
                 state_len, rank=None):
        device = _device_of(rhs)
        lanes = tuple(rhs.shape[1:])
        e = lambda *s: torch.empty(s, dtype=F64, device=device)  # noqa: E731
        self.rows, self.P, self.m = list(rows), len(rows), rhs.shape[0]
        self.device, self.rank = device, rank
        self.own = (0, self.P) if rank is None else (rank.i, rank.i + 1)
        self.poll = self.POLL if rank is None else 1
        self._sends = {}
        self.W_struct, self.W_slack = W_struct, W_slack
        self.r = rhs.clone()
        self.y, self.s, self.cs, self.d, self.cd = (e(self.m, *lanes)
                                                    for _ in range(5))
        self.nblk_of, self.npc = list(nblk), list(npc)
        self.nblk = sum(nblk)
        self.pa, self.pc = e(*pa_shape), e(sum(npc), *lanes)
        self._off = (_offsets(rows, device), _offsets(nblk, device),
                     _offsets(npc, device))
        # zeros made on the host: the state is copied up, not filled by a
        # device kernel
        self.state = torch.zeros(state_len, dtype=F64).to(device)
        self._tail = (self.y.data_ptr(), self.r.data_ptr(),
                      self.s.data_ptr(), self.cs.data_ptr(),
                      self.d.data_ptr(), self.cd.data_ptr(),
                      self.pa.data_ptr(), self.nblk, self.pc.data_ptr(),
                      self.state.data_ptr())
        self._stream = _stream(device)

    def _host_issued(self, maxiter: int, tol: float) -> None:
        """Runs the loop from the start, the host issuing every pass and
        apply; trip `maxiter` always stops, so the loop ends by trip
        maxiter + 1."""
        self.launch(self.INIT, 0, maxiter, tol)
        self.normal_apply()
        self.launch(self.START, 0, maxiter, tol)
        k = 0
        while True:
            for phase in self.TRIP:
                if phase == self.APPLY:
                    self.normal_apply()
                elif phase == self.STOP:
                    if ((k + 1) % self.poll == 0 or k >= maxiter) and bool(
                            self.state[self.DONE].item()):
                        return
                else:
                    self.launch(phase, k, maxiter, tol)
            k += 1

    def _share(self, dst: torch.Tensor, dim: int, sizes, what: str,
               src: torch.Tensor = None) -> None:
        """On a mesh, dst (all of a contiguous buffer) holding every rank's
        part end to end along `dim` (rank q's sizes[q] long) in rank order,
        from this rank's part: `src`, by default its own slice of dst; one
        gather."""
        if self.rank is None:
            return
        i = self.rank.i
        if what not in self._sends:     # offsets and a send buffer, once
            off = np.cumsum([0] + list(sizes)).tolist()
            own = dst.narrow(dim, off[i], sizes[i]) if src is None else src
            inner = own.numel() // sizes[i]
            self._sends[what] = (off, inner, torch.zeros(
                max(sizes) * inner, dtype=F64, device=self.device))
        off, inner, send = self._sends[what]
        if src is None:
            src = dst.narrow(dim, off[i], sizes[i])
        send[:src.numel()] = src.reshape(-1)
        G = self.rank.gather(send, what)
        pieces = []
        for q, k in enumerate(sizes):
            shape = list(src.shape)
            shape[dim] = k
            pieces.append(G[q, :k * inner].view(shape))
        # one copy to the card, of the pieces laid end to end where G is
        dst.copy_(torch.cat(pieces, dim))

    def _gather_parts(self, part: torch.Tensor) -> torch.Tensor:
        """The (P, *part.shape) of every rank's part, on the card."""
        self.parts.copy_(self.rank.gather(part, "parts").view(
            self.parts.shape))
        return self.parts


class ShardedCrStep(_ShardedStep):
    """K15: one row-blocked CR solve (csrc/sharded.cu) on one card, for
    ShardedDiagCR (`ladder`, the scaled norm with `resscale`) and
    sharded_cr_solve (no ladder, resscale None: the unscaled norm).
    W_struct (n,), W_slack, invd, resscale and rhs (m,), float64 on the
    card; `At` the whole A' split at the row blocks' bounds (K14v's), `A`
    the blocks' A_p. One solve an object.

    solve() runs the whole loop, each trip's normal apply inside (K14v's
    split sum and the block products through K1's row body), in one
    cooperative launch; solve(cooperative=False) runs the host-issued
    passes and the apply as a K14v and a K1 launch (BlockSpmvPlan), which
    the solvers never ask for on one card: the card tests and chip_smoke.py
    hold the two forms bit for bit.

    On a mesh rank (`rank`, _ShardedStep; `rank.vecs` the K1 lanes a row of
    all P blocks) `A` is [A_i] and `At` A_i' at the whole A''s lanes a row
    (parallel/mesh.py lane_aligned, K14v at P = 1); the vectors keep all m
    rows, of which the passes touch block i's, over its virtual blocks
    only. The apply is K14v on A_i', a gather of the (P, n) parts, K14's
    ordered sum scaled by W_struct and block i's K1 product; gathers fill
    the other blocks' partials after PASS_A and after the apply. The
    host-issued form only: a cooperative launch cannot hold a collective."""

    INIT, START, PASS_A, PASS_B, PASS_C = range(5)
    TRIP = (PASS_A, PASS_B, _ShardedStep.STOP, _ShardedStep.APPLY, PASS_C)
    ERR, APPLIES, RESNORM = 4, 6, 7  # state slots (csrc/sharded.cu)

    def __init__(self, At, A, W_struct, W_slack, invd, resscale, rhs,
                 ladder: bool, rank=None):
        device = _device_of(rhs)
        lib = load()
        m, n = rhs.numel(), W_struct.numel()
        shapes = dict(W_struct=(W_struct, n), W_slack=(W_slack, m),
                      invd=(invd, m), rhs=(rhs, m))
        if resscale is not None:
            shapes["resscale"] = (resscale, m)
        _check_f64(device, shapes)
        _check_split(At, device)
        if rank is None:
            rows, vecs = [op.rows for op in A], [k1_lanes(op) for op in A]
            want = (n, m, len(A))
        else:
            rows, vecs = list(rank.rows), list(rank.vecs)
            want = (n, rows[rank.i], 1)
            if len(A) != 1 or A[0].rows != rows[rank.i]:
                raise ValueError(f"a mesh rank holds block {rank.i} of "
                                 f"{rows} rows, not {[op.rows for op in A]}")
        if (At.rows, At.cols, At.P) != want or sum(rows) != m:
            raise ValueError(f"At is {At.rows} x {At.cols} in {At.P} blocks, "
                             f"not A' of row blocks {rows} of {m} rows")
        nblk = [int(lib.ipxt_scr_blocks(r)) for r in rows]
        row_off, blk_off = np.cumsum([0] + rows), np.cumsum([0] + nblk)
        _, pc_off = block_layout(rows, vecs)
        super().__init__(rows, W_struct, W_slack, rhs, nblk,
                         np.diff(pc_off).tolist(), (2 * sum(nblk),),
                         int(lib.ipxt_cr_state_len()), rank)
        p0, p1 = self.own
        r0, r1 = int(row_off[p0]), int(row_off[p1])
        c0, c1 = int(pc_off[p0]), int(pc_off[p1])
        self.vb = (int(blk_off[p0]), int(blk_off[p1]))
        self.At = At
        self.u = torch.empty(n, dtype=F64, device=device)
        self._keep = (invd, resscale)     # alive while the loop runs
        self._args = (*(t.data_ptr() for t in self._off), invd.data_ptr(),
                      _ptr(resscale), *self._tail)
        self._ladder = int(bool(ladder))
        self._products = BlockSpmvPlan(A, self.u, self.cs[r0:r1],
                                       W_slack[r0:r1], self.s[r0:r1],
                                       self.pc[c0:c1], self.state)
        if rank is None:
            self._apply = (*_op_args(At), At.inner_ptr,
                           *self._products.host_args, W_struct.data_ptr(),
                           W_slack.data_ptr(), self.u.data_ptr(),
                           self._stream)
        else:
            self._s_own = self.s[r0:r1]
            self._part = torch.empty(n, dtype=F64, device=device)
            self.parts = torch.empty((self.P, n), dtype=F64, device=device)

    def solve(self, maxiter: int, tol: float, cooperative: bool = True):
        """Runs the loop from the start and returns (y on the card,
        iterations, error code, residual norm at the stop) from one read of
        the state. The cooperative launch counts one K15 launch and adds the
        applies it ran to INSIDE, one K14v and one K1 each; a refused launch
        raises."""
        if cooperative and self.rank is not None:
            raise ValueError("a mesh rank runs the host-issued passes")
        if cooperative:
            err = _lib.ipxt_scr_solve_f64(self.m, self.P, maxiter, float(tol),
                                          self._ladder, *self._args,
                                          *self._apply)
            _raise_if(err, "sharded_cr_step (cooperative solve)")
            LAUNCHES["sharded_cr_step"] += 1
        else:
            self._host_issued(maxiter, tol)
        st = self.state.cpu()
        if cooperative:
            for name in ("block_spmv_sum", "csr_spmv"):
                INSIDE[name] += int(st[self.APPLIES])
        return (self.y, int(st[self.IT]), int(st[self.ERR]),
                float(st[self.RESNORM]))

    def normal_apply(self) -> None:
        """The host-issued form's cs = C s over the row blocks, K14v then
        the block products (BlockSpmvPlan), with the block products'
        partials of the dots s.cs per row block; on a mesh rank K14v on
        A_i', the gather of the parts and K14 between them, and a gather of
        the partials after."""
        if self.rank is None:
            block_spmv_sum(self.At, self.s, self.W_struct, out=self.u,
                           state=self.state)
        else:
            block_spmv_sum(self.At, self._s_own, out=self._part,
                           state=self.state)
            block_sum(self._gather_parts(self._part), self.W_struct,
                      out=self.u, state=self.state)
        self._products.launch()
        self._share(self.pc, 0, self.npc, "pc")

    def launch(self, phase: int, k: int, maxiter: int, tol: float) -> None:
        err = _lib.ipxt_scr_step_f64(phase, *self.vb, self.m, self.P, k,
                                     maxiter, float(tol), self._ladder,
                                     *self._args, self._stream)
        _raise_if(err, f"sharded_cr_step phase {phase}")
        LAUNCHES["sharded_cr_step"] += 1
        if phase == self.PASS_A:
            self._share(self.pa.view(2, self.nblk), 1, self.nblk_of, "pa")


def mesh_lane_width(B: int, group: int) -> tuple:
    """(vw, exact) of K5's block products on a mesh rank that holds `group`
    of a batch's B lanes: the lanes a thread takes, at which the rank's
    partials group rows as the one-card K16's over all B do (B / vw lane
    chunks) where K5 can take them, else spmm_width's; and whether the
    rank's K16 and K5 grids are the one card's, so that its loop gives the
    one-card results bit for bit: where the lane chunks split so, and the
    group holds all B lanes or at least 32 (a reducing pass's grid is
    min(B, 32) lanes wide, red_grid in csrc/common.cuh)."""
    chunks = B // spmm_width(B, F64)
    vw = group // chunks if group % chunks == 0 else 0
    kept = vw in (1, spmm_width(group, F64))
    exact = kept and (group == B or group >= 32)
    return (vw if kept else spmm_width(group, F64)), exact


class ShardedBatchedCrStep(_ShardedStep):
    """K16: one row-blocked, lane-masked batched CR solve (csrc/sharded.cu)
    on one card, for sharded_batched_cr_solve. W_struct (n, B), W_slack,
    invd and rhs (m, B), float64 on the card; tol a number; `At_split` the
    whole A' split at the row blocks' bounds, `At` and `A` the blocks' A_p'
    and A_p. The host issues the passes (_host_issued); each trip's normal
    apply goes through the operator's BlockNormalBatchedPlan, one fused
    launch where its rule allows, and only the three-stage form gets the
    (P, n, B) parts and the (n, B) U. On one card the reference's batch mesh
    axis is the column range of these arrays. One solve an object. `fused`
    overrides the plan's form, for the comparisons of chip_smoke.py and the
    card tests.

    On a mesh rank (`rank`, _ShardedStep; `rank.lanes` the whole batch's
    B) that holds row block i and a group of the lanes, `At_split` is None,
    `At` [A_i'], `A` [A_i], and W_slack, invd and rhs are the rank's (rows_i,
    B_group) and W_struct (n, B_group). The elementwise and reducing passes
    run over them as a one-block operand, writing block i's partials alone
    (`pa_local`, on one card `pa` itself); the lane passes read the
    partials of all P blocks at the one-card layout, which gathers fill.
    The apply is the three-stage form on block i, a gather of the (P, n,
    B_group) parts before K14, K5's partials at mesh_lane_width's lanes a
    thread. `exact` says whether the
    rank's grids are the one card's (mesh_lane_width)."""

    INIT, START, PASS_A, LANE, PASS_B, BETA = range(6)
    TRIP = (PASS_A, LANE, _ShardedStep.STOP, PASS_B, _ShardedStep.APPLY,
            BETA)

    def __init__(self, At_split, At, A, W_struct, W_slack, invd, rhs,
                 fused: bool = None, rank=None):
        device = _device_of(rhs)
        lib = load()
        m, B = rhs.shape[0], _lanes(rhs, "rhs")
        n = W_struct.shape[0]
        _check_f64(device, dict(W_struct=(W_struct, (n, B)),
                                W_slack=(W_slack, (m, B)),
                                invd=(invd, (m, B)), rhs=(rhs, (m, B))))
        if rank is None:
            self.plan = block_plan_of(At_split, At, A)
            rows, vw, self.exact = self.plan.rows, spmm_width(B, F64), True
            if sum(rows) != m:
                raise ValueError("row blocks do not cover the m rows")
        else:
            rows = list(rank.rows)
            if len(A) != 1 or len(At) != 1 or A[0].rows != rows[rank.i] \
                    or m != rows[rank.i]:
                raise ValueError(f"a mesh rank holds block {rank.i} of "
                                 f"{rows} rows, not {m}")
            vw, self.exact = mesh_lane_width(rank.lanes, B)
        nblk = [red_blocks(r, B) for r in rows]
        npc = [lane_blocks(r, B // vw) for r in rows]
        # the state's length is K7's, which K5 checks
        super().__init__(rows, W_struct, W_slack, rhs, nblk, npc,
                         (2, B, sum(nblk)), int(lib.ipxt_sbcr_state_len(B)),
                         rank)
        self.B, self.vw = B, vw
        e = lambda *s: torch.empty(s, dtype=F64, device=device)  # noqa: E731
        self._keep = invd
        glob = (m, self.P, *(t.data_ptr() for t in self._off),
                invd.data_ptr(), *self._tail[:-1])
        if rank is None:
            self.fused = self.plan.fused if fused is None else bool(fused)
            self.parts = self.U = None
            if not self.fused:
                self.parts, self.U = e(self.P, n, B), e(n, B)
            self.pa_local, self.pc_local = self.pa, self.pc
            self._args = {False: glob}
            return
        i = rank.i
        self.fused = False
        self.At, self.A = At[0], A[0]
        self._part, self.parts, self.U = e(n, B), e(self.P, n, B), e(n, B)
        self.pa_local, self.pc_local = e(2, B, nblk[i]), e(npc[i], B)
        local = (_offsets([m], device), _offsets([nblk[i]], device),
                 _offsets([npc[i]], device))
        self._keep = (invd, local)
        self._args = {False: glob, True: (
            m, 1, *(t.data_ptr() for t in local), invd.data_ptr(),
            *self._tail[:6], self.pa_local.data_ptr(), nblk[i],
            self.pc_local.data_ptr())}

    def solve(self, maxiter: int, tol: float):
        """Runs the loop from the start and returns (Y on the card, trips).
        With the fused apply, the K14 sums that ran inside it (one an apply
        that did work: 1 + trips) count in INSIDE."""
        self._host_issued(maxiter, tol)
        it = int(self.state[self.IT].item())
        if self.fused:
            INSIDE["block_sum"] += 1 + it
        return self.y, it

    def normal_apply(self) -> None:
        """cs = C s over the row blocks through the plan, with the blocks'
        partials of the column dots s.cs; on a mesh rank K5 on A_i', the
        gather of the parts, K14 and K5 on A_i, and a gather of the
        partials."""
        if self.rank is None:
            self.plan(self.W_struct, self.W_slack, self.s, out=self.cs,
                      partials=self.pc, state=self.state, parts=self.parts,
                      U=self.U, fused=self.fused)
            return
        csr_spmm(self.At, self.s, out=self._part, state=self.state)
        block_sum(self._gather_parts(self._part), self.W_struct, out=self.U,
                  state=self.state)
        csr_spmm(self.A, self.U, out=self.cs, addw=self.W_slack,
                 addv=self.s, partials=self.pc_local, state=self.state,
                 vw=self.vw)
        self._share(self.pc, 0, self.npc, "pc", self.pc_local)

    def launch(self, phase: int, k: int, maxiter: int, tol: float) -> None:
        """The elementwise and reducing passes over the rank's rows (on one
        card, all rows), the lane passes over the partials of all blocks."""
        local = self.rank is not None and phase in (self.INIT, self.PASS_A,
                                                    self.PASS_B)
        m, P, *rest = self._args[local]
        err = _lib.ipxt_sbcr_step_f64(phase, m, self.B, P, k, maxiter,
                                      float(tol), *rest,
                                      self.state.data_ptr(), self._stream)
        _raise_if(err, f"sharded_batched_cr_step phase {phase}")
        LAUNCHES["sharded_batched_cr_step"] += 1
        if phase == self.PASS_A:
            self._share(self.pa, 2, self.nblk_of, "pa", self.pa_local)


# -- K17: the level-scheduled triangular solve, float64 ---------------------
# The sweep's tiles (tools/torch_profile.py --what k17 times the choices;
# PERF.md §6): B >= 2 lanes go to tiles of `lanes` lanes (a power of two),
# one block a tile, the fewest that still give K17_TILES tiles. B = 1 takes
# one block whatever they say.
K17_TILES = 128


def k17_tile(B: int) -> int:
    """Lanes of a tile of the sweep over B lanes: the largest power of two
    <= 32 with ceil(B / lanes) >= K17_TILES (1 if none)."""
    lanes = 1
    while lanes < 32 and -(-B // (2 * lanes)) >= K17_TILES:
        lanes *= 2
    return lanes


def sweep_tiles(B: int, lanes: int = None) -> int:
    """Lanes of a tile of a sweep over B lanes: k17_tile(B) where not
    given; raises unless lanes is a power of two in [1, 32]."""
    lanes = k17_tile(B) if lanes is None else lanes
    if lanes not in (1, 2, 4, 8, 16, 32):
        raise ValueError(f"the sweep takes 1-32 lanes a tile (a power of "
                         f"two), got {lanes}")
    return int(lanes)


def _check_schedule(sched, device) -> None:
    """Raises unless the LevelSchedule's tensors are contiguous, of their
    dtypes and lengths and on `device`, and its host level_ptr is the int64
    (nlev + 1) pointer that ends at m."""
    m, nnz = sched.m, sched.cols.numel()
    _check(sched.rows, "rows", device, torch.int32, m)
    _check(sched.entry_ptr, "entry_ptr", device, torch.int64, m + 1)
    _check(sched.cols, "cols", device, torch.int32, nnz)
    _check(sched.vals, "vals", device, F64, nnz)
    _check(sched.inv_diag, "inv_diag", device, F64, m)
    _check(sched.level_ptr_dev, "level_ptr_dev", device, torch.int64,
           sched.nlev + 1)
    lp = sched.level_ptr
    if (lp.dtype != np.int64 or lp.shape != (sched.nlev + 1,)
            or not lp.flags.c_contiguous or lp[-1] != m):
        raise ValueError("level_ptr is not the host int64 (nlev + 1) "
                         "pointer of the schedule")


def level_solve(sched, V: torch.Tensor, per_level: bool = False,
                lanes: int = None) -> torch.Tensor:
    """K17: X with T X = V for V of shape (m, B), the LevelSchedule `sched`
    (ops/trisolve.py) on the current stream: the whole sweep in one launch
    (ipxt_level_sweep_f64), its tiles of k17_tile(B) lanes unless `lanes`
    is given. `per_level` takes the form of one launch a level
    instead, for the comparisons only. LAUNCHES counts the CUDA launches:
    1 a sweep, nlev a per-level sweep."""
    device = _device_of(V)
    m, B = sched.m, _lanes(V, "V")
    _check(V, "V", device, F64, (m, B))
    _check_schedule(sched, device)
    X = torch.empty_like(V)
    lib = load()
    ptrs = (sched.rows, sched.entry_ptr, sched.cols, sched.vals,
            sched.inv_diag, V, X)
    if per_level:
        err = lib.ipxt_level_solve_f64(
            sched.nlev, sched.level_ptr.ctypes.data, B,
            *(t.data_ptr() for t in ptrs), _stream(device))
        _raise_if(err, "level_solve (per level)")
        LAUNCHES["level_solve"] += sched.nlev
        return X
    err = lib.ipxt_level_sweep_f64(
        m, sched.nlev, sched.level_ptr_dev.data_ptr(), B,
        sweep_tiles(B, lanes), *(t.data_ptr() for t in ptrs),
        _stream(device))
    _raise_if(err, "level_solve")
    LAUNCHES["level_solve"] += 1
    return X
