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

Kernels: K1 ``csr_spmv``, K2 ``normal_apply`` (csrc/spmv.cu), K3
``cr_step`` (csrc/cr.cu), K4 ``nnt`` (two K1 launches); for the batched
phase 1, K5 ``csr_spmm``, K6 ``normal_apply_batched`` (csrc/spmm.cu), K7
``batched_cr_step`` (csrc/batch_cr.cu), K8 ``step_batch`` and K9
``ipm_update`` (csrc/ipm_step.cu); for the rest of the batched IPM step, in
float64, K10 ``ipm_prologue`` (csrc/ipm_prologue.cu), K11 ``newton_rhs``
and K12 ``newton_recover`` (csrc/newton.cu) and K13 ``starting_point``
(csrc/start.cu). Batched arrays are (rows, B) with the B lanes contiguous.
"""
from __future__ import annotations

import ctypes

import torch

from . import build as _build

# launches per kernel since the last reset_launches()
LAUNCHES = dict.fromkeys(("csr_spmv", "normal_apply", "cr_step", "nnt",
                          "csr_spmm", "normal_apply_batched",
                          "batched_cr_step", "step_batch", "ipm_update",
                          "ipm_prologue", "newton_rhs", "newton_recover",
                          "starting_point"), 0)

_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}
_lib = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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
        f = getattr(lib, f"ipxt_csr_spmm_{t}")
        f.argtypes = [I64, I64] + [P] * 10 + [I, P]
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
                                                               P]}
    for name, argtypes in f64.items():
        f = getattr(lib, name)
        f.argtypes = argtypes
        f.restype = I
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
def spmv_blocks(op) -> int:
    """Length of the partials a launch over operand `op` writes."""
    return int(load().ipxt_spmv_blocks(op.rows, op.vec))


def _spmv(op, x, y, rowscale=None, addw=None, addv=None, partials=None,
          state=None) -> None:
    """One launch of the CSR kernel with its optional epilogues."""
    device, dtype = x.device, x.dtype
    lib = load()
    _check_operand(op, device, dtype)
    _check(x, "x", device, dtype, op.cols)
    _check(y, "y", device, dtype, op.rows)
    for name, t in (("rowscale", rowscale), ("addw", addw), ("addv", addv)):
        if t is not None:
            _check(t, name, device, dtype, op.rows)
    if (addw is None) != (addv is None):
        raise ValueError("addw and addv go together")
    if partials is not None:
        if addv is None:
            raise ValueError("partials need addv")
        _check(partials, "partials", device, dtype, spmv_blocks(op))
    if state is not None:
        _check(state, "state", device, dtype, int(lib.ipxt_cr_state_len()))
    fn = getattr(lib, f"ipxt_csr_spmv_{_SUFFIX[dtype]}")
    err = fn(op.rows, op.indptr.data_ptr(), op.indices.data_ptr(),
             op.vals.data_ptr(), x.data_ptr(), _ptr(rowscale), _ptr(addw),
             _ptr(addv), y.data_ptr(), _ptr(partials), _ptr(state), op.vec,
             _stream(device))
    _raise_if(err, "csr_spmv")


def csr_spmv(op, x: torch.Tensor) -> torch.Tensor:
    """K1: y = op @ x on the card."""
    device = _device_of(x)
    y = torch.empty(op.rows, dtype=x.dtype, device=device)
    _spmv(op, x, y)
    LAUNCHES["csr_spmv"] += 1
    return y


def normal_apply(At, A, W: torch.Tensor, v: torch.Tensor, out=None,
                 u=None, partials=None, state=None, dot=None):
    """K2: out = A (W[:n] * (A' v)) + W[n:] * v, with the block partials of
    v.out in `partials`; with `dot` (a 1-element tensor) also their sum.
    `At` is A' as a CSR operand (n rows), `A` is A (m rows). The solver
    passes `partials`, never `dot`: the sum (reduce_sum in csrc/spmv.cu)
    serves spmv.normal_apply, for the tests and chip_smoke.py."""
    device = _device_of(v)
    n, m = At.rows, A.rows
    _check(W, "W", device, v.dtype, n + m)
    e = lambda k: torch.empty(k, dtype=v.dtype, device=device)  # noqa: E731
    out = e(m) if out is None else out
    u = e(n) if u is None else u
    partials = e(spmv_blocks(A)) if partials is None else partials
    _spmv(At, v, u, rowscale=W[:n], state=state)
    _spmv(A, u, out, addw=W[n:], addv=v, partials=partials, state=state)
    if dot is not None:
        _check(dot, "dot", device, v.dtype, 1)
        fn = getattr(_lib, f"ipxt_reduce_sum_{_SUFFIX[v.dtype]}")
        _raise_if(fn(partials.numel(), partials.data_ptr(), dot.data_ptr(),
                     _stream(device)), "reduce_sum")
    LAUNCHES["normal_apply"] += 1
    return out


def nnt(Nt, N, w: torch.Tensor) -> torch.Tensor:
    """K4: z = N (N' w) as two K1 launches; `Nt` is N' as a CSR operand."""
    z = csr_spmv(N, csr_spmv(Nt, w))
    LAUNCHES["nnt"] += 1
    return z


# -- K3 -----------------------------------------------------------------------
class CrStep:
    """K3: the passes of one CR solve (csrc/cr.cu) on one card.

    Owns the loop's m-vectors, the per-block partials and the scalar state,
    all allocated once per solve. `residual` starts as a copy of `rhs`.
    `npc` is the length of the partials K2 writes (spmv_blocks of A).
    """

    PRECOND, INIT, PASS_A, PASS_B, PASS_C, RECHECK = range(6)
    # state slots (csrc/common.cuh)
    IT, ERR, DONE = 3, 4, 5

    def __init__(self, invd: torch.Tensor, resscale: torch.Tensor,
                 rhs: torch.Tensor, npc: int):
        device, dtype = _device_of(rhs), rhs.dtype
        lib = load()
        m = rhs.numel()
        _check(rhs, "rhs", device, dtype, m)
        _check(invd, "invd", device, dtype, m)
        _check(resscale, "resscale", device, dtype, m)
        e = lambda k: torch.empty(k, dtype=dtype, device=device)  # noqa: E731
        nblk = int(lib.ipxt_cr_blocks(m))
        self.m = m
        self.residual = rhs.clone()
        self.lhs, self.sres, self.csres, self.step, self.cstep = (
            e(m) for _ in range(5))
        self.pa, self.pr, self.pc = e(2 * nblk), e(nblk), e(npc)
        # zeros made on the host: the state is copied up, not filled by a
        # device kernel
        self.state = torch.zeros(int(lib.ipxt_cr_state_len()),
                                 dtype=dtype).to(device)
        self._invd, self._resscale = invd, resscale   # keep alive
        self._fn = getattr(lib, f"ipxt_cr_step_{_SUFFIX[dtype]}")
        self._stream = _stream(device)
        self._args = (invd.data_ptr(), resscale.data_ptr(),
                      self.lhs.data_ptr(), self.residual.data_ptr(),
                      self.sres.data_ptr(), self.csres.data_ptr(),
                      self.step.data_ptr(), self.cstep.data_ptr(),
                      self.pa.data_ptr(), self.pr.data_ptr(),
                      self.pc.data_ptr(), npc, self.state.data_ptr(),
                      self._stream)

    def launch(self, phase: int, k: int, maxiter: int, tol: float) -> None:
        err = self._fn(phase, self.m, k, maxiter, tol, *self._args)
        _raise_if(err, f"cr_step phase {phase}")
        LAUNCHES["cr_step"] += 1

    def done(self) -> bool:
        return bool(self.state[self.DONE].item())

    def result(self):
        """(lhs on the card, iterations, error code of the loop)."""
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


def _spmm(op, U, Y, rowscale=None, addw=None, addv=None, partials=None,
          state=None) -> None:
    """One launch of the batched CSR kernel with its optional epilogues."""
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
    vw = spmm_width(B, dtype, U, Y, rowscale, addw, addv, partials)
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
             _stream(device))
    _raise_if(err, "csr_spmm")


def csr_spmm(op, U: torch.Tensor) -> torch.Tensor:
    """K5: Y = op @ U for U of shape (op.cols, B), on the card."""
    device = _device_of(U)
    Y = torch.empty((op.rows, _lanes(U, "U")), dtype=U.dtype, device=device)
    _spmm(op, U, Y)
    LAUNCHES["csr_spmm"] += 1
    return Y


def normal_partials_shape(A, W, V, out, U) -> tuple:
    """Shape of the per-lane partials that K6's second launch writes for
    these buffers."""
    B = _lanes(V, "V")
    vw = spmm_width(B, V.dtype, U, out, W[W.shape[0] - A.rows:], V)
    return (lane_blocks(A.rows, B // vw), B)


def normal_apply_batched(At, A, W: torch.Tensor, V: torch.Tensor, out=None,
                         U=None, partials=None, state=None, dots=None):
    """K6: out = A (W[:n] * (A' V)) + W[n:] * V for V of shape (m, B), with
    the per-block partials of the column dots V.out in `partials`; with
    `dots` (a (B,) tensor) also their sums. The batched CR passes
    `partials`, never `dots`: the sum (lane_sum in csrc/spmm.cu) serves
    spmv.normal_apply_batched."""
    device = _device_of(V)
    n, m = At.rows, A.rows
    B = _lanes(V, "V")
    _check(W, "W", device, V.dtype, (n + m, B))
    e = lambda *s: torch.empty(s, dtype=V.dtype, device=device)  # noqa: E731
    out = e(m, B) if out is None else out
    U = e(n, B) if U is None else U
    if partials is None:
        partials = e(*normal_partials_shape(A, W, V, out, U))
    _spmm(At, V, U, rowscale=W[:n], state=state)
    _spmm(A, U, out, addw=W[n:], addv=V, partials=partials, state=state)
    if dots is not None:
        _check(dots, "dots", device, V.dtype, B)
        fn = getattr(_lib, f"ipxt_lane_sum_{_SUFFIX[V.dtype]}")
        _raise_if(fn(partials.shape[0], B, partials.data_ptr(),
                     dots.data_ptr(), _stream(device)), "lane_sum")
    LAUNCHES["normal_apply_batched"] += 1
    return out


# -- K7 -----------------------------------------------------------------------
class BatchedCrStep:
    """K7: the passes of one batched CR solve (csrc/batch_cr.cu) on one card.

    Owns the loop's (m, B) arrays, the K6 scratch, the per-lane partials and
    the state, all allocated once per solve. `R` starts as a copy of `rhs`.
    `invd` and `resscale` are (m, B) and `tol` is (B,), all of rhs's dtype;
    `W` is the (n + m, B) weight of the K6 that the host launches on `S`
    between kPassB and kBeta (`normal_apply`)."""

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
        self.U = e(n, B)
        self.npa = lane_blocks(m, B)
        self.pa = e(2, self.npa, B)
        self.pc = e(*normal_partials_shape(A, W, self.S, self.CS, self.U))
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
        return bool(self.state[self.DONE].item())

    def result(self):
        """(Y on the card, trips)."""
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


# -- K10-K13: the rest of the batched IPM step, float64 ---------------------------
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


def starting_point(X0, ATDY, DY, ATY, Y, cT, lb, ub, finl, finu, rho):
    """K13: the starting point's masked passes from the clamped zero point
    X0, the primal solve's DY and A' DY and the dual solve's Y and A' Y.
    Returns (X, XL, XU, Y, ZL, ZU, lane), lane with the rows START_ROWS."""
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
    err = _lib.ipxt_starting_point_f64(
        n, m, B, *(t.data_ptr() for t in (
            X0, ATDY, DY, ATY, Y, cT, lb, ub, finl, finu, X, XL, XU, Yo, ZL,
            ZU, partials)), nblk, lane.data_ptr(), float(rho),
        1.0 - float(rho), _stream(device))
    _raise_if(err, "starting_point")
    LAUNCHES["starting_point"] += 1
    return X, XL, XU, Yo, ZL, ZU, lane
