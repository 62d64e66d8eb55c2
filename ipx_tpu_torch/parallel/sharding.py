"""Row-blocked and column-blocked KKT solves on one torch device or over a
mesh of processes (port of ipx_tpu/parallel/sharding.py).

The reference partitions A's rows into P contiguous blocks over a jax
device mesh. Each device holds its block's CSR and CSC arrays, and one
normal-matrix apply is

    u_p   = A_p' v_p                    (local)
    u     = psum(u_p)                   (all-reduce over the row blocks)
    out_p = A_p (W_struct u) + W_slack_p v_p      (local)

with the CR's dots psum-reduced and its residual norm pmax-reduced. Phase 2
splits N into P column blocks and sums N_p (N_p' w) the same way.

Without a mesh the P blocks live on the one device that
backend.resolve_sharded picks for Parameters.device. The program is
single-controller, as the reference's is; each psum becomes an ordered sum
over the P block results and each pmax a max, so a solve gives what P ranks
would, with every sum taken in block order p = 0..P-1, and the reference's
second mesh axis ("batch") is the column range of the (m, B) arrays. With
`mesh=` (parallel/mesh.py, one process per rank) each rank holds its own
blocks and runs the loops below on them, the psums gathers combined in
rank order (the `psum` hook of the plain loops, the `rank` of the card's
steps), which give the one-process results bit for bit (the card's rows x
batch CR where each rank keeps the one card's grids, kernels.
mesh_lane_width): ShardedNormalMatrix, ShardedDiagCR and
sharded_cr_solve over a ("rows",) mesh, sharded_batched_cr_solve over a
("rows", "batch") one, ShardedSplittedNNt over the ranks of a ("rows",)
mesh as column blocks (backend.resolve_mesh picks the mesh for
Parameters.shards).

Kernels, each wrapper with its plain PyTorch version beside it:

* the block products: K1 ``csr_spmv`` (csrc/spmv.cu), one launch over the
  P blocks' CSR operands of A_p for the vector apply (BlockSpmvPlan), and K5
  ``csr_spmm`` (csrc/spmm.cu) per block on those of A_p and A_p' for the
  batched one's three-stage form;
* K14v ``block_spmv_sum`` (csrc/nnt.cu): the vector apply's first half and
  its psum in one launch, u = W_struct * sum_p A_p' v_p in block order, on
  the whole A' split at the row blocks' bounds (ops/spmv.py's split
  layout); no parts array;
* K14 ``block_sum`` (csrc/sharded.cu): the batched apply's psum, out =
  scale * sum_p part_p in block order, over the parts that K5 wrote (the
  three-stage form);
* K4 ``nnt`` (csrc/nnt.cu): the column-blocked N N' with its psum, one
  launch per apply on the whole N split at the column blocks' bounds;
* K15 ``sharded_cr_step``: a whole ShardedDiagCR or sharded_cr_solve loop,
  its vector applies (K14v's split sum and K1's block products) inside,
  in one cooperative launch (``sharded_cr``);
* K16 ``sharded_batched_cr_step``: the passes of sharded_batched_cr_solve
  (``sharded_batched_cr``) and its batched apply, one fused launch that
  writes neither the parts nor W_struct * sum_p A_p' V_p where A's columns
  are short (kernels.BlockNormalBatchedPlan), else the three-stage form.

Not carried over: make_row_mesh's fallback to the CPU's virtual devices
(parallel/mesh.py has make_row_mesh; the device rule is
backend.resolve_sharded's and resolve_mesh's, and a failure raises); the
padding of the blocks to m_block rows and to a common nonzero
capacity, LANES and flat_cumsum, which existed for XLA's static shapes
(blocks here are ragged: the last holds what is left); the static capacity
of ShardedSplittedNNt, its overflow return and its mode="fill" padding
(each epoch's blocks are packed as they are).
"""
from __future__ import annotations

from time import perf_counter

import numpy as np
import scipy.sparse as sp
import torch

from .. import backend, kernels
from ..ops.device_cr2 import NntPlan, nnt_plain
from ..ops.spmv import CsrOperand, csr_spmm_plain, csr_spmv_plain

F64 = torch.float64

__all__ = ["ShardedNormalMatrix", "ShardedDiagCR", "sharded_cr_solve",
           "sharded_batched_cr_solve", "ShardedSplittedNNt",
           "ShardedPhase2CR", "block_sum", "block_normal_apply",
           "sharded_cr", "sharded_batched_cr", "block_nnt"]


def block_sizes(total: int, num_blocks: int) -> list:
    """Sizes of `num_blocks` contiguous blocks of ceil(total / num_blocks),
    the last holding what is left (possibly none), as the reference cuts
    rows and columns."""
    per = -(-total // num_blocks) if total else 1
    return [max(0, min(per, total - p * per)) for p in range(num_blocks)]


def _bounds(sizes) -> list:
    out, r0 = [], 0
    for k in sizes:
        out.append((r0, r0 + k))
        r0 += k
    return out


def _where(device):
    """`device`, or by default the card: backend.resolve_sharded("cuda"),
    which raises when there is none."""
    return backend.resolve_sharded("cuda") if device is None else device


def _t(x, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float64)).to(
        device)


def col_sums(X: torch.Tensor, bounds=None) -> torch.Tensor:
    """Column sums of X (rows, B), (B,), or with `bounds` over each row
    range (r0, r1) of it, (len(bounds), B), from one transposed copy of X:
    each column summed as the column alone would be, the same for any B and
    any group of columns, which torch.sum over dim 0 is not (its order
    follows the width)."""
    T = X.t().contiguous()
    if bounds is None:
        return T.sum(dim=1)
    return torch.stack([T[:, r0:r1].sum(dim=1) for r0, r1 in bounds])


def _array(x) -> np.ndarray:
    return np.ascontiguousarray(x, dtype=np.float64)


# -- K14: the ordered sum over the blocks -------------------------------------
def block_sum_plain(parts: torch.Tensor, scale=None) -> torch.Tensor:
    """Plain version of K14: parts[0] + parts[1] + ... in order, times
    scale."""
    s = parts[0].clone()
    for p in range(1, parts.shape[0]):
        s = s + parts[p]
    return s * scale if scale is not None else s


class BlockSums:
    """The psum and pmax of the plain row-blocked loops when every block
    is in this process: `sums` (P, ...) of the blocks summed in block order,
    `maxes` taken as they are. Over a mesh (parallel/mesh.py) each rank
    runs the same loops on its own block, with a BlockSums whose call
    gathers the ranks' values and combines them in rank order. `what`
    names the reduction for the mesh's timers: "parts" (the partial
    products A_p' v_p) or "dots"."""

    def __call__(self, sums, maxes=None, what: str = "dots"):
        return block_sum_plain(sums), maxes


LOCAL = BlockSums()


def block_sum(parts: torch.Tensor, scale=None) -> torch.Tensor:
    """K14: scale * (((parts[0] + parts[1]) + parts[2]) + ...) for parts of
    shape (P, *shape); the reference's psum over the mesh axis."""
    if parts.device.type == "cpu":
        return block_sum_plain(parts, scale)
    return kernels.block_sum(parts, scale)


# -- the row-blocked normal matrix --------------------------------------------
class ShardedNormalMatrix:
    """Row-blocked AI W AI' apply.

    A's rows in num_blocks contiguous blocks (block_sizes); each block holds
    the CSR operand of A_p (its rows, n columns) for A_p u and that of A_p'
    (n rows) for A_p' V_p, on `device`, in the format K1 and K5 take.
    `op_At_split` is the whole A' split at the blocks' row bounds, for the
    vector apply's K14v. `device` None means the card, and raises without
    one. With `mesh` (parallel/mesh.py, its rows axis num_blocks ranks) the
    blocks are built on the ranks, each holding its own, and nothing here:
    the solves of this module take them there, and apply() does not."""

    def __init__(self, A: sp.csc_matrix, num_blocks: int,
                 device: torch.device = None, mesh=None):
        A = sp.csc_matrix(A)
        m, n = A.shape
        self.m, self.n = m, n
        self.A = A
        self.num_blocks = num_blocks
        self.rows = block_sizes(m, num_blocks)
        self.bounds = _bounds(self.rows)
        self.mesh, self._keys = mesh, {}
        if mesh is not None:
            self.device = mesh.device
            self.key(mesh)
            return
        self.device = device = _where(device)
        A_csr = A.tocsr()
        A_csr.sort_indices()
        A_csc = A_csr.tocsc()
        A_csc.sort_indices()
        # the CSC arrays of A are the CSR arrays of A'
        self.op_At_split = CsrOperand(
            A_csc.indptr, A_csc.indices, A_csc.data, m, device, F64,
            bounds=[0] + [r1 for _, r1 in self.bounds])
        self.op_A, self.op_At = [], []
        for r0, r1 in self.bounds:
            Ab = A_csr[r0:r1]
            Abc = Ab.tocsc()
            Abc.sort_indices()
            self.op_A.append(CsrOperand(Ab.indptr, Ab.indices, Ab.data, n,
                                        device, F64))
            # the CSC arrays of A_p are the CSR arrays of A_p'
            self.op_At.append(CsrOperand(Abc.indptr, Abc.indices, Abc.data,
                                         r1 - r0, device, F64))

    def key(self, mesh) -> int:
        """The key of the blocks on `mesh` (a layout of its ranks), put
        there at the first use."""
        k = (id(mesh._ranks), mesh.layout)
        if k not in self._keys:
            self._keys[k] = mesh.load_rows(self.A, self.num_blocks)
        return self._keys[k]

    def apply(self, W_struct, W_slack, v):
        """C v for v (m,) or (m, B) with W_struct (n,) or (n, B) and W_slack
        of v's shape: the reference's block_normal_apply(_batched) on every
        block with its psum."""
        if self.mesh is not None:
            raise ValueError("the blocks are on a mesh; its solves apply "
                             "them")
        return block_normal_apply(self, W_struct, W_slack, v)


def _block_apply_plain(snm, W_struct, W_slack, v, prod, psum=LOCAL):
    parts = torch.stack([prod(op, v[r0:r1])
                         for op, (r0, r1) in zip(snm.op_At, snm.bounds)])
    u = psum(parts, what="parts")[0] * W_struct
    return torch.cat([prod(op, u) + W_slack[r0:r1] * v[r0:r1]
                      for op, (r0, r1) in zip(snm.op_A, snm.bounds)])


def block_normal_apply(snm: ShardedNormalMatrix, W_struct, W_slack, v):
    """C v over the row blocks. For v of shape (m,): u = W_struct * sum_p
    A_p' v_p in one K14v launch, then A_p u + W_slack_p v_p for every block
    in one K1 launch. For (m, B), through the operator's
    kernels.BlockNormalBatchedPlan: one fused launch where A's columns are
    short, else A_p' V_p per block (K5), their ordered sum scaled by
    W_struct (K14), then per block (K5)."""
    if v.device.type == "cpu":
        return _block_apply_plain(snm, W_struct, W_slack, v,
                                  csr_spmm_plain if v.dim() == 2
                                  else csr_spmv_plain)
    if v.dim() == 2:
        return kernels.block_plan_of(snm.op_At_split, snm.op_At, snm.op_A)(
            W_struct, W_slack, v)
    return kernels.block_normal_apply(snm.op_At_split, snm.op_A, W_struct,
                                      W_slack, v)


# -- K15: the row-blocked CR --------------------------------------------------
def sharded_cr_plain(snm, W_struct, W_slack, invd, resscale, rhs, tol: float,
                     maxiter: int, ladder: bool = True, psum=LOCAL):
    """Plain version of K15: the reference's cr_local loop of ShardedDiagCR
    (`ladder`, with the scaled norm) or of sharded_cr_solve (resscale None),
    each dot the psum of the block dots and the residual norm the pmax of
    the block maxima, the loop test on the host. `psum` (BlockSums) takes
    them over the blocks of `snm` by default; a mesh rank runs the loop on
    its own block and rows with one that gathers (parallel/mesh.py).
    Returns (y, iterations, error code, residual norm at the stop)."""
    bounds = snm.bounds

    def block_dots(a, b):
        return torch.stack([torch.dot(a[r0:r1], b[r0:r1])
                            for r0, r1 in bounds])

    def C(v):
        out = _block_apply_plain(snm, W_struct, W_slack, v, csr_spmv_plain,
                                 psum)
        return out, psum(block_dots(v, out))[0]

    def head(r, cd):        # a trip's residual norm and pdot, one psum
        pcd = cd * invd
        rmax = torch.max(torch.abs(resscale * r if resscale is not None
                                   else r))
        pdot, rmax = psum(block_dots(cd, pcd), rmax.view(1))
        return rmax[0], pdot, pcd

    zero = torch.zeros((), dtype=F64, device=rhs.device)
    y = torch.zeros_like(rhs)
    r = rhs.clone()
    s = r * invd
    cs, cdot = C(s)
    d, cd = s, cs
    it, err = 0, 0
    while True:
        resnorm, pdot, pcd = head(r, cd)
        if not (bool(resnorm > tol) and it < maxiter and err == 0):
            break
        alpha = cdot / pdot
        ok = True
        if ladder:
            if cdot <= 0.0:
                err = 202
            if pdot <= 0.0:
                err = 203
            if not bool(torch.isfinite(alpha)):
                err = 205
            ok = err == 0
            if not ok:
                alpha = zero
        y = y + alpha * d
        r = r - alpha * cd
        s = s - alpha * pcd
        cs, cdot_new = C(s)
        if ladder and ok and not bool(torch.isfinite(cdot_new)):
            err = 205
        beta = cdot_new / cdot if ok else zero
        d = s + beta * d
        cd = cs + beta * cd
        cdot = cdot_new
        it += 1
    return y, it, err, float(resnorm)


def sharded_cr(snm, W_struct, W_slack, invd, resscale, rhs, tol: float,
               maxiter: int, ladder: bool = True):
    """K15: CR on (A W A') y = rhs over the row blocks with preconditioner
    1/invd, on the device of `rhs`; float64 tensors. On the card the whole
    loop is one cooperative launch (kernels.ShardedCrStep.solve). Returns
    (y, iterations, error code, residual norm at the stop)."""
    if rhs.device.type == "cpu":
        return sharded_cr_plain(snm, W_struct, W_slack, invd, resscale, rhs,
                                tol, maxiter, ladder)
    return kernels.ShardedCrStep(
        snm.op_At_split, snm.op_A, W_struct, W_slack, invd, resscale, rhs,
        ladder).solve(maxiter, tol)


class ShardedDiagCR:
    """Phase-1 KKT CR with A's rows in blocks, reachable from LpSolver via
    Parameters.shards (SURVEY §2.3: the model-parallel axis). Diagonally
    preconditioned, in float64 (no mixed precision, as in the reference).
    The operands are built once per model; weights, diagonal, residual
    scaling and right-hand side are uploaded per solve.

    Termination matches the KKT-solver contract: scaled inf-norm
    ||resscale . r||_inf <= tol (reference: src/kkt_solver.h:11-27), with
    the error ladder 202 (cdot <= 0), 203 (pdot <= 0), 205 (alpha or the
    next cdot not finite), the iterate frozen after an error. Counters:
    solves and iterations. `device` and `mesh` as for ShardedNormalMatrix:
    over a mesh each rank runs the solve on its own blocks."""

    def __init__(self, A: sp.csc_matrix, num_blocks: int,
                 device: torch.device = None, mesh=None):
        self.snm = ShardedNormalMatrix(A, num_blocks, device, mesh)
        self.mesh = mesh
        self.device = self.snm.device
        self.solves = 0
        self.iterations = 0

    def solve(self, W_struct, W_slack, diag, resscale, rhs, tol: float,
              maxiter: int):
        """Returns (y (m,), iters, errflag), errflag 201 on the iteration
        limit; maxiter < 0 means m + 100."""
        snm = self.snm
        if maxiter < 0:
            maxiter = snm.m + 100
        dev = self.device
        if self.mesh is not None:
            y, iters, err, resnorm, _ = self.mesh.cr_solve(
                snm.key(self.mesh), _array(W_struct), _array(W_slack),
                1.0 / _array(diag), _array(resscale), _array(rhs), tol,
                maxiter, ladder=True)
        else:
            y, iters, err, resnorm = sharded_cr(
                snm, _t(W_struct, dev), _t(W_slack, dev),
                _t(1.0 / np.asarray(diag, dtype=np.float64), dev),
                _t(resscale, dev), _t(rhs, dev), tol, maxiter, ladder=True)
            y = y.cpu().numpy()
        # success only on a finite residual within tolerance; a NaN residual
        # must never read as converged (errflag policy per ADVICE r3)
        if err == 0 and not (np.isfinite(resnorm) and resnorm <= tol):
            err = 205 if not np.isfinite(resnorm) else 201
        self.solves += 1
        self.iterations += iters
        return y, iters, err


def sharded_cr_solve(snm: ShardedNormalMatrix, W_struct, W_slack, diag, rhs,
                     tol: float, maxiter: int, mesh=None):
    """Diagonal-preconditioned CR on the normal equations over the row
    blocks, stopping on the unscaled ||r||_inf, with no error ladder.
    `mesh` (or the one snm was built on), a mesh whose rows axis has
    snm.num_blocks ranks: each rank solves on its own blocks. Returns (y,
    iters) with y on the host."""
    mesh = snm.mesh if mesh is None else mesh
    if mesh is not None:
        y, iters, _, _, _ = mesh.cr_solve(
            snm.key(mesh), _array(W_struct), _array(W_slack),
            1.0 / _array(diag), None, _array(rhs), tol, maxiter,
            ladder=False)
        return y, iters
    dev = snm.device
    y, iters, _, _ = sharded_cr(
        snm, _t(W_struct, dev), _t(W_slack, dev),
        _t(1.0 / np.asarray(diag, dtype=np.float64), dev), None,
        _t(rhs, dev), tol, maxiter, ladder=False)
    return y.cpu().numpy(), iters


# -- K16: the row-blocked batched CR ------------------------------------------
def sharded_batched_cr_plain(snm, W_struct, W_slack, invd, RHS, tol: float,
                             maxiter: int, psum=LOCAL):
    """Plain version of K16: the reference's lane-masked cr_local of
    sharded_batched_cr_solve, each column dot the psum of the block column
    sums and each lane's residual norm the pmax of the block maxima, the
    loop test on the host; `psum` as for sharded_cr_plain (a mesh rank runs
    the loop on its own block and lanes). Returns (Y, trips)."""
    bounds = snm.bounds

    def C(V):
        out = _block_apply_plain(snm, W_struct, W_slack, V, csr_spmm_plain,
                                 psum)
        return out, psum(col_sums(V * out, bounds))[0]

    Y = torch.zeros_like(RHS)
    R = RHS.clone()
    S = R * invd
    CS, cdot = C(S)
    D, CD = S, CS
    done = torch.zeros(RHS.shape[1], dtype=torch.bool, device=RHS.device)
    it = 0
    while not bool(done.all()) and it < maxiter:
        PCD = CD * invd
        pdot, rmax = psum(col_sums(CD * PCD, bounds),
                          torch.amax(torch.abs(R), dim=0))
        done = done | (rmax <= tol)
        alpha = torch.where(done, 0.0,
                            cdot / torch.where(pdot == 0.0, 1.0, pdot))
        Y = Y + alpha * D
        R = R - alpha * CD
        S = S - alpha * PCD
        CS, cdot_new = C(S)
        beta = torch.where(done, 0.0,
                           cdot_new / torch.where(cdot == 0.0, 1.0, cdot))
        D = torch.where(done, D, S + beta * D)
        CD = torch.where(done, CD, CS + beta * CD)
        cdot = torch.where(done, cdot, cdot_new)
        it += 1
    return Y, it


def sharded_batched_cr(snm, W_struct, W_slack, invd, RHS, tol: float,
                       maxiter: int):
    """K16: the lane-masked CR over the row blocks for RHS (m, B), with
    per-scenario W_struct (n, B), W_slack and invd (m, B), float64 on the
    device of RHS. On the card the host issues the passes, and each trip's
    normal apply is one fused launch where the operator's plan allows it
    (kernels.BlockNormalBatchedPlan). Returns (Y, trips)."""
    if RHS.device.type == "cpu":
        return sharded_batched_cr_plain(snm, W_struct, W_slack, invd, RHS,
                                        tol, maxiter)
    return kernels.ShardedBatchedCrStep(
        snm.op_At_split, snm.op_At, snm.op_A, W_struct, W_slack, invd,
        RHS).solve(maxiter, tol)


def sharded_batched_cr_solve(snm: ShardedNormalMatrix, W_struct, W_slack,
                             diag, RHS, tol: float, maxiter: int, mesh=None):
    """Scenario-batched, row-blocked CR (the composition of the
    data-parallel and model-parallel axes, SURVEY §2.3) with per-scenario
    weights W_struct (n, B), W_slack, diag and RHS (m, B). Converged
    scenarios freeze while the rest keep iterating. On one device the
    reference's batch axis is the column range of the (m, B) arrays. Over a
    ("rows", "batch") `mesh` of snm.num_blocks x nb ranks, rank (i, j)
    holds row block i and the j-th of nb lane groups, each lane group
    running its own loop; iters is then the most of any group's, which is
    the one-device loop's. Returns (Y (m, B) on the host, iters)."""
    if mesh is not None:
        Y, iters, _ = mesh.batched_cr_solve(
            snm.key(mesh), _array(W_struct), _array(W_slack),
            1.0 / _array(diag), _array(RHS), tol, maxiter)
        return Y, iters
    dev = snm.device
    Y, iters = sharded_batched_cr(
        snm, _t(W_struct, dev), _t(W_slack, dev),
        _t(1.0 / np.asarray(diag, dtype=np.float64), dev), _t(RHS, dev),
        tol, maxiter)
    return Y.cpu().numpy(), iters


# -- phase 2: the column-blocked N N' -----------------------------------------
def block_nnt_plain(blocks, w: torch.Tensor) -> torch.Tensor:
    """Plain version of the column-blocked N N': K4's plain version per
    block and K14's over the blocks."""
    return block_sum_plain(torch.stack([nnt_plain(Nt, N, w)
                                        for Nt, N in blocks]))


def block_nnt(nnt: "ShardedSplittedNNt", w: torch.Tensor) -> torch.Tensor:
    """sum_p N_p (N_p' w) in block order for the operand of `nnt`, w on
    its device: one K4 launch on the card (z is the kernel's buffer, which
    the next apply overwrites), block_nnt_plain on the CPU."""
    return nnt.plan(w)


class ShardedSplittedNNt:
    """Column-blocked N N' apply for the PHASE-2 splitted operator
    (counterpart of the NNt pass in reference: src/splitted_normal_matrix.cc
    :90-117): N's columns in num_blocks contiguous blocks (block_sizes), and
    apply(w) = sum_p N_p (N_p' w) in block order. Each epoch's operand is
    packed once on `device`: N' with N split at the blocks' column bounds,
    which `plan` (ops/device_cr2.py NntPlan: one K4 launch per apply on the
    card) takes. `blocks`, the CSR operands of N_p' and N_p per block that
    the plain version takes, are packed at their first use: the CPU plan's
    first apply, or a comparison with the plain version. The B / B'
    triangular solves stay on the host (sequential by nature), so the
    phase-2 CR is host solve -> device N N' -> host solve per iteration.
    `applies` counts the applies. `device` as for ShardedNormalMatrix. With
    `mesh`, a ("rows",) mesh of num_blocks ranks, rank p holds column block
    p, and an apply broadcasts w, runs K4 on every block and sums the
    gathered results in order on rank 0 (parallel/mesh.py).
    """

    def __init__(self, m: int, n: int, num_blocks: int,
                 device: torch.device = None, mesh=None):
        self.m = m
        self.n = n
        self.num_blocks = num_blocks
        self.mesh, self._key = mesh, None
        self.device = mesh.device if mesh is not None else _where(device)
        self._N = None
        self._blocks = None
        self.plan = None
        self.applies = 0

    def set_operand(self, N) -> None:
        """Packs a fresh epoch's N (m x n) split at its column blocks'
        bounds, as it is: there is no static capacity to overflow."""
        if self.mesh is not None:
            self._key = self.mesh.set_nnt(N, self.num_blocks, self._key)
            return
        N = sp.csc_matrix(N, copy=True)
        N.sort_indices()
        self._N, self._blocks = N, None
        Nr = N.tocsr()
        Nr.sort_indices()
        cuts = _bounds(block_sizes(N.shape[1], self.num_blocks))
        Nt = CsrOperand(N.indptr, N.indices, N.data, self.m, self.device, F64)
        Ns = CsrOperand(Nr.indptr, Nr.indices, Nr.data, N.shape[1],
                        self.device, F64, bounds=[0] + [c1 for _, c1 in cuts])
        self.plan = NntPlan(Nt, Ns, lambda w: block_nnt_plain(self.blocks, w))

    @property
    def blocks(self) -> list:
        """(N_p', N_p) as CSR operands on `device` per column block, packed
        from the epoch's N at the first use; not on a mesh, whose ranks
        hold them."""
        if self.mesh is not None:
            raise ValueError("the column blocks are on a mesh")
        if self._blocks is None:
            N = self._N
            self._blocks = []
            for c0, c1 in _bounds(block_sizes(N.shape[1], self.num_blocks)):
                Nb = N[:, c0:c1]
                Nr = Nb.tocsr()
                # the CSC arrays of N_p are the CSR arrays of N_p'
                self._blocks.append((
                    CsrOperand(Nb.indptr, Nb.indices, Nb.data, self.m,
                               self.device, F64),
                    CsrOperand(Nr.indptr, Nr.indices, Nr.data, c1 - c0,
                               self.device, F64)))
        return self._blocks

    def apply(self, w: np.ndarray) -> np.ndarray:
        self.applies += 1
        if self.mesh is not None:
            return self.mesh.nnt_apply(self._key, w)
        return self.plan.apply(w)


class ShardedPhase2CR:
    """Phase-2 CR with the NNt product over the column blocks and the B/B'
    solves on host. Same contract as the native phase-2 engine
    (inf-norm termination, breakdown codes 201/202/205); slot space with
    BASIC_FREE zeroed. The port's copy of ipx_tpu/parallel/sharding.py:
    ShardedPhase2CR."""

    def __init__(self, nnt: ShardedSplittedNNt):
        self.nnt = nnt
        self.time_B = 0.0
        self.time_Bt = 0.0
        self.time_NNt = 0.0

    def _apply(self, splitted, v):
        s = splitted.uscale
        t0 = perf_counter()
        w = splitted._basis.solve_dense(v / s, "T")
        self.time_Bt += perf_counter() - t0
        t0 = perf_counter()
        nn = self.nnt.apply(w)
        self.time_NNt += perf_counter() - t0
        t0 = perf_counter()
        lhs = splitted._basis.solve_dense(nn, "N") / s
        self.time_B += perf_counter() - t0
        lhs = lhs + v
        if splitted.free_positions.size:
            lhs[splitted.free_positions] = 0.0
        return lhs

    def solve(self, splitted, rhs: np.ndarray, tol: float, maxiter: int):
        """Returns (lhs, iters, errflag)."""
        m = rhs.size
        if maxiter < 0:
            maxiter = m + 100
        lhs = np.zeros(m)
        r = rhs.copy()
        Cr = self._apply(splitted, r)
        cdot = float(r @ Cr)
        step = r.copy()
        Cstep = Cr.copy()
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
            lhs += alpha * step
            r -= alpha * Cstep
            Cr = self._apply(splitted, r)
            cdot_new = float(r @ Cr)
            beta = cdot_new / cdot
            step = r + beta * step
            Cstep = Cr + beta * Cstep
            denom = float(Cstep @ Cstep)
            cdot = cdot_new
            it += 1
        return lhs, it, err
