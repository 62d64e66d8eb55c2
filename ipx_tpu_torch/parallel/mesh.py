"""The reference's device mesh as one process per rank (port of
make_row_mesh, ipx_tpu/parallel/sharding.py:178-195, and of the
jax.sharding.Mesh that every shard_map of that module runs over).

A Mesh of P ranks is single-controller, as the reference's one Python
program is: rank 0 is the caller's process and runs the whole host
pipeline (presolve, IPM, basis, crossover); ranks 1..P-1 are worker
processes, started from the "spawn" context, each bound to its device
before any CUDA call, that hold their blocks and take part in the solves.
Rank 0 sends a command (an op code and its sizes) and every rank runs the
op on its own blocks:

* LOAD_ROWS: A is broadcast once, and rank (i, j) builds and keeps only
  row block i, A_i and A_i' (sharding.py's ShardedNormalMatrix);
* CR: one row-blocked CR solve (ShardedDiagCR.solve, sharded_cr_solve).
  Each rank runs the one-process loop on its own block, with a _RowGroup
  as its link to the other ranks: on the card kernels.ShardedCrStep's
  host-issued K15 passes over the block's virtual blocks, a trip's normal
  apply K14v at P = 1 on the rank's A_i' (its part of u), a gather of the
  (P, n) parts, K14's ordered sum scaled by W_struct and K1's block
  product A_i u, the partials of the passes (pa) and of the block products
  (pc) gathered into their one-card slots; on the CPU sharding.py's
  sharded_cr_plain on the block's rows, its psums and pmaxes gathered. The
  stop test, the iteration limit and the 202/203/205 ladder then come from
  the same sums in the same order on every rank, and the ranks stay in
  lockstep with no other synchronisation;
* BATCHED_CR: sharded_batched_cr_solve on a rows x batch mesh: rank (i, j)
  holds row block i and lane group j, its partials gathered over its row
  group only, each lane group running its own loop, as each device's
  while_loop does in the reference (kernels.ShardedBatchedCrStep's K16
  passes with K5, K14, K5 on the card; sharded_batched_cr_plain on the
  CPU);
* SET_NNT and NNT: phase 2's column-blocked N N' (ShardedSplittedNNt): N
  is broadcast once an epoch and rank p keeps column block N_p; for each
  apply rank 0 broadcasts w, every rank runs K4 at P = 1 on its block and
  rank 0 sums the gathered (P, m) results in order with K14;
* STEP: one batched IPM step with its lanes split over the ranks, the
  lane reductions of the step (the CR loops' tests, the trip counts, the
  stall test) gathered where the reference's XLA puts a collective;
* CLOSE.

Every sum over ranks is an all-gather followed by a combine in rank order,
never an all_reduce, so a mesh gives the one-process P-block results of
sharding.py bit for bit: the row CR and N N' always, the rows x batch CR
on the CPU always and on the card where each rank's K16 and K5 grids are
the one card's (kernels.mesh_lane_width: at most two lane groups, each of
all B lanes or at least 32; elsewhere Y agrees to rounding and the trips
may differ, which the solve's per-rank stats say, `exact`). Where the
one-card kernels sum a block's segment of a row at lanes that start at
the row's first entry (K14v and K4's split sums), the rank's operand
starts each row with as many explicit zeros as put its entries on the
same lanes (lane_aligned), at the whole operand's lanes a row.

The transport is fixed from the device list before any work: NCCL when
every rank has its own card, gloo when the ranks are on the CPU or share
one card (NCCL refuses two ranks on one GPU); gloo's gathers of card
tensors go through pinned host buffers (`staged`). Commands travel on a
gloo group of their own. The groups are private, built on a TCPStore with
the mesh's timeout, so a default process group of the caller's is never
touched.

A worker that raises stores its traceback and exits; rank 0's next
collective fails (or times out), and rank 0 raises with the worker's
traceback and closes the mesh. The workers are daemon processes that end
with rank 0: close() and an atexit hook end them, and a worker waiting
for a command leaves when rank 0's connection closes.
"""
from __future__ import annotations

import atexit
import datetime
import itertools
import os
import traceback
import weakref
from time import perf_counter

import numpy as np
import scipy.sparse as sp
import torch
import torch.distributed as dist

from .. import kernels
from ..ops.device_cr2 import nnt_plain
from ..ops.spmv import CsrOperand, lanes_per_row
from .sharding import (BlockSums, _bounds, block_sizes, block_sum_plain,
                       sharded_batched_cr_plain, sharded_cr_plain)

F64 = torch.float64
I64 = torch.int64

LOAD_ROWS, CR, BATCHED_CR, SET_NNT, NNT, STEP, CLOSE = range(1, 8)
OPS = {LOAD_ROWS: "load row blocks", CR: "CR solve",
       BATCHED_CR: "batched CR solve", SET_NNT: "set N's column blocks",
       NNT: "N N' apply", STEP: "batched step", CLOSE: "close"}
HEADER = 16         # float64 slots of a command
MAX_ARRAYS = 32     # arrays of a payload
IDLE = datetime.timedelta(days=7)   # a worker's wait for a command

# all_gather_single where torch has it (it deprecates all_gather_into_tensor
# from 2.13 on), all_gather_into_tensor on the torch before it; both take a
# flat output, as gloo wants
_ALL_GATHER = (getattr(dist, "all_gather_single", None)
               or dist.all_gather_into_tensor)

_ACTIVE: list = []  # the meshes entered with `with`, innermost last
_OPEN = weakref.WeakSet()
_UIDS = itertools.count(1)


def active_mesh():
    """The innermost mesh entered with `with`, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


class MeshError(RuntimeError):
    """An op of a mesh failed on some rank; the mesh is closed."""


def transport_of(devices) -> tuple:
    """(transport, staged) for ranks on `devices`: ("gloo", False) on the
    CPU, ("nccl", False) when every rank has its own card, ("gloo", True)
    when ranks share a card, whose tensors gloo then moves through pinned
    host buffers."""
    devs = [torch.device(d) for d in devices]
    kinds = {d.type for d in devs}
    if kinds == {"cpu"}:
        return "gloo", False
    if kinds != {"cuda"}:
        raise ValueError(f"a mesh's ranks are all on the CPU or all on "
                         f"cards, got {list(devices)}")
    idx = [d.index for d in devs]
    return ("nccl", False) if len(set(idx)) == len(idx) else ("gloo", True)


def _devices(devices, size: int) -> list:
    devs = [torch.device(d) for d in devices]
    if len(devs) != size:
        raise ValueError(f"{len(devs)} devices for a mesh of {size} ranks")
    return [str(torch.device("cuda", d.index or 0)) if d.type == "cuda"
            else "cpu" for d in devs]


# the torch versions whose private process-group API _group was checked on
CHECKED_TORCH = ("2.11", "2.13")


def _group(store, rank: int, size: int, backend: str, timeout, name: str):
    """A process group of its own on `store` (a PrefixStore), which no
    default group knows of. torch has no public way to build one, so this
    goes through its private API (the ProcessGroup and backend
    constructors, _set_default_backend, _register_backend,
    _set_group_name, the NCCL options' _timeout), checked on the torch
    versions of CHECKED_TORCH; on a torch that lacks or changed any of
    them this raises MeshError, naming the version, before any work."""
    try:
        pg = dist.ProcessGroup(store, rank, size)
        kind = dist.ProcessGroup.BackendType
        if backend == "nccl":
            opts = dist.ProcessGroupNCCL.Options()
            opts._timeout = timeout
            be = dist.ProcessGroupNCCL(store, rank, size, opts)
            bt, dev = kind.NCCL, torch.device("cuda")
        else:
            be = dist.ProcessGroupGloo(store, rank, size, timeout)
            bt, dev = kind.GLOO, torch.device("cpu")
        pg._set_default_backend(bt)
        pg._register_backend(dev, bt, be)
        pg._set_group_name(name)
    except (AttributeError, TypeError) as exc:
        raise MeshError(f"torch {torch.__version__} does not build a private "
                        f"{backend} process group as torch "
                        f"{', '.join(CHECKED_TORCH)} do: {exc}") from exc
    return pg


def lane_aligned(indptr, indices, data, c0: int, c1: int, vec: int,
                 device) -> CsrOperand:
    """The CSR operand of columns [c0, c1) of a CSR matrix (sorted rows),
    each row preceded by (entries of the row before column c0) mod vec
    explicit zeros, summed at `vec` lanes a row: the K14v and K4 split sums
    of one column block then put each entry on the lane of the whole
    operand's split sum, so the block's sums round as the one-card ones."""
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices)
    rows = len(indptr) - 1
    row_of = np.repeat(np.arange(rows), np.diff(indptr))
    inseg = (indices >= c0) & (indices < c1)
    cnt = np.bincount(row_of[inseg], minlength=rows)
    pad = np.bincount(row_of[indices < c0], minlength=rows) % vec
    new_ptr = np.concatenate([[0], np.cumsum(pad + cnt)]).astype(np.int64)
    seg_rows = row_of[inseg]
    first = np.cumsum(cnt) - cnt
    pos = (new_ptr[seg_rows] + pad[seg_rows]
           + np.arange(seg_rows.size) - first[seg_rows])
    new_idx = np.zeros(new_ptr[-1], dtype=np.int64)
    new_val = np.zeros(new_ptr[-1])
    new_idx[pos] = indices[inseg] - c0
    new_val[pos] = np.asarray(data)[inseg]
    op = CsrOperand(new_ptr, new_idx, new_val, c1 - c0, device, F64)
    op.vec = vec
    return op


class _MeshLanes:
    """The lane reductions of a batched step whose lanes are spread over the
    ranks `members`: each gathered and combined, as XLA's collective gives
    every device the reduction over all lanes."""

    def __init__(self, rank, members):
        self.rank, self.members = rank, members

    def _all(self, x: float) -> torch.Tensor:
        return self.rank.gather_host(self.members,
                                     torch.tensor([float(x)], dtype=F64))

    def any(self, flag: bool) -> bool:
        return bool((self._all(flag) != 0).any())

    def max(self, x: float) -> float:
        return float(torch.amax(self._all(x)))

    def trips(self, t: int) -> int:
        return int(torch.amax(self._all(t)))


def ordered(G):
    """((G[0] + G[1]) + G[2]) + ...: a gathered psum in rank order, as
    the one-process forms sum the blocks."""
    total = G[0]
    for q in range(1, G.shape[0]):
        total = total + G[q]
    return total


class _RowGroup(BlockSums):
    """A rank's link to the ranks of its row group (`members`, one a row
    block, in block order), which the loops of sharding.py and the steps of
    kernels.py take over a mesh: the layout of the blocks (rows, vecs, i,
    and lanes, the whole batch's B), the gathers, and the psum and pmax of
    the plain loops, each a gather combined in rank order. `spent` keeps
    the seconds of the gathers by what they carry."""

    def __init__(self, rk, blk, members, lanes=None):
        self.rk, self.members = rk, members
        self.rows, self.vecs, self.i = blk.rows, blk.vecs, blk.i
        self.lanes = lanes
        self.spent = {}

    def gather(self, t, what: str):
        t0 = perf_counter()
        G = self.rk.gather(self.members, t)
        self.spent[what] = self.spent.get(what, 0.0) + perf_counter() - t0
        return G

    def __call__(self, sums, maxes=None, what: str = "dots"):
        k = sums[0].numel()
        flat = sums.reshape(-1) if maxes is None else torch.cat(
            [sums.reshape(-1), maxes.reshape(-1)])
        G = self.gather(flat, what)
        total = ordered(G[:, :k]).view(sums.shape[1:])
        if maxes is None:
            return total, None
        return total, torch.amax(G[:, k:], dim=0).view(maxes.shape)


# -- what a rank holds ----------------------------------------------------------
class _RowBlock:
    """Row block i of nr of A on one rank: [A_i] and [A_i'] as K1 and K5
    take them, with the rank's rows as `bounds`, as the plain loops take
    a ShardedNormalMatrix (its block i alone); the layout of all blocks
    (rows, K1 lanes a row); and on a card A_i' lane-aligned for K14v at the
    whole A''s lanes a row."""

    def __init__(self, A: sp.csc_matrix, nr: int, i: int, device):
        m, n = A.shape
        self.m, self.n, self.nr, self.i = m, n, nr, i
        self.rows = block_sizes(m, nr)
        if not all(self.rows):
            raise ValueError(f"{m} rows in {nr} blocks of "
                             f"{self.rows[0]} leave a rank of the mesh "
                             f"with none")
        bounds = _bounds(self.rows)
        A_csr = A.tocsr()
        A_csr.sort_indices()
        A_csc = A_csr.tocsc()
        A_csc.sort_indices()
        self.vecs = [kernels.k1_lanes_of(int(A_csr.indptr[r1]
                                             - A_csr.indptr[r0]), r1 - r0)
                     for r0, r1 in bounds]
        self.own = r0, r1 = bounds[i]
        Ab = A_csr[r0:r1]
        Abc = Ab.tocsc()
        Abc.sort_indices()
        self.bounds = [(0, r1 - r0)]
        self.op_A = [CsrOperand(Ab.indptr, Ab.indices, Ab.data, n, device,
                                F64)]
        # the CSC arrays of A_i are the CSR arrays of A_i'
        self.op_At = [CsrOperand(Abc.indptr, Abc.indices, Abc.data, r1 - r0,
                                 device, F64)]
        self.op_At_lane = None
        if device.type == "cuda":
            self.op_At_lane = lane_aligned(
                A_csc.indptr, A_csc.indices, A_csc.data, r0, r1,
                lanes_per_row(A_csc.indptr), device)


class _ColBlock:
    """Column block p of N on one rank: N_p' and N_p as K4 takes them at
    P = 1 (sharding.py's ShardedSplittedNNt.blocks[p]); on a card at the
    whole operand's lanes a row, N_p lane-aligned, and K4 bound to them."""

    def __init__(self, N: sp.csc_matrix, P: int, p: int, device):
        m = N.shape[0]
        c0, c1 = _bounds(block_sizes(N.shape[1], P))[p]
        Nb = N[:, c0:c1]
        self.kernel = None
        if device.type == "cpu":
            Nr = Nb.tocsr()
            self.Nt = CsrOperand(Nb.indptr, Nb.indices, Nb.data, m, device,
                                 F64)
            self.N = CsrOperand(Nr.indptr, Nr.indices, Nr.data, c1 - c0,
                                device, F64)
            return
        Nr = N.tocsr()
        Nr.sort_indices()
        self.Nt = CsrOperand(Nb.indptr, Nb.indices, Nb.data, m, device, F64)
        self.Nt.vec = lanes_per_row(N.indptr)
        self.N = lane_aligned(Nr.indptr, Nr.indices, Nr.data, c0, c1,
                              lanes_per_row(Nr.indptr), device)
        self.kernel = kernels.NntKernel(self.Nt, self.N)

    def apply(self, w: torch.Tensor) -> torch.Tensor:
        if self.kernel is None:
            return nnt_plain(self.Nt, self.N, w)
        return self.kernel.launch(w)


def _since(before: dict) -> dict:
    """The kernels' launches in this process since `before`."""
    return {name: kernels.LAUNCHES[name] - before[name] for name in before}


# -- one rank --------------------------------------------------------------------
class _Rank:
    """One rank's groups, blocks and ops; rank 0's lives in the caller's
    process, the others' in the workers."""

    def __init__(self, store, rank: int, size: int, devices, timeout: float):
        self.rank, self.size, self.store = rank, size, store
        self.device = torch.device(devices[rank])
        self.transport, self.staged = transport_of(devices)
        self.timeout = datetime.timedelta(seconds=timeout)
        self.cmd = _group(dist.PrefixStore("cmd", store), rank, size, "gloo",
                          IDLE, "ipxt_mesh_cmd")
        self.host = _group(dist.PrefixStore("host", store), rank, size,
                           "gloo", self.timeout, "ipxt_mesh_host")
        self._groups = {}
        self._pinned = {}
        self.blocks = {}
        self.coll_s = 0.0       # seconds in gathers, with their staging

    # -- groups and collectives ----------------------------------------------
    def group(self, members: tuple, host: bool = False):
        """The group of the ranks `members` (gloo on the host, or the
        transport's), built by its members at its first use."""
        if host or self.transport == "gloo":
            if members == tuple(range(self.size)):
                return self.host
            kind = "gloo"
        else:
            kind = "nccl"
        key = (kind, members)
        if key not in self._groups:
            name = f"{kind}-" + "-".join(map(str, members))
            self._groups[key] = _group(
                dist.PrefixStore(name, self.store), members.index(self.rank),
                len(members), kind, self.timeout, "ipxt_mesh_" + name)
        return self._groups[key]

    def _pin(self, name: str, n: int, dtype=F64) -> torch.Tensor:
        key = (name, n, dtype)
        if key not in self._pinned:
            self._pinned[key] = torch.empty(n, dtype=dtype, pin_memory=True)
        return self._pinned[key]

    def gather(self, members: tuple, t: torch.Tensor) -> torch.Tensor:
        """(len(members), t.numel()) of every member's t, in member order,
        over the transport: on the card's stream with NCCL, through pinned
        host buffers when gloo moves card tensors (the result then on the
        host), on the CPU otherwise."""
        t0 = perf_counter()
        k, c = len(members), t.numel()
        g = self.group(members)
        if self.staged:
            send = self._pin("send", c, t.dtype)
            send.copy_(t.reshape(-1))
            out = self._pin("recv", k * c, t.dtype)
            _ALL_GATHER(out, send, group=g)
        else:
            out = torch.empty(k * c, dtype=t.dtype, device=t.device)
            _ALL_GATHER(out, t.reshape(-1).contiguous(), group=g)
        self.coll_s += perf_counter() - t0
        return out.view(k, c)

    def gather_host(self, members: tuple, t: torch.Tensor) -> torch.Tensor:
        """gather() of a host tensor over gloo, whatever the transport."""
        t0 = perf_counter()
        out = torch.empty(len(members) * t.numel(), dtype=t.dtype)
        _ALL_GATHER(out, t.reshape(-1).contiguous(),
                    group=self.group(members, host=True))
        self.coll_s += perf_counter() - t0
        return out.view(len(members), -1)

    def bcast(self, arrays=None) -> list:
        """Rank 0's 1-D numpy arrays (float64 or int64, at most MAX_ARRAYS)
        on every rank, in three broadcasts over the host group."""
        meta = torch.zeros(1 + 2 * MAX_ARRAYS, dtype=I64)
        if self.rank == 0:
            if len(arrays) > MAX_ARRAYS:
                raise ValueError("too many arrays for one payload")
            arrays = [np.ascontiguousarray(
                a, dtype=np.int64 if np.issubdtype(np.asarray(a).dtype,
                                                   np.integer)
                else np.float64).ravel() for a in arrays]
            meta[0] = len(arrays)
            for k, a in enumerate(arrays):
                meta[1 + 2 * k] = int(a.dtype == np.int64)
                meta[2 + 2 * k] = a.size
        dist.broadcast(meta, group=self.host, group_src=0)
        count = int(meta[0])
        kinds = [int(meta[1 + 2 * k]) for k in range(count)]
        sizes = [int(meta[2 + 2 * k]) for k in range(count)]
        packs = {}
        for kind, dtype in ((1, I64), (0, F64)):
            total = sum(s for s, k in zip(sizes, kinds) if k == kind)
            if self.rank == 0:
                pack = torch.from_numpy(np.concatenate(
                    [a for a, k in zip(arrays, kinds) if k == kind]
                    or [np.zeros(0, dtype=np.int64 if kind else np.float64)]))
            else:
                pack = torch.empty(total, dtype=dtype)
            if total:
                dist.broadcast(pack, group=self.host, group_src=0)
            packs[kind] = pack.numpy()
        out, at = [], {0: 0, 1: 0}
        for s, k in zip(sizes, kinds):
            out.append(packs[k][at[k]:at[k] + s])
            at[k] += s
        return out

    def ack(self) -> None:
        """Every rank's word that it finished the op: a worker that failed
        has exited, and the gather fails on rank 0."""
        self.gather_host(tuple(range(self.size)), torch.zeros(1, dtype=F64))

    def send(self, t: torch.Tensor, rank: int) -> None:
        """A host tensor to `rank`, point to point over the host group."""
        self.host.send([t.contiguous()], rank, 0).wait()

    def recv_from(self, rank: int, shape) -> torch.Tensor:
        t = torch.empty(shape, dtype=F64)
        self.host.recv([t], rank, 0).wait()
        return t

    # -- ops ---------------------------------------------------------------
    def run(self, hdr: torch.Tensor, data=None):
        """The op of command `hdr`, rank 0 giving `data`."""
        op = int(hdr[0])
        ops = {LOAD_ROWS: self.load_rows, CR: self.cr,
               BATCHED_CR: self.batched_cr, SET_NNT: self.set_nnt,
               NNT: self.nnt, STEP: self.step}
        if op not in ops:
            raise ValueError(f"unknown mesh op {op}")
        return ops[op](hdr, data)

    def _block(self, key: int):
        if key not in self.blocks:
            raise KeyError(f"rank {self.rank} holds no operator {key}")
        return self.blocks[key]

    def load_rows(self, hdr, A):
        key, nr, nb, m, n = (int(v) for v in hdr[1:6])
        if self.rank == 0:
            A = sp.csc_matrix(A)
            arrays = [A.indptr, A.indices, A.data]
        ptr, idx, val = self.bcast(arrays if self.rank == 0 else None)
        A = sp.csc_matrix((val, idx, ptr), shape=(m, n))
        i = self.rank // nb
        self.blocks[key] = _RowBlock(A, nr, i, self.device)
        self.ack()

    def cr(self, hdr, data):
        key, nr, nb, ladder, has_rs, maxiter = (int(v) for v in hdr[1:7])
        tol = float(hdr[7])
        blk = self._block(key)
        arrays = self.bcast(data if self.rank == 0 else None)
        Ws, Wl, invd = arrays[:3]
        rs = arrays[3] if has_rs else None
        rhs = arrays[-1]
        members = tuple(i * nb for i in range(nr))
        out = None
        if self.rank in members:
            t0, c0 = perf_counter(), self.coll_s
            link = _RowGroup(self, blk, members)
            before = dict(kernels.LAUNCHES)
            y, it, err, resnorm = self._cr(blk, link, Ws, Wl, invd, rs, rhs,
                                           tol, maxiter, bool(ladder))
            out = (y, it, err, resnorm, perf_counter() - t0,
                   self.coll_s - c0, link.spent.get("parts", 0.0),
                   _since(before))
        return self._collect_rows(blk, members, out)

    def _cr(self, blk, link, Ws, Wl, invd, rs, rhs, tol, maxiter, ladder):
        """The rank's row-blocked CR on its own block: sharding.py's plain
        loop on its rows (the CPU), or K15's host-issued passes over its
        virtual blocks (the card), the sums over blocks through `link`."""
        r0, r1 = blk.own

        def t(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

        if self.device.type == "cpu":
            y, it, err, resnorm = sharded_cr_plain(
                blk, t(Ws), t(Wl[r0:r1]), t(invd[r0:r1]),
                None if rs is None else t(rs[r0:r1]), t(rhs[r0:r1]), tol,
                maxiter, ladder, psum=link)
            return y.numpy(), it, err, resnorm
        step = kernels.ShardedCrStep(
            blk.op_At_lane, blk.op_A, t(Ws), t(Wl), t(invd),
            None if rs is None else t(rs), t(rhs), ladder, rank=link)
        y, it, err, resnorm = step.solve(maxiter, tol, cooperative=False)
        return y[r0:r1].cpu().numpy(), it, err, resnorm

    def _collect_rows(self, blk, members, out):
        """Rank 0's (y, iterations, error, resnorm, per-rank stats) from the
        members' results: a host gather of a record and the rows each."""
        width = 10 + max(blk.rows)
        rec = torch.zeros(width, dtype=F64)
        if out is not None:
            y, it, err, resnorm, secs, coll, parts, launches = out
            rec[:10] = torch.tensor([it, err, resnorm, secs, coll, parts] + [
                launches.get(k, 0) for k in ("sharded_cr_step",
                                             "block_spmv_sum", "block_sum",
                                             "csr_spmv")], dtype=F64)
            rec[10:10 + y.size] = torch.from_numpy(y)
        G = self.gather_host(tuple(range(self.size)), rec)
        if self.rank != 0:
            return None
        y = np.concatenate([G[r, 10:10 + blk.rows[q]].numpy()
                            for q, r in enumerate(members)])
        stats = [dict(rank=r, trips=int(G[r, 0]), seconds=float(G[r, 3]),
                      collective_s=float(G[r, 4]), parts_s=float(G[r, 5]),
                      k15_launches=int(G[r, 6]), k14v_launches=int(G[r, 7]),
                      k14_launches=int(G[r, 8]), k1_launches=int(G[r, 9]))
                 for r in members]
        return y, int(G[0, 0]), int(G[0, 1]), float(G[0, 2]), stats

    def batched_cr(self, hdr, data):
        key, nr, nb, maxiter, B = (int(v) for v in hdr[1:6])
        tol = float(hdr[6])
        blk = self._block(key)
        i, j = divmod(self.rank, nb)
        Bl = B // nb
        l0, l1 = j * Bl, (j + 1) * Bl
        r0, r1 = blk.own
        rows_of = block_sizes(blk.m, nr)
        own = [(a, b) for a, b in _bounds(rows_of)]
        # rank 0 sends every rank its rows and lanes
        if self.rank == 0:
            Ws, Wl, invd, RHS = data
            for r in range(1, self.size):
                ri, rj = divmod(r, nb)
                a, b = own[ri]
                q0, q1 = rj * Bl, (rj + 1) * Bl
                for x, rows in ((Ws, slice(None)), (Wl, slice(a, b)),
                                (invd, slice(a, b)), (RHS, slice(a, b))):
                    self.send(torch.from_numpy(np.ascontiguousarray(
                        x[rows, q0:q1])), r)
            mine = [np.ascontiguousarray(x[rows, l0:l1]) for x, rows in
                    ((Ws, slice(None)), (Wl, slice(r0, r1)),
                     (invd, slice(r0, r1)), (RHS, slice(r0, r1)))]
            mine = [torch.from_numpy(x) for x in mine]
        else:
            mine = [self.recv_from(0, (blk.n, Bl))] + [
                self.recv_from(0, (r1 - r0, Bl)) for _ in range(3)]
        members = tuple(q * nb + j for q in range(nr))
        t0, c0 = perf_counter(), self.coll_s
        link = _RowGroup(self, blk, members, lanes=B)
        before = dict(kernels.LAUNCHES)
        if self.device.type == "cpu":
            Y, trips = sharded_batched_cr_plain(blk, *mine, tol, maxiter,
                                                psum=link)
            exact = True
        else:
            step = kernels.ShardedBatchedCrStep(
                None, blk.op_At, blk.op_A,
                *(x.to(self.device) for x in mine), rank=link)
            Y, trips = step.solve(maxiter, tol)
            Y, exact = Y.cpu(), step.exact
        launches = _since(before)
        rec = torch.tensor([trips, perf_counter() - t0, self.coll_s - c0,
                            launches.get("sharded_batched_cr_step", 0),
                            launches.get("csr_spmm", 0),
                            launches.get("block_sum", 0), exact], dtype=F64)
        G = self.gather_host(tuple(range(self.size)), rec)
        if self.rank != 0:
            self.send(Y, 0)
            return None
        Yfull = np.empty((blk.m, B))
        Yfull[r0:r1, l0:l1] = Y.numpy()
        for r in range(1, self.size):
            ri, rj = divmod(r, nb)
            a, b = own[ri]
            Yfull[a:b, rj * Bl:(rj + 1) * Bl] = self.recv_from(
                r, (b - a, Bl)).numpy()
        stats = [dict(rank=r, trips=int(G[r, 0]), seconds=float(G[r, 1]),
                      collective_s=float(G[r, 2]),
                      k16_launches=int(G[r, 3]), k5_launches=int(G[r, 4]),
                      k14_launches=int(G[r, 5]), exact=bool(G[r, 6]))
                 for r in range(self.size)]
        return Yfull, int(torch.amax(G[:, 0])), stats

    def set_nnt(self, hdr, N):
        """Column block i of nr on rank (i, 0), for each i."""
        key, m, n, nr, nb = (int(v) for v in hdr[1:6])
        if self.rank == 0:
            N = sp.csc_matrix(N, copy=True)
            N.sort_indices()
            arrays = [N.indptr, N.indices, N.data]
        ptr, idx, val = self.bcast(arrays if self.rank == 0 else None)
        if self.rank % nb == 0:
            N = sp.csc_matrix((val, idx, ptr), shape=(m, n))
            self.blocks[key] = _ColBlock(N, nr, self.rank // nb, self.device)
        self.ack()

    def nnt(self, hdr, w):
        key, nr, nb = (int(v) for v in hdr[1:4])
        (w,) = self.bcast([w] if self.rank == 0 else None)
        if self.rank % nb:
            return None
        blk = self._block(key)
        w = torch.from_numpy(w).to(self.device)
        k4 = kernels.LAUNCHES["nnt"]
        z = blk.apply(w)
        # the rank's K4 launches ride at the end of its z
        zk = torch.cat([z, torch.tensor([kernels.LAUNCHES["nnt"] - k4],
                                        dtype=F64, device=z.device)])
        G = self.gather(tuple(i * nb for i in range(nr)), zk)
        if self.rank != 0:
            return None
        k4 = [int(v) for v in G[:, -1].tolist()]
        G = G[:, :-1]
        if self.device.type == "cpu":
            return block_sum_plain(G).numpy(), k4
        parts = G.to(self.device)
        return kernels.block_sum(parts).cpu().numpy(), k4

    def step(self, hdr, data):
        """One batched IPM step on the rank's lane group: the LP and the
        state come from rank 0, the rank keeps the lanes of its group, the
        step's lane reductions are gathered over the ranks."""
        from .batch import BatchedLp, BatchedPhase1Solver
        m, n, B, maxiter = (int(v) for v in hdr[1:5])
        keys = ("X", "XL", "XU", "Y", "ZL", "ZU", "done", "iters", "mu")
        if self.rank == 0:
            lp, S = data
            A = sp.csc_matrix(lp.A)
            arrays = [A.indptr, A.indices, A.data, lp.b, lp.c, lp.lb, lp.ub,
                      *(S[k].to(F64).cpu().numpy() for k in keys),
                      np.array([float(S["cr"])])]
        got = self.bcast(arrays if self.rank == 0 else None)
        A = sp.csc_matrix((got[2], got[1], got[0]), shape=(m, n))
        lp = BatchedLp(A=A, b=got[3].reshape(B, m), c=got[4].reshape(B, -1),
                       lb=got[5], ub=got[6])
        Bl = B // self.size
        l0, l1 = self.rank * Bl, (self.rank + 1) * Bl
        solver = BatchedPhase1Solver(lp, maxiter=maxiter,
                                     device=self.device.type)
        solver.take_lanes(l0, l1, _MeshLanes(self, tuple(range(self.size))))
        state = {}
        for k, a in zip(keys, got[7:7 + len(keys)]):
            full = torch.from_numpy(a.reshape((-1, B) if a.size != B
                                              else (B,)))
            full = full[..., l0:l1].contiguous()
            if k == "done":
                full = full != 0
            elif k == "iters":
                full = full.to(torch.int64)
            state[k] = full.to(self.device)
        state["cr"] = int(got[-1][0])
        out = solver._ipm_step(state)
        flat = torch.cat([out[k].to(F64).reshape(-1).cpu() for k in keys]
                         + [torch.tensor([float(out["cr"])], dtype=F64)])
        G = self.gather_host(tuple(range(self.size)), flat)
        if self.rank != 0:
            return None
        res, at = {}, 0
        for k in keys:
            size = out[k].numel()
            shape = tuple(out[k].shape)
            pieces = [G[r, at:at + size].view(shape) for r in
                      range(self.size)]
            res[k] = torch.cat(pieces, dim=-1)
            at += size
        res = {k: v.to(self.device) for k, v in res.items()}
        res["done"] = res["done"] != 0
        res["iters"] = res["iters"].to(torch.int64)
        res["cr"] = int(G[0, -1])
        return res


# -- the workers -------------------------------------------------------------------
def _worker(rank: int, size: int, port: int, devices, timeout: float,
            threads: int) -> None:
    """A worker's life: bound to its device, it joins the groups, loads the
    kernel library on a card, then runs rank 0's commands until CLOSE. An
    exception is stored for rank 0 and ends the process."""
    store = None
    try:
        device = torch.device(devices[rank])
        if device.type == "cuda":
            torch.cuda.set_device(device)
        torch.set_num_threads(threads)
        store = dist.TCPStore("127.0.0.1", port, size, False,
                              timeout=datetime.timedelta(seconds=timeout))
        rk = _Rank(store, rank, size, devices, timeout)
        if device.type == "cuda":
            kernels.load()
        while True:
            hdr = torch.empty(HEADER, dtype=F64)
            dist.broadcast(hdr, group=rk.cmd, group_src=0)
            if int(hdr[0]) == CLOSE:
                break
            rk.run(hdr)
    except BaseException:
        if store is not None:
            try:
                store.set(f"ipxt_error/{rank}", traceback.format_exc())
            except Exception:
                pass
        os._exit(1)
    os._exit(0)


def _close_all() -> None:
    for ranks in list(_OPEN):
        ranks.close()


atexit.register(_close_all)


class _Ranks:
    """The processes of a mesh: rank 0 here, the workers, the store."""

    def __init__(self, devices, timeout: float):
        import torch.multiprocessing as mp
        size = len(devices)
        self.devices, self.size, self.timeout = devices, size, timeout
        self.transport, self.staged = transport_of(devices)
        if torch.device(devices[0]).type == "cuda":
            kernels.load()      # built once, here; the workers load it
        self.store = dist.TCPStore(
            "127.0.0.1", 0, size, True,
            timeout=datetime.timedelta(seconds=timeout),
            wait_for_workers=False)
        ctx = mp.get_context("spawn")
        threads = max(1, (os.cpu_count() or 1) // size)
        self.procs = [ctx.Process(target=_worker, daemon=True,
                                  args=(r, size, self.store.port, devices,
                                        timeout, threads))
                      for r in range(1, size)]
        self.closed = False
        self.uid = next(_UIDS)
        self.launches = {}      # rank -> {kernel: launches} of its ops
        self._next = 0
        for p in self.procs:
            p.start()
        try:
            self.rank0 = _Rank(self.store, 0, size, devices, timeout)
        except BaseException as exc:
            msg = self.errors()
            self.close(force=True)
            raise MeshError(f"the mesh's ranks did not start: {exc}\n{msg}"
                            ) from exc

    def tally(self, rank: int, counts: dict) -> None:
        mine = self.launches.setdefault(rank, {})
        for name, v in counts.items():
            mine[name] = mine.get(name, 0) + int(v)

    def new_key(self) -> int:
        self._next += 1
        return self._next

    def errors(self) -> str:
        """The workers' stored tracebacks and the exit codes of those that
        ended."""
        out = []
        for r, p in enumerate(self.procs, start=1):
            key = f"ipxt_error/{r}"
            try:
                if self.store.check([key]):
                    out.append(f"rank {r} raised:\n"
                               + self.store.get(key).decode())
                    continue
            except Exception:
                pass
            if p.exitcode is not None:
                out.append(f"rank {r} ended with exit code {p.exitcode}")
        return "\n".join(out)

    def call(self, op: int, ints=(), floats=(), data=None):
        """Runs op on every rank, rank 0's part here with `data`; any
        failure closes the mesh and raises MeshError with what the workers
        left."""
        if self.closed:
            raise MeshError("the mesh is closed")
        dead = [p for p in self.procs if p.exitcode is not None]
        if dead:
            msg = self.errors()
            self.close(force=True)
            raise MeshError(f"a rank of the mesh has ended:\n{msg}")
        hdr = torch.zeros(HEADER, dtype=F64)
        vals = [op, *ints, *floats]
        hdr[:len(vals)] = torch.tensor([float(v) for v in vals], dtype=F64)
        try:
            dist.broadcast(hdr, group=self.rank0.cmd, group_src=0)
            return self.rank0.run(hdr, data)
        except BaseException as exc:
            # give a worker that failed time to store its traceback
            for p in self.procs:
                p.join(timeout=0.5)
            msg = self.errors()
            self.close(force=True)
            raise MeshError(f"mesh op {OPS.get(op, op)!r} failed: {exc}\n"
                            f"{msg}") from exc

    def close(self, force: bool = False) -> None:
        if self.closed:
            return
        self.closed = True
        if not force:
            try:
                hdr = torch.zeros(HEADER, dtype=F64)
                hdr[0] = CLOSE
                dist.broadcast(hdr, group=self.rank0.cmd, group_src=0)
            except Exception:
                force = True
        for p in self.procs:
            p.join(timeout=0.0 if force else self.timeout)
            if p.exitcode is None:
                p.kill()
                p.join(timeout=5.0)
        rank0 = getattr(self, "rank0", None)
        for (kind, _), g in (rank0._groups.items() if rank0 else ()):
            if kind == "nccl":      # NCCL's communicators, ended here
                try:
                    g.abort() if force else g.shutdown()
                except Exception:
                    pass


class Mesh:
    """P ranks, one process each, laid out as `shape` over `axis_names`
    ("rows",), ("batch",) or ("rows", "batch"), rank (i, j) = i * nb + j;
    `devices` the P devices, "cpu" (the plain versions) or "cuda:k" (the
    kernels; ranks may share a card). `timeout` (seconds) bounds the start
    and every collective. `with mesh:` makes it the active mesh, as jax's
    `with Mesh(...)`; close() ends the workers. reshape() lays the same
    ranks out anew, as the reference makes several meshes of one device
    list. The workers start from the "spawn" context, which imports the
    caller's main module in each: a script that makes a mesh keeps its
    work under `if __name__ == "__main__":`."""

    def __init__(self, shape, axis_names=("rows",), devices=None,
                 timeout: float = 120.0, _ranks=None):
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names) or axis_names not in (
                ("rows",), ("batch",), ("rows", "batch")):
            raise ValueError(f"axes {axis_names} of shape {shape}: a mesh "
                             f"has ('rows',), ('batch',) or ('rows', "
                             f"'batch')")
        size = int(np.prod(shape))
        self.shape, self.axis_names, self.size = shape, axis_names, size
        if _ranks is None:
            if devices is None:
                raise ValueError("a mesh needs its devices")
            _ranks = _Ranks(_devices(devices, size), timeout)
            _OPEN.add(_ranks)
        self._ranks = _ranks
        self.devices = _ranks.devices
        self.device = torch.device(self.devices[0])
        self.transport, self.staged = _ranks.transport, _ranks.staged
        self.uid = _ranks.uid
        self.last = None        # the result of the last solve, with stats

    def launches(self) -> dict:
        """{rank: {kernel: launches}} of the mesh's CR solves, batched CR
        solves and N N' applies since reset_launches(), as each rank counted
        its own (kernels.LAUNCHES there)."""
        return {r: dict(c) for r, c in sorted(self._ranks.launches.items())}

    def reset_launches(self) -> None:
        self._ranks.launches.clear()

    def axis_size(self, name: str) -> int:
        return (self.shape[self.axis_names.index(name)]
                if name in self.axis_names else 1)

    @property
    def layout(self) -> tuple:
        """(rows, batch): the ranks of each axis."""
        return self.axis_size("rows"), self.axis_size("batch")

    def reshape(self, shape, axis_names) -> "Mesh":
        view = Mesh(shape, axis_names, _ranks=self._ranks)
        if view.size != self.size:
            raise ValueError(f"shape {shape} does not hold {self.size} ranks")
        return view

    @property
    def closed(self) -> bool:
        return self._ranks.closed

    def describe(self) -> str:
        how = ("gloo through pinned host buffers" if self.staged
               else self.transport)
        return (f"mesh {dict(zip(self.axis_names, self.shape))} on "
                f"{self.devices}: {how}")

    def close(self) -> None:
        self._ranks.close()

    def __enter__(self):
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return False

    # -- the ops -------------------------------------------------------------
    def load_rows(self, A: sp.csc_matrix, num_blocks: int) -> int:
        """Puts row block i of A's num_blocks on rank (i, j) of every lane
        group j; returns the operator's key."""
        nr, nb = self.layout
        if nr != num_blocks:
            raise ValueError(f"{num_blocks} row blocks on a mesh of {nr} "
                             f"rows")
        m, n = A.shape
        if not all(block_sizes(m, nr)):
            raise ValueError(f"{m} rows leave a rank of a {nr}-row mesh "
                             f"with none")
        key = self._ranks.new_key()
        self._ranks.call(LOAD_ROWS, (key, nr, nb, m, n), data=A)
        return key

    def cr_solve(self, key: int, W_struct, W_slack, invd, resscale, rhs,
                 tol: float, maxiter: int, ladder: bool):
        """One row-blocked CR solve on the operator `key` over the ranks of
        lane group 0. Returns (y, iterations, error code, residual norm,
        per-rank stats)."""
        nr, nb = self.layout
        data = [W_struct, W_slack, invd] + ([resscale] if resscale is not
                                            None else []) + [rhs]
        self.last = self._ranks.call(
            CR, (key, nr, nb, int(ladder), int(resscale is not None),
                 maxiter), (tol,), data=data)
        for st in self.last[-1]:
            self._ranks.tally(st["rank"], {
                "sharded_cr_step": st["k15_launches"],
                "block_spmv_sum": st["k14v_launches"],
                "block_sum": st["k14_launches"],
                "csr_spmv": st["k1_launches"]})
        return self.last

    def batched_cr_solve(self, key: int, W_struct, W_slack, invd, RHS,
                         tol: float, maxiter: int):
        """sharded_batched_cr_solve on the operator `key`: rank (i, j) row
        block i and lanes j B / nb .. (j + 1) B / nb. Returns (Y (m, B),
        trips (the most of any lane group), per-rank stats); a rank's
        `exact` says whether its grids were the one card's (module
        docstring)."""
        nr, nb = self.layout
        B = RHS.shape[1]
        if B % nb:
            raise ValueError(f"B = {B} lanes do not split over {nb} ranks")
        self.last = self._ranks.call(
            BATCHED_CR, (key, nr, nb, maxiter, B), (tol,),
            data=(W_struct, W_slack, invd, RHS))
        for st in self.last[-1]:
            self._ranks.tally(st["rank"], {
                "sharded_batched_cr_step": st["k16_launches"],
                "csr_spmm": st["k5_launches"],
                "block_sum": st["k14_launches"]})
        return self.last

    def set_nnt(self, N, num_blocks: int, key: int = None) -> int:
        """Puts column block i of N's num_blocks on rank (i, 0) (the rows
        axis has num_blocks ranks); returns the operator's key, `key` if
        given (a new epoch of the same operator)."""
        nr, nb = self.layout
        if nr != num_blocks:
            raise ValueError(f"{num_blocks} column blocks on a mesh of "
                             f"{nr} rows")
        key = self._ranks.new_key() if key is None else key
        m, n = N.shape
        self._ranks.call(SET_NNT, (key, m, n, nr, nb), data=N)
        return key

    def nnt_apply(self, key: int, w: np.ndarray) -> np.ndarray:
        """sum_i N_i (N_i' w) in block order, on the host."""
        nr, nb = self.layout
        before = kernels.LAUNCHES["block_sum"]
        z, k4 = self._ranks.call(NNT, (key, nr, nb),
                                 data=np.asarray(w, np.float64))
        for i, k in enumerate(k4):
            self._ranks.tally(i * nb, {"nnt": k})
        self._ranks.tally(0, {"block_sum": kernels.LAUNCHES["block_sum"]
                              - before})
        return z

    def step(self, lp, state: dict, maxiter: int) -> dict:
        """One batched IPM step of BatchedPhase1Solver(lp, maxiter) from
        `state`, its B lanes split over the ranks in order."""
        B = lp.b.shape[0]
        if B % self.size:
            raise ValueError(f"B = {B} lanes do not split over {self.size} "
                             f"ranks")
        m, n = lp.A.shape
        return self._ranks.call(STEP, (m, n, B, maxiter),
                                data=(lp, state))


def make_row_mesh(num_blocks: int, device: str = "cuda",
                  timeout: float = 120.0) -> Mesh:
    """A ("rows",) mesh of num_blocks ranks, the counterpart of the
    reference's: "cuda", cards 0..num_blocks-1 (raises with fewer); "cuda:k"
    the ranks all on card k; "torch_cpu" or "cpu", on the CPU."""
    if device == "cuda":
        have = torch.cuda.device_count()
        if have < num_blocks:
            raise RuntimeError(f"shards={num_blocks} but only {have} cards "
                               f"visible")
        devices = [f"cuda:{k}" for k in range(num_blocks)]
    elif device in ("torch_cpu", "cpu"):
        devices = ["cpu"] * num_blocks
    else:
        devices = [device] * num_blocks
    return Mesh((num_blocks,), ("rows",), devices, timeout)
