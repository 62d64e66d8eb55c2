"""The reference's device mesh as one process per rank (ipx_tpu_torch/
parallel/mesh.py) on the CPU: 4 gloo ranks, spawned once for the module.

Held, with these tolerances:

* bit for bit against the port's one-process P-block forms on "torch_cpu"
  (parallel/sharding.py's plain versions): sharded_cr_solve,
  ShardedDiagCR.solve (converged, at the iteration limit, and on the error
  ladder), the column-blocked N N' apply, and the 2 x 2 rows x batch
  batched CR; every sum over ranks is a gather combined in rank order, in
  the one-process order;
* against ipx_tpu.parallel.sharding on 4 (and 2 x 2) of the 8 virtual CPU
  devices of tests/conftest.py: y within 1e-10 relative after five trips
  with the same trip counts, converged solves by their normal-equation
  residual (1e-9) with iteration counts within 2 of the reference's, N N'
  within 1e-12;
* LpSolver(shards=4) inside `with mesh:` at status 1000, pobjval within
  1e-8 of ipx_tpu's shards=4 solve;
* the batched IPM step with its lanes split over the 4 ranks: the same
  CR trips, done flags and iteration counts as one process and the iterate
  within 1e-12 (torch sums a (rows, B) array over its rows in an order
  that follows B, so lane groups of other widths round differently);
* a worker that raises, or is killed, makes rank 0 raise MeshError within
  the mesh's timeout, with the worker's traceback; dryrun_multichip(4)
  passes over the mesh.

Every mesh here has a timeout of TIMEOUT seconds on its start and on each
collective, so a fault fails a test instead of hanging the run.
"""
import datetime
import re
import time

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import torch.distributed as dist

import jax
from jax.sharding import Mesh as JaxMesh

import ipx_tpu
import ipx_tpu_torch
from ipx_tpu.parallel import sharding as ref
from ipx_tpu_torch import backend, entry, kernels, testgen
from ipx_tpu_torch.ops.spmv import lanes_per_row, split_spmv_plain, \
    CsrOperand
from ipx_tpu_torch.parallel import mesh as pm
from ipx_tpu_torch.parallel import sharding as port

from lp_fixtures import random_lp

CPU = torch.device("cpu")
NB = 4
TIMEOUT = 60.0
CASES = [pytest.param(64, 90, 11, id="m64"),
         pytest.param(61, 90, 12, id="m61-ragged")]


@pytest.fixture(scope="module")
def mesh():
    m = pm.make_row_mesh(NB, "torch_cpu", timeout=TIMEOUT)
    yield m
    m.close()


def _system(m, n, seed, B=None):
    """A, W (n + m[, B]), diag, rhs (m[, B]) as tests/test_sharded.py makes
    them."""
    a = random_lp(m, n, density=0.15, seed=seed)
    A = sp.csc_matrix((a["Ax"], a["Ai"], a["Ap"]), shape=(m, n))
    rng = np.random.default_rng(seed)
    shape = (n + m,) if B is None else (n + m, B)
    W = rng.uniform(0.5, 2.0, size=shape)
    A2 = A.copy()
    A2.data = A2.data ** 2
    diag = np.asarray(A2 @ W[:n]) + W[n:]
    rhs = rng.standard_normal(shape[:0] + (m,) + shape[1:])
    return A, W, diag, rhs


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


def _residual(A, W, y, rhs):
    n = A.shape[1]
    res = rhs - (A @ (W[:n] * (A.T @ y)) + W[n:] * y)
    return np.max(np.abs(res)) / max(1.0, np.abs(rhs).max())


def _jax_mesh(shape=(NB,), axes=("rows",)):
    devices = jax.local_devices(backend="cpu")
    k = int(np.prod(shape))
    return JaxMesh(np.array(devices[:k]).reshape(shape), axis_names=axes)


def _cr(A, W, diag, rhs, tol, maxiter, where, mesh=None):
    n = A.shape[1]
    if where == "ref":
        return ref.sharded_cr_solve(ref.ShardedNormalMatrix(A, NB), W[:n],
                                    W[n:], diag, rhs, tol, maxiter,
                                    mesh=_jax_mesh())
    snm = (port.ShardedNormalMatrix(A, NB, mesh=mesh) if where == "mesh"
           else port.ShardedNormalMatrix(A, NB, CPU))
    return port.sharded_cr_solve(snm, W[:n], W[n:], diag, rhs, tol, maxiter)


def _diag(A, W, diag, rhs, tol, maxiter, where, mesh=None):
    n = A.shape[1]
    resscale = 1.0 / np.sqrt(np.abs(W[n:]))
    cr = {"ref": lambda: ref.ShardedDiagCR(A, NB, mesh=_jax_mesh()),
          "mesh": lambda: port.ShardedDiagCR(A, NB, mesh=mesh),
          "one": lambda: port.ShardedDiagCR(A, NB, CPU)}[where]()
    return cr.solve(W[:n], W[n:], diag, resscale, rhs, tol, maxiter)


# -- (a) bit for bit with the one-process forms ---------------------------------
@pytest.mark.parametrize("tol, maxiter", [(1e-10, 2000), (1e-14, 5)],
                         ids=["converged", "five-trips"])
@pytest.mark.parametrize("m, n, seed", CASES)
def test_cr_solve_is_the_one_process_solve(mesh, m, n, seed, tol, maxiter):
    """sharded_cr_solve over the 4 ranks: y and the trips bit for bit."""
    A, W, diag, rhs = _system(m, n, seed)
    want = _cr(A, W, diag, rhs, tol, maxiter, "one")
    got = _cr(A, W, diag, rhs, tol, maxiter, "mesh", mesh)
    assert got[1] == want[1] > 0
    np.testing.assert_array_equal(got[0], want[0])
    stats = mesh.last[-1]
    assert [s["rank"] for s in stats] == [0, 1, 2, 3]
    assert all(s["trips"] == got[1] for s in stats)


@pytest.mark.parametrize("case", ["converged", "limit", "negative_weight",
                                  "negative_weight_positive_diag",
                                  "nan_rhs"])
def test_diag_cr_is_the_one_process_solve(mesh, case):
    """ShardedDiagCR.solve over the 4 ranks, converged, at its iteration
    limit (201) and on the 202/203/205 ladder: y, trips and error code bit
    for bit; the ladder's codes as the one-process solve's."""
    A, W, diag, rhs = _system(61, 90, 12)
    tol, maxiter = (1e-10, 2000) if case == "converged" else (1e-10, 7)
    if case.startswith("negative_weight"):
        W = -W
        if case == "negative_weight":
            diag = -diag
    elif case == "nan_rhs":
        rhs[3] = np.nan
    want = _diag(A, W, diag, rhs, tol, maxiter, "one")
    got = _diag(A, W, diag, rhs, tol, maxiter, "mesh", mesh)
    assert got[1:] == want[1:]
    assert want[2] == {"converged": 0, "limit": 201, "negative_weight": 203,
                       "negative_weight_positive_diag": 202,
                       "nan_rhs": 205}[case]
    np.testing.assert_array_equal(got[0], want[0])


def test_nnt_apply_is_the_one_process_apply(mesh):
    """N N' over 4 column blocks, the last ragged, epoch after epoch: bit
    for bit with the one-process K4 plain version and K14."""
    rng = np.random.default_rng(7)
    one = port.ShardedSplittedNNt(61, 150, NB, CPU)
    over = port.ShardedSplittedNNt(61, 150, NB, mesh=mesh)
    for epoch in range(2):
        N = sp.random(61, 150, density=0.08, format="csc", random_state=rng)
        one.set_operand(N)
        over.set_operand(N)
        for _ in range(2):
            w = rng.standard_normal(61)
            np.testing.assert_array_equal(over.apply(w), one.apply(w))
    assert over.applies == one.applies == 4


@pytest.mark.parametrize("B", [8, 6])
@pytest.mark.parametrize("m, n, seed", CASES)
def test_batched_cr_on_rows_x_batch_is_the_one_process_solve(mesh, m, n,
                                                              seed, B):
    """sharded_batched_cr_solve over a 2 x 2 rows x batch layout of the
    ranks: Y bit for bit with the one-process P = 2 solve over all B lanes,
    each lane group running its own loop; the trips are the most of any
    group's, the one-process loop's."""
    A, W, diag, RHS = _system(m, n, seed, B=B)
    RHS[:, 0] *= 1e-6           # one lane converges well before the rest
    m2 = mesh.reshape((2, 2), ("rows", "batch"))
    snm = port.ShardedNormalMatrix(A, 2, CPU)
    want = port.sharded_batched_cr_solve(snm, W[:n], W[n:], diag, RHS,
                                         1e-10, 2000)
    got = port.sharded_batched_cr_solve(snm, W[:n], W[n:], diag, RHS, 1e-10,
                                        2000, mesh=m2)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] > 0
    trips = {s["rank"]: s["trips"] for s in m2.last[-1]}
    assert trips[0] == trips[2] and trips[1] == trips[3]
    assert max(trips.values()) == got[1]


def test_col_sums_do_not_depend_on_the_lanes():
    """The plain K16's column dots: each column summed as it would be
    alone, whatever the width and the group of columns it comes in; over
    row ranges, each range's sums those of its rows alone."""
    X = torch.from_numpy(np.random.default_rng(2).standard_normal((301, 16)))
    full = port.col_sums(X)
    for h in (1, 4, 8):
        assert torch.equal(torch.cat([port.col_sums(X[:, :h]),
                                      port.col_sums(X[:, h:])]), full)
    assert torch.equal(full[3], X[:, 3].contiguous().sum())
    bounds = [(0, 76), (76, 152), (152, 228), (228, 301)]
    blocks = port.col_sums(X, bounds)
    assert blocks.shape == (4, 16)
    for (r0, r1), got in zip(bounds, blocks):
        assert torch.equal(got, port.col_sums(X[r0:r1]))
        assert torch.equal(got[:8], port.col_sums(X[r0:r1, :8]))


@pytest.mark.parametrize("B, group, want", [
    (256, 128, (1, True)), (64, 32, (1, True)), (256, 256, (2, True)),
    (7, 7, (1, True)), (8, 4, (1, False)), (256, 64, (2, False)),
    (12, 4, (2, False))])
def test_mesh_lane_width_rule(B, group, want):
    """K5's lanes a thread on a rank of `group` of a batch's B lanes: the
    whole batch's lane chunks where K5 can take them, and `exact` only
    where the K16 and K5 grids are the one card's (two lane groups at
    most, each of all B lanes or at least 32)."""
    assert kernels.mesh_lane_width(B, group) == want


def test_private_group_api_fails_loudly(monkeypatch):
    """The mesh's process groups go through torch's private API; on this
    torch a one-rank gloo group is built and gathers, and a torch without
    one of the calls makes MeshError name the version."""
    store = dist.TCPStore("127.0.0.1", 0, 1, True,
                          timeout=datetime.timedelta(seconds=TIMEOUT))
    g = pm._group(dist.PrefixStore("t", store), 0, 1, "gloo",
                  datetime.timedelta(seconds=TIMEOUT), "ipxt_mesh_test")
    out = torch.empty(3, dtype=torch.float64)
    pm._ALL_GATHER(out, torch.arange(3, dtype=torch.float64), group=g)
    assert out.tolist() == [0.0, 1.0, 2.0]

    class NoRegister:
        BackendType = dist.ProcessGroup.BackendType

        def __init__(self, *args):
            pass

    monkeypatch.setattr(pm.dist, "ProcessGroup", NoRegister)
    with pytest.raises(pm.MeshError, match=re.escape(torch.__version__)):
        pm._group(dist.PrefixStore("u", store), 0, 1, "gloo",
                  datetime.timedelta(seconds=TIMEOUT), "ipxt_mesh_test2")


def test_lane_aligned_blocks_keep_the_whole_rows_lanes():
    """The rank's operand of one column block (mesh.lane_aligned): its split
    sum equals the whole operand's segment sum, and each entry sits at the
    lane, counted from its row's first entry, that it has in the whole
    row, at the whole operand's lanes a row."""
    M = sp.random(40, 90, density=0.2, format="csr",
                  random_state=np.random.RandomState(4))
    M.sort_indices()
    vec = lanes_per_row(M.indptr)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(90))
    whole = CsrOperand(M.indptr, M.indices, M.data, 90, CPU, torch.float64,
                       bounds=[0, 30, 60, 90])
    parts = torch.zeros(3 * 40, dtype=torch.float64).index_add_(
        0, whole.slots, whole.vals * x.index_select(0, whole.indices))
    for p, (c0, c1) in enumerate([(0, 30), (30, 60), (60, 90)]):
        op = pm.lane_aligned(M.indptr, M.indices, M.data, c0, c1, vec, CPU)
        assert op.vec == vec and op.cols == c1 - c0
        got = split_spmv_plain(op, x[c0:c1])
        assert torch.equal(got, parts.view(3, 40)[p])
        ptr = op.indptr.numpy()
        for i in range(40):
            row = M.indices[M.indptr[i]:M.indptr[i + 1]]
            lanes_whole = [k % vec for k, c in enumerate(row)
                           if c0 <= c < c1]
            vals = op.vals.numpy()[ptr[i]:ptr[i + 1]]
            lanes_op = [k % vec for k, v in enumerate(vals) if v != 0.0]
            assert lanes_op == lanes_whole


# -- (b) against the reference's mesh ---------------------------------------------
@pytest.mark.parametrize("solver", ["sharded_cr_solve", "ShardedDiagCR"])
@pytest.mark.parametrize("m, n, seed", CASES)
def test_mesh_matches_reference(mesh, m, n, seed, solver):
    """Five trips: y within 1e-10 of the reference's on its 4-device
    mesh, both at 5 trips (ShardedDiagCR at its limit, 201). Converged
    (tol 1e-10): both normal-equation residuals within 1e-9, the mesh's
    iteration count within 2 of the reference's."""
    A, W, diag, rhs = _system(m, n, seed)
    run = _cr if solver == "sharded_cr_solve" else _diag
    want = run(A, W, diag, rhs, 1e-14, 5, "ref")
    got = run(A, W, diag, rhs, 1e-14, 5, "mesh", mesh)
    assert got[1] == want[1] == 5
    if solver == "ShardedDiagCR":
        assert got[2] == want[2] == 201
    assert _rel(got[0], want[0]) <= 1e-10
    want = run(A, W, diag, rhs, 1e-10, 2000, "ref")
    got = run(A, W, diag, rhs, 1e-10, 2000, "mesh", mesh)
    assert got[1] > 0 and abs(got[1] - want[1]) <= 2, (got[1], want[1])
    assert _residual(A, W, got[0], rhs) <= 1e-9
    assert _residual(A, W, want[0], rhs) <= 1e-9


def test_batched_cr_matches_reference(mesh):
    """sharded_batched_cr_solve on 2 x 2: five trips, Y within 1e-10 of
    the reference's on its 2 x 2 rows x batch mesh, both at 5 trips."""
    A, W, diag, RHS = _system(61, 90, 12, B=6)
    n = 90
    want, it_r = ref.sharded_batched_cr_solve(
        ref.ShardedNormalMatrix(A, 2), W[:n], W[n:], diag, RHS, tol=1e-14,
        maxiter=5, mesh=_jax_mesh((2, 2), ("rows", "batch")))
    got, it = port.sharded_batched_cr_solve(
        port.ShardedNormalMatrix(A, 2, CPU), W[:n], W[n:], diag, RHS,
        1e-14, 5, mesh=mesh.reshape((2, 2), ("rows", "batch")))
    assert it == it_r == 5
    assert _rel(got, want) <= 1e-10


def test_nnt_matches_reference(mesh):
    """The mesh's N N' against the reference's mesh program: 1e-12."""
    N = sp.random(61, 150, density=0.08, format="csc",
                  random_state=np.random.RandomState(8))
    w = np.random.default_rng(8).standard_normal(61)
    r = ref.ShardedSplittedNNt(61, 150, N.nnz + 61, NB, mesh=_jax_mesh())
    assert r.set_operand(N)
    nnt = port.ShardedSplittedNNt(61, 150, NB, mesh=mesh)
    nnt.set_operand(N)
    assert _rel(nnt.apply(w), r.apply(w)) <= 1e-12


# -- (c) a full solve ------------------------------------------------------------
def _solve(pkg, data, **kw):
    p = pkg.Parameters()
    p.display = 0
    for k, v in kw.items():
        setattr(p, k, v)
    s = pkg.LpSolver(p)
    assert testgen.load_into_solver(data, s) == 0
    return s, s.solve()


def test_full_solve_over_the_mesh(mesh):
    """LpSolver(shards=4) inside `with mesh:`: status 1000, pobjval within
    1e-8 of ipx_tpu's shards=4 solve, both phases' blocks on the ranks (the
    solvers kept on the model under the mesh's key), and pobjval within
    1e-8 of the one-process shards=4 solve's (the shared LU refactorizes
    on measured time, native/ipxlu.cc need_fresh_impl, so two solves need
    not take the same path)."""
    data = testgen.transportation(60, 90, 0.05, seed=3)
    s_ref, st = _solve(ipx_tpu, data, shards=NB, device="cpu")
    assert st == 1000
    with mesh:
        assert pm.active_mesh() is mesh
        s, st = _solve(ipx_tpu_torch, data, shards=NB, device="torch_cpu")
    assert pm.active_mesh() is None
    info = s.get_info()
    assert st == 1000
    assert info.pobjval == pytest.approx(s_ref.get_info().pobjval, rel=1e-8)
    key, cr = s.model._sharded_cr
    assert key == (NB, f"mesh {mesh.uid}") and cr.mesh is mesh
    assert cr.iterations == info.kktiter1 > 0
    nkey, nnt, _ = s.model._sharded_nnt
    assert nkey == key and nnt.mesh is mesh and nnt.applies > 0
    one, st = _solve(ipx_tpu_torch, data, shards=NB, device="torch_cpu")
    assert st == 1000
    assert one.get_info().pobjval == pytest.approx(info.pobjval, rel=1e-8)


def test_resolve_mesh_rules(mesh):
    """An active mesh whose rows axis has `shards` ranks takes the blocks
    of a matching device; another shards count, or no active mesh on a
    machine without cards, leaves them on one device; a device the mesh's
    ranks are not on raises. The mesh's groups are its own: no default
    process group exists."""
    assert backend.resolve_mesh("torch_cpu", NB) is None
    with mesh:
        assert backend.resolve_mesh("torch_cpu", NB) is mesh
        assert backend.resolve_mesh("torch_cpu", 2) is None
        if not torch.cuda.is_available():
            assert backend.resolve_mesh("cpu", NB) is mesh
            with pytest.raises(RuntimeError):
                backend.resolve_mesh("cuda", NB)
    assert not dist.is_initialized()


def test_transport_rule():
    """gloo on the CPU and for ranks that share a card (staged through
    pinned host buffers), NCCL when every rank has its own card."""
    assert pm.transport_of(["cpu"] * 4) == ("gloo", False)
    assert pm.transport_of(["cuda:0"] * 4) == ("gloo", True)
    assert pm.transport_of(["cuda:0", "cuda:1"]) == ("nccl", False)
    assert pm.transport_of(["cuda:0"]) == ("nccl", False)
    with pytest.raises(ValueError):
        pm.transport_of(["cpu", "cuda:0"])


def test_batched_step_over_the_batch_axis(mesh):
    """One batched IPM step with its 8 and 16 lanes split over the 4 ranks:
    the CR trips, done flags and iteration counts of one process, and the
    iterate within 1e-12 of it."""
    bm = mesh.reshape((NB,), ("batch",))
    for B in (8, 16):
        s = entry._make_batched_solver(batch=B, device="torch_cpu")
        S = s._starting_point()
        S2 = {k: (v.clone() if torch.is_tensor(v) else v)
              for k, v in S.items()}
        got = bm.step(s.lp, S2, s.maxiter)
        want = s._ipm_step(S)
        assert got["cr"] == want["cr"] > 0
        for k in ("done", "iters"):
            assert torch.equal(got[k], want[k]), k
        for k in ("X", "XL", "XU", "Y", "ZL", "ZU", "mu"):
            g, w = got[k].numpy(), want[k].numpy()
            fin = np.isfinite(w)      # XU is inf where ub is
            np.testing.assert_array_equal(g[~fin], w[~fin])
            assert _rel(g[fin], w[fin]) <= 1e-12, k


# -- (d) a failing rank -------------------------------------------------------------
def test_a_worker_that_raises_makes_rank_0_raise():
    """N N' blocks put on lane group 0 of a 2 x 2 layout, then applied as
    4 column blocks: ranks 1 and 3 hold no such operator and raise; rank 0
    raises MeshError with their traceback within the timeout, and the mesh
    is closed."""
    m = pm.make_row_mesh(NB, "torch_cpu", timeout=20.0)
    try:
        key = m.reshape((2, 2), ("rows", "batch")).set_nnt(
            sp.random(20, 30, density=0.3, format="csc", random_state=1), 2)
        t0 = time.perf_counter()
        with pytest.raises(pm.MeshError, match="holds no operator"):
            m.nnt_apply(key, np.ones(20))
        assert time.perf_counter() - t0 < 20.0
        assert m.closed
        with pytest.raises(pm.MeshError, match="closed"):
            m.nnt_apply(key, np.ones(20))
    finally:
        m.close()


def test_a_killed_worker_makes_rank_0_raise():
    """A worker killed between two solves: rank 0's next op raises MeshError
    within the timeout, naming the rank, and ends the other workers."""
    A, W, diag, rhs = _system(64, 90, 11)
    m = pm.make_row_mesh(NB, "torch_cpu", timeout=20.0)
    try:
        snm = port.ShardedNormalMatrix(A, NB, mesh=m)
        port.sharded_cr_solve(snm, W[:90], W[90:], diag, rhs, 1e-10, 100)
        victim = m._ranks.procs[1]
        victim.kill()
        t0 = time.perf_counter()
        with pytest.raises(pm.MeshError, match="rank 2"):
            port.sharded_cr_solve(snm, W[:90], W[90:], diag, rhs, 1e-10, 100)
        assert time.perf_counter() - t0 < 20.0
        assert m.closed
        assert all(p.exitcode is not None for p in m._ranks.procs)
    finally:
        m.close()


# -- (e) the dry run ------------------------------------------------------------------
def test_dryrun_multichip_over_the_mesh(mesh):
    """dryrun_multichip(4) with every part over the 4 ranks passes its
    asserts."""
    entry.dryrun_multichip(NB, device="torch_cpu", mesh=mesh)
