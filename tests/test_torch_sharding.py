"""The row-blocked solves of ipx_tpu_torch (parallel/sharding.py, with the
plain versions of K1, K4, K5 and K14-K16 on the CPU) against
ipx_tpu.parallel.sharding on the 8 virtual CPU devices that
tests/conftest.py makes, on random_lp(64, 90, 0.15, seed) as in
tests/test_sharded.py and on a 61-row LP, whose last row block is ragged.

Tolerances, each relative to the largest entry of the reference's result:
the block apply and N N' to 1e-12 in float64 (the two sum each row, and
the blocks, in another order); five CR trips to 1e-11 (the same recurrence,
the dots summed in another order); converged solves by their
normal-equation residual, 1e-9 at a tolerance of 1e-10, and iteration
counts within 2 (rounding can move the last trip); the batched solve's Y
to 1e-6 (its lanes stop at a residual of 1e-10, so Y is fixed to about
the residual over the smallest eigenvalue, not to rounding); full solves
at status 1000 with pobjval within 1e-8 of the reference's sharded solve.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

import ipx_tpu
import ipx_tpu_torch
from ipx_tpu.parallel import sharding as ref
from ipx_tpu_torch import backend, testgen
from ipx_tpu_torch.kkt.splitted_normal import SplittedNormalMatrix
from ipx_tpu_torch.parallel import sharding as port

from lp_fixtures import random_lp

CPU = torch.device("cpu")
NB = 4
# (m, n, seed): test_sharded.py's LP, and one whose last block is ragged
CASES = [pytest.param(64, 90, 11, id="m64"),
         pytest.param(61, 90, 12, id="m61-ragged")]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float64))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


def _system(m, n, seed, B=None):
    """A, W (n + m[, B]), diag, rhs (m[, B]) as test_sharded.py makes them."""
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


def _normal_residual(A, W, y, rhs):
    n = A.shape[1]
    res = rhs - (A @ (W[:n] * (A.T @ y)) + W[n:] * y)
    return np.max(np.abs(res)) / max(1.0, np.abs(rhs).max())


def _mesh(shape=(NB,), axes=("rows",)):
    devices = jax.local_devices(backend="cpu")
    assert len(devices) >= 8, "conftest must create 8 virtual CPU devices"
    k = int(np.prod(shape))
    return Mesh(np.array(devices[:k]).reshape(shape), axis_names=axes)


def _ref_apply(A, W, v):
    """The reference's block_normal_apply(_batched) on every block of a
    4-device mesh, with its psum."""
    m, n = A.shape
    snm = ref.ShardedNormalMatrix(A, NB)
    m_pad = NB * snm.m_block
    batched = v.ndim == 2

    def pad(x):
        return jnp.asarray(np.concatenate(
            [x, np.zeros((m_pad - m,) + x.shape[1:])]))

    def local(blk, W_struct, W_slack_p, v_p):
        f = (snm.block_normal_apply_batched if batched
             else snm.block_normal_apply)
        return f(blk, (W_struct, W_slack_p), v_p, "rows")

    spec = {k: P("rows") for k in snm.arrays}
    fn = jax.shard_map(local, mesh=_mesh(),
                       in_specs=(spec, P(), P("rows"), P("rows")),
                       out_specs=P("rows"), check_vma=False)
    out = fn(snm.arrays, jnp.asarray(W[:n]), pad(W[n:]), pad(v))
    return np.asarray(out)[:m]


def test_block_sizes_are_the_references():
    """ceil(m / P) rows a block, the last holding what is left."""
    assert port.block_sizes(64, 4) == [16, 16, 16, 16]
    assert port.block_sizes(61, 4) == [16, 16, 16, 13]
    assert port.block_sizes(5, 4) == [2, 2, 1, 0]
    snm = port.ShardedNormalMatrix(sp.random(61, 9, density=0.3,
                                             format="csc", random_state=1),
                                   NB, CPU)
    assert snm.bounds == [(0, 16), (16, 32), (32, 48), (48, 61)]


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
@pytest.mark.parametrize("m, n, seed", CASES)
def test_block_normal_apply_matches_reference(m, n, seed, batched):
    """C v over the row blocks (K1 or K5 per block, K14 over them) against
    the reference's block_normal_apply(_batched) under shard_map: 1e-12."""
    A, W, _, v = _system(m, n, seed, B=6 if batched else None)
    want = _ref_apply(A, W, v)
    snm = port.ShardedNormalMatrix(A, NB, CPU)
    got = snm.apply(_t(W[:n]), _t(W[n:]), _t(v)).numpy()
    assert got.shape == v.shape
    assert _rel(got, want) <= 1e-12


def test_block_apply_with_an_empty_block():
    """m = 5 over 4 blocks leaves the last one empty; the apply is still
    A (W_s (A' v)) + W_slack v."""
    rng = np.random.default_rng(3)
    A = sp.random(5, 7, density=0.5, format="csc", random_state=rng)
    W = rng.uniform(0.5, 2.0, 12)
    v = rng.standard_normal(5)
    snm = port.ShardedNormalMatrix(A, NB, CPU)
    assert snm.rows == [2, 2, 1, 0]
    got = snm.apply(_t(W[:7]), _t(W[7:]), _t(v)).numpy()
    assert _rel(got, A @ (W[:7] * (A.T @ v)) + W[7:] * v) <= 1e-14


def test_block_sum_is_the_ordered_sum():
    """The plain K14: ((p0 + p1) + p2) + p3, times scale, bit for bit."""
    rng = np.random.default_rng(4)
    parts, scale = rng.standard_normal((4, 50)), rng.standard_normal(50)
    want = (((parts[0] + parts[1]) + parts[2]) + parts[3]) * scale
    assert np.array_equal(port.block_sum(_t(parts), _t(scale)).numpy(), want)
    assert np.array_equal(port.block_sum(_t(parts)).numpy(),
                          ((parts[0] + parts[1]) + parts[2]) + parts[3])


def _diag_cr(A, W, diag, rhs, tol, maxiter, which):
    """(y, iters, errflag) of the reference's or the port's ShardedDiagCR."""
    n = A.shape[1]
    resscale = 1.0 / np.sqrt(np.abs(W[n:]))
    cr = (ref.ShardedDiagCR(A, NB, mesh=_mesh()) if which == "ref"
          else port.ShardedDiagCR(A, NB, CPU))
    return cr.solve(W[:n], W[n:], diag, resscale, rhs, tol, maxiter)


def _cr_solve(A, W, diag, rhs, tol, maxiter, which):
    """(y, iters) of the reference's or the port's sharded_cr_solve."""
    n = A.shape[1]
    if which == "ref":
        return ref.sharded_cr_solve(ref.ShardedNormalMatrix(A, NB), W[:n],
                                    W[n:], diag, rhs, tol, maxiter,
                                    mesh=_mesh())
    return port.sharded_cr_solve(port.ShardedNormalMatrix(A, NB, CPU),
                                 W[:n], W[n:], diag, rhs, tol, maxiter)


@pytest.mark.parametrize("solver", ["ShardedDiagCR", "sharded_cr_solve"])
@pytest.mark.parametrize("m, n, seed", CASES)
def test_five_trips_match_reference(m, n, seed, solver):
    """Five trips of the recurrence (K15's plain version) from the same
    inputs: y within 1e-11 of the reference's; ShardedDiagCR stops at its
    iteration limit with errflag 201 in both."""
    A, W, diag, rhs = _system(m, n, seed)
    run = _diag_cr if solver == "ShardedDiagCR" else _cr_solve
    want = run(A, W, diag, rhs, 1e-14, 5, "ref")
    got = run(A, W, diag, rhs, 1e-14, 5, "port")
    assert got[1] == want[1] == 5
    if solver == "ShardedDiagCR":
        assert got[2] == want[2] == 201
    assert _rel(got[0], want[0]) <= 1e-11


@pytest.mark.parametrize("solver", ["ShardedDiagCR", "sharded_cr_solve"])
@pytest.mark.parametrize("m, n, seed", CASES)
def test_converged_solves_match_reference(m, n, seed, solver):
    """Solves to tol 1e-10: the normal-equation residual within 1e-9 and the
    iteration counts within 2 of the reference's."""
    A, W, diag, rhs = _system(m, n, seed)
    run = _diag_cr if solver == "ShardedDiagCR" else _cr_solve
    want = run(A, W, diag, rhs, 1e-10, 2000, "ref")
    got = run(A, W, diag, rhs, 1e-10, 2000, "port")
    if solver == "ShardedDiagCR":
        assert got[2] == want[2] == 0
    assert got[1] > 0 and abs(got[1] - want[1]) <= 2
    assert _normal_residual(A, W, got[0], rhs) <= 1e-9


@pytest.mark.parametrize("case, errflag", [
    ("negative_weight", 203), ("negative_weight_positive_diag", 202),
    ("nan_rhs", 205)])
def test_error_ladder_matches_reference(case, errflag):
    """ShardedDiagCR's ladder in both packages: negative weights make cdot
    negative (202), and with the diagonal made from them pdot too, which
    the ladder puts after it (203); the iterate stays as the reference's.
    A NaN in the right-hand side never reads as converged (205). There the
    two stop at different trips: the reference's pmax across its devices
    drops the NaN of one block (measured: it runs one trip, into the
    ladder's 205), while the port's max over the blocks keeps it, as
    jnp.max does within a block, so the port stops before the first trip
    with y = 0."""
    A, W, diag, rhs = _system(64, 90, 11)
    if case.startswith("negative_weight"):
        W = -W
        if case == "negative_weight":
            diag = -diag
    else:
        rhs[3] = np.nan
    want = _diag_cr(A, W, diag, rhs, 1e-10, 100, "ref")
    got = _diag_cr(A, W, diag, rhs, 1e-10, 100, "port")
    assert got[2] == want[2] == errflag
    if case == "nan_rhs":
        assert got[1] == 0 and want[1] == 1
        assert np.all(got[0] == 0.0)
    else:
        assert got[1] == want[1] == 1
        np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("m, n, seed", CASES)
def test_batched_cr_matches_reference(m, n, seed):
    """sharded_batched_cr_solve, P = 4, B = 6, against the reference's on
    its (4 rows x 2 batch) mesh: every lane's normal-equation residual
    within 1e-9, Y within 1e-6 of the reference's."""
    A, W, diag, RHS = _system(m, n, seed, B=6)
    want, it_r = ref.sharded_batched_cr_solve(
        ref.ShardedNormalMatrix(A, NB), W[:n], W[n:], diag, RHS, tol=1e-10,
        maxiter=2000, mesh=_mesh((NB, 2), ("rows", "batch")))
    got, it = port.sharded_batched_cr_solve(
        port.ShardedNormalMatrix(A, NB, CPU), W[:n], W[n:], diag, RHS,
        tol=1e-10, maxiter=2000)
    assert it > 0 and abs(it - it_r) <= 2
    for k in range(6):
        assert _normal_residual(A, W[:, k], got[:, k], RHS[:, k]) <= 1e-9, k
    assert _rel(got, want) <= 1e-6


def test_batched_cr_freezes_converged_lanes():
    """A lane whose right-hand side is zero is done at the first trip and
    keeps Y = 0; the loop still runs that trip, as the reference's does."""
    A, W, diag, RHS = _system(61, 90, 12, B=3)
    RHS[:, 1] = 0.0
    snm = port.ShardedNormalMatrix(A, NB, CPU)
    n = A.shape[1]
    Y, it = port.sharded_batched_cr_solve(snm, W[:n], W[n:], diag, RHS,
                                          1e-10, 2000)
    assert np.all(Y[:, 1] == 0.0) and it > 0
    zero, it0 = port.sharded_batched_cr_solve(snm, W[:n], W[n:], diag,
                                              np.zeros_like(RHS), 1e-10, 2000)
    assert it0 == 1 and np.all(zero == 0.0)


@pytest.fixture(scope="module")
def splitted():
    """The port's SplittedNormalMatrix right after the phase switch."""
    p = ipx_tpu_torch.Parameters(display=0, device="cpu", stop_at_switch=1)
    s = ipx_tpu_torch.LpSolver(p)
    testgen.load_into_solver(testgen.transportation(40, 61, 0.1, seed=3), s)
    s.solve()
    assert s.basis is not None
    sn = SplittedNormalMatrix(s.basis.model)
    sn.prepare(s.basis, s.iterate.scaling_factors())
    return sn


def test_nnt_matches_reference(splitted):
    """ShardedSplittedNNt.apply (K4 per column block, K14 over them) on a
    prepared splitted operator against the reference's mesh program and the
    host product: 1e-12."""
    N = splitted.N
    m, n = N.shape
    assert n % NB != 0             # the last column block is ragged
    w = np.random.default_rng(5).standard_normal(m)
    r = ref.ShardedSplittedNNt(m, n, N.nnz + m, NB, mesh=_mesh())
    assert r.set_operand(N)
    want = r.apply(w)
    nnt = port.ShardedSplittedNNt(m, n, NB, CPU)
    nnt.set_operand(N)
    got = nnt.apply(w)
    assert nnt.applies == 1
    assert _rel(got, want) <= 1e-12
    assert _rel(got, N @ (N.T @ w)) <= 1e-12


def _solve(pkg, data, **kw):
    p = pkg.Parameters()
    p.display = 0
    for k, v in kw.items():
        setattr(p, k, v)
    s = pkg.LpSolver(p)
    assert testgen.load_into_solver(data, s) == 0
    return s, s.solve()


@pytest.fixture(scope="module")
def transport():
    """transportation(60, 90, 0.05, 3) and the reference's sharded
    pobjval."""
    data = testgen.transportation(60, 90, 0.05, seed=3)
    s, st = _solve(ipx_tpu, data, shards=NB, device="cpu")
    assert st == 1000
    return data, s.get_info().pobjval


@pytest.mark.parametrize("device", ["torch_cpu", "cpu"])
def test_full_solve_with_shards(transport, device):
    """LpSolver(shards=4): status 1000, pobjval within 1e-8 of the
    reference's sharded solve; phase 1 ran the row-blocked CR and phase 2
    the column-blocked N N', on one device, for both devices (with
    "torch_cpu" the device splitted CR does not take phase 2)."""
    data, want = transport
    s, st = _solve(ipx_tpu_torch, data, shards=NB, device=device)
    info = s.get_info()
    assert st == 1000
    assert info.pobjval == pytest.approx(want, rel=1e-8)
    key, cr = s.model._sharded_cr
    assert key == (NB, "cpu") and cr.solves > 0
    assert cr.iterations == info.kktiter1 > 0
    nnt = getattr(s.model, "_sharded_nnt", None)
    assert nnt is not None and nnt[0] == key
    assert nnt[1].applies > 0 and info.kktiter2 > 0


def test_sharded_phase2_full_solve_parity_10k():
    """test_sharded.py's m >= 10k phase-2 test on the port: the column-blocked
    N N' runs during a full public-API solve, and pobjval agrees with the
    reference's sharded solve to 1e-8."""
    data = testgen.transportation(4000, 6000, 0.002, seed=2)
    assert data["num_constr"] >= 10000
    s_ref, st_ref = _solve(ipx_tpu, data, shards=NB, device="cpu")
    s, st = _solve(ipx_tpu_torch, data, shards=NB, device="cpu")
    assert st == st_ref == 1000
    assert s.get_info().pobjval == pytest.approx(
        s_ref.get_info().pobjval, rel=1e-8)
    assert s.model._sharded_nnt[1].applies > 0
    assert s.get_info().kktiter2 > 0


def test_failed_sharded_solve_raises(monkeypatch):
    """A failure in the row-blocked CR ends the solve with an internal
    error; the reference's solver would finish it unsharded."""
    def broken(self, *args):
        raise RuntimeError("sharded CR failed")

    monkeypatch.setattr(port.ShardedDiagCR, "solve", broken)
    data = testgen.transportation(20, 30, 0.2, seed=4)
    _, st = _solve(ipx_tpu_torch, data, shards=2, device="torch_cpu")
    assert st == int(ipx_tpu_torch.Status.INTERNAL_ERROR)


def test_sharded_device_rule(monkeypatch):
    """"cuda" is the card or raises, also with shards (a solve then ends
    at INTERNAL_ERROR before any work); "torch_cpu" is the CPU; "auto" and
    "cpu" are the card when one is present, else the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in ("auto", "cpu", "torch_cpu"):
        assert backend.resolve_sharded(device) == CPU
    with pytest.raises(RuntimeError, match="is_available"):
        backend.resolve_sharded("cuda")
    with pytest.raises(ValueError, match="unknown device"):
        backend.resolve_sharded("tpu")
    data = testgen.transportation(20, 30, 0.2, seed=4)
    s, st = _solve(ipx_tpu_torch, data, shards=2, device="cuda")
    assert st == int(ipx_tpu_torch.Status.INTERNAL_ERROR)
    assert s.get_info().iter == 0 and s.basis is None


@pytest.mark.parametrize("make", [
    pytest.param(lambda A, **kw: port.ShardedNormalMatrix(A, NB, **kw),
                 id="ShardedNormalMatrix"),
    pytest.param(lambda A, **kw: port.ShardedDiagCR(A, NB, **kw),
                 id="ShardedDiagCR"),
    pytest.param(lambda A, **kw: port.ShardedSplittedNNt(*A.shape, NB, **kw),
                 id="ShardedSplittedNNt")])
def test_blocks_default_to_the_card_when_present(monkeypatch, make):
    """With no device given, the blocks go on the card: without one the
    constructor raises, and with one (here a stand-in for
    backend.cuda_device that raises, as nothing can be put on a card on
    this host) the card is chosen. A device given is kept."""
    A = sp.random(9, 7, density=0.4, format="csc", random_state=6)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        make(A)

    def the_card():
        raise RuntimeError("the card was chosen")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(backend, "cuda_device", the_card)
    with pytest.raises(RuntimeError, match="the card was chosen"):
        make(A)
    assert make(A, device=CPU).device == CPU
