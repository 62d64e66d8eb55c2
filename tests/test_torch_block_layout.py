"""The split layout of K4 and K14v (ops/spmv.py: one CSR operand of the
whole matrix with the blocks' bounds) through its plain evaluator, the
NntPlan on the CPU, the rule that quiets numpy's and scipy's BLAS pools
during a solve (native/threads.py), and Parameters.precision="f64" on the
device path.

Tolerances: the layout against the per-block plain versions of the port
(block_nnt_plain, the vector _block_apply_plain) to 1e-14 relative, since
both sum each block's products by index_add and then the blocks in order;
against ipx_tpu's mesh programs on the 8 virtual CPU devices of
tests/conftest.py to 1e-12, as tests/test_torch_sharding.py holds the
per-block versions (another order of the sums); full solves at the
reference's status with the objective to 1e-8.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import ipx_tpu
import ipx_tpu.testgen as tg
import ipx_tpu_torch
from ipx_tpu.parallel import sharding as ref
from ipx_tpu_torch.kkt.splitted_normal import SplittedNormalMatrix
from ipx_tpu_torch.native import threads
from ipx_tpu_torch.ops import device_cr, device_cr2, spmv
from ipx_tpu_torch.parallel import sharding as port
from ipx_tpu_torch.status import Status

from test_torch_sharding import NB, _mesh, _ref_apply, _system

CPU = torch.device("cpu")
# (P, rows or columns to cut): one block, two, four, and four over five
# leaving the last block empty (block_sizes(5, 4) = [2, 2, 1, 0])
SPLITS = [pytest.param(1, 37, id="P1"), pytest.param(2, 37, id="P2"),
          pytest.param(4, 37, id="P4"),
          pytest.param(4, 5, id="P4-empty-last")]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float64))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


def _layout_nnt(nnt, w):
    """The plain evaluator of the layout for N N': N' w, then the split
    sums over N's rows."""
    plan = nnt.plan
    return spmv.split_spmv_plain(plan.N, spmv.csr_spmv_plain(plan.Nt, w))


def _layout_apply(snm, W_struct, W_slack, v):
    """The plain evaluator of the layout for the vector apply: u by the
    split sums over A' scaled by W_struct, then the block products."""
    u = spmv.split_spmv_plain(snm.op_At_split, v, W_struct)
    return torch.cat([spmv.csr_spmv_plain(op, u) + W_slack[r0:r1] * v[r0:r1]
                      for op, (r0, r1) in zip(snm.op_A, snm.bounds)])


@pytest.mark.parametrize("P, n", SPLITS)
def test_layout_nnt_equals_block_nnt_plain(P, n):
    rng = np.random.default_rng(P + n)
    N = sp.random(30, n, density=0.3, format="csc", random_state=rng,
                  data_rvs=rng.standard_normal)
    nnt = port.ShardedSplittedNNt(30, n, P, CPU)
    nnt.set_operand(N)
    assert nnt.plan.N.P == P
    assert nnt.plan.N.bounds.tolist() == [0] + np.cumsum(
        port.block_sizes(n, P)).tolist()
    w = _t(rng.standard_normal(30))
    want = port.block_nnt_plain(nnt.blocks, w)
    assert _rel(_layout_nnt(nnt, w), want) <= 1e-14
    # the plan on the CPU takes the per-block plain version as it is
    assert torch.equal(nnt.plan(w), want)


@pytest.mark.parametrize("P, m", SPLITS)
def test_layout_apply_equals_block_apply_plain(P, m):
    rng = np.random.default_rng(10 + P + m)
    A = sp.random(m, 23, density=0.3, format="csc", random_state=rng,
                  data_rvs=rng.standard_normal)
    snm = port.ShardedNormalMatrix(A, P, CPU)
    assert snm.op_At_split.P == P
    W = _t(rng.uniform(0.5, 2.0, 23 + m))
    v = _t(rng.standard_normal(m))
    want = port._block_apply_plain(snm, W[:23], W[23:], v,
                                   spmv.csr_spmv_plain)
    assert _rel(_layout_apply(snm, W[:23], W[23:], v), want) <= 1e-14


def test_split_sums_are_ordered_per_block():
    """Each row's value is ((s_0 + s_1) + s_2) + s_3, s_p the row's sum over
    the entries of block p, times its scale."""
    rng = np.random.default_rng(7)
    M = sp.random(6, 12, density=0.6, format="csr", random_state=rng)
    M.sort_indices()
    bounds = [0, 3, 3, 8, 12]            # block 1 is empty
    op = spmv.CsrOperand(M.indptr, M.indices, M.data, 12, CPU,
                         torch.float64, bounds=bounds)
    x, scale = rng.standard_normal(12), rng.standard_normal(6)
    s = [M[:, b0:b1] @ x[b0:b1] for b0, b1 in zip(bounds, bounds[1:])]
    want = (((s[0] + s[1]) + s[2]) + s[3]) * scale
    got = spmv.split_spmv(op, _t(x), _t(scale)).numpy()
    assert _rel(got, want) <= 1e-15


@pytest.mark.parametrize("bounds", [[0, 5], [1, 12], [0, 6, 4, 12], [0, 13]])
def test_split_bounds_must_cut_the_columns(bounds):
    M = sp.random(4, 12, density=0.5, format="csr", random_state=1)
    with pytest.raises(ValueError, match="bounds"):
        spmv.CsrOperand(M.indptr, M.indices, M.data, 12, CPU, torch.float64,
                        bounds=bounds)


@pytest.fixture(scope="module")
def splitted():
    s = ipx_tpu_torch.LpSolver(ipx_tpu_torch.Parameters(
        display=0, device="cpu", stop_at_switch=1))
    tg.load_into_solver(tg.transportation(40, 61, 0.1, seed=3), s)
    s.solve()
    sn = SplittedNormalMatrix(s.basis.model)
    sn.prepare(s.basis, s.iterate.scaling_factors())
    return sn


def test_layout_nnt_matches_reference(splitted):
    """The layout's N N' over 4 column blocks against the reference's
    ShardedSplittedNNt on a 4-device mesh: 1e-12."""
    N = splitted.N
    m, n = N.shape
    w = np.random.default_rng(5).standard_normal(m)
    r = ref.ShardedSplittedNNt(m, n, N.nnz + m, NB, mesh=_mesh())
    assert r.set_operand(N)
    nnt = port.ShardedSplittedNNt(m, n, NB, CPU)
    nnt.set_operand(N)
    assert _rel(_layout_nnt(nnt, _t(w)).numpy(), r.apply(w)) <= 1e-12


@pytest.mark.parametrize("m, n, seed", [(64, 90, 11), (61, 90, 12)],
                         ids=["m64", "m61-ragged"])
def test_layout_apply_matches_reference(m, n, seed):
    """The layout's vector apply over 4 row blocks against the reference's
    block_normal_apply under shard_map: 1e-12."""
    A, W, _, v = _system(m, n, seed)
    snm = port.ShardedNormalMatrix(A, NB, CPU)
    got = _layout_apply(snm, _t(W[:n]), _t(W[n:]), _t(v)).numpy()
    assert _rel(got, _ref_apply(A, W, v)) <= 1e-12


def test_nnt_plan_on_the_cpu_is_nnt_plain(splitted):
    """DeviceSplittedCR's NntPlan on "torch_cpu": nnt_plain's result, with
    no pinned buffers."""
    dcr = device_cr2.DeviceSplittedCR(splitted.model, CPU)
    dcr.prepare(splitted)
    w = np.random.default_rng(6).standard_normal(dcr.m)
    want = device_cr2.nnt_plain(dcr._Nt, dcr._N, _t(w)).numpy()
    assert np.array_equal(dcr._plan.apply(w), want)
    assert np.array_equal(dcr._plan(_t(w)).numpy(), want)
    assert dcr._plan._kernel is None
    assert not hasattr(dcr._plan, "_w_host")


@pytest.mark.parametrize("env, want", [
    ({}, 1), ({"OPENBLAS_NUM_THREADS": "8"}, None),
    ({"OPENBLAS_NUM_THREADS": "1"}, None), ({"OMP_NUM_THREADS": "4"}, None),
    ({"GOTO_NUM_THREADS": "2"}, None), ({"OPENBLAS_NUM_THREADS": ""}, 1),
    ({"OMP_PROC_BIND": "spread"}, 1),
    ({"MKL_NUM_THREADS": "4", "OMP_WAIT_POLICY": "passive"}, 1)])
def test_blas_threads_rule(env, want):
    """The BLAS pools in a solve: left as they are when the user sized them
    (OPENBLAS_NUM_THREADS, GOTO_NUM_THREADS or OMP_NUM_THREADS, which
    OpenBLAS reads), else one thread."""
    assert threads.blas_threads(env) == want


def test_quiet_blas_sets_and_restores_the_pools(monkeypatch):
    """numpy's OpenBLAS pool is found, runs on one thread inside the block
    and on its own count after it; a user's setting leaves it alone."""
    for k in threads.USER_VARS:
        monkeypatch.delenv(k, raising=False)
    pools = threads.blas_pools()
    assert pools
    own = [get() for get, _ in pools]
    with threads.quiet_blas():
        assert [get() for get, _ in pools] == [1] * len(pools)
    assert [get() for get, _ in pools] == own
    monkeypatch.setenv("OPENBLAS_NUM_THREADS", "3")
    pools[0][1](2)
    try:
        with threads.quiet_blas():
            assert pools[0][0]() == 2
    finally:
        pools[0][1](own[0])


def test_solve_quiets_the_blas_pools(monkeypatch):
    """LpSolver.solve runs inside quiet_blas: the pools at one thread from
    before presolve to the end, their count back after it."""
    log = []

    class Pool:
        n = 6

        def get(self):
            return self.n

        def put(self, n):
            self.n = n
            log.append(n)

    pool = Pool()
    seen = []
    for k in threads.USER_VARS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(threads, "blas_pools", lambda: ((pool.get, pool.put),))
    presolve = ipx_tpu_torch.LpSolver._presolve

    def spy(self):
        seen.append(pool.n)
        return presolve(self)

    monkeypatch.setattr(ipx_tpu_torch.LpSolver, "_presolve", spy)
    s = ipx_tpu_torch.LpSolver(ipx_tpu_torch.Parameters(display=0,
                                                        device="cpu"))
    tg.load_into_solver(tg.transportation(20, 30, 0.2, seed=2), s)
    assert s.solve() == int(Status.SOLVED)
    assert seen == [1] and log == [1, 6] and pool.n == 6


def test_f64_precision_builds_the_f64_device_cr(monkeypatch):
    """precision="f64" on "torch_cpu" runs phase 1 through DeviceNormalCR,
    never the mixed solver, at the reference's status and objective."""
    calls = {"f64": 0, "mixed": 0}
    for key, cls in (("f64", device_cr.DeviceNormalCR),
                     ("mixed", device_cr.MixedPrecisionDeviceCR)):
        def counted(self, *a, _orig=cls.solve, _k=key, **kw):
            calls[_k] += 1
            return _orig(self, *a, **kw)
        monkeypatch.setattr(cls, "solve", counted)
    data = tg.transportation(120, 180, 0.05, seed=4)
    infos = {}
    for pkg, device in ((ipx_tpu, "tpu"), (ipx_tpu_torch, "torch_cpu")):
        p = pkg.Parameters()
        p.display, p.device, p.precision = 0, device, "f64"
        s = pkg.LpSolver(p)
        tg.load_into_solver(data, s)
        s.solve()
        infos[device] = s.get_info()
    port_info, ref_info = infos["torch_cpu"], infos["tpu"]
    assert calls["f64"] > 0 and calls["mixed"] == 0
    assert port_info.status == ref_info.status == int(Status.SOLVED)
    assert port_info.objval == pytest.approx(ref_info.objval, rel=1e-8)
