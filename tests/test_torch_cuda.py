"""The CUDA kernels K1-K17 against their plain PyTorch versions on the card,
at small shapes with the edge cases the main path's shapes do not show
(empty rows, rows longer than a warp, partial blocks, lane counts that
allow no vector loads, lanes past one block).

Needs an NVIDIA card and nvcc; skipped without them. This file imports no
jax, so on a machine without jax it runs without the suite's conftest, which
imports jax, and the ``cuda`` marker is then registered on the command line:
``python -m pytest --noconftest -o "markers=cuda: needs an NVIDIA card"
-m cuda -q tests/test_torch_cuda.py``.

Tolerances: 1e-12 relative in float64 and 1e-5 in float32 (the kernels sum
each row in a shuffle tree or in another order than the plain version);
K8's step sizes and K9 are exact, and so are the elementwise outputs of
K10-K13 given the same per-lane scalars; their column sums are held to
1e-13 of the sums of their terms' absolute values.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ipx_tpu_torch import kernels
from ipx_tpu_torch.ops import device_cr, device_cr2, spmv
from ipx_tpu_torch.parallel import batch

pytestmark = pytest.mark.cuda
RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}
DTYPES = [torch.float64, torch.float32]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from ipx_tpu_torch import backend
    return backend.cuda_device()


def _rel(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-300))


def _matrix(m, n, density, seed):
    rng = np.random.default_rng(seed)
    A = sp.random(m, n, density=density, random_state=rng, format="csc",
                  data_rvs=rng.standard_normal).tolil()
    A[0, :] = rng.standard_normal(n)     # one row longer than a warp
    A[m // 2, :] = 0.0                   # and an empty one
    A = sp.csc_matrix(A)
    A.eliminate_zeros()
    A.sort_indices()
    return A, rng


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("density", [0.02, 0.3])
def test_csr_spmv(dev, dtype, density):
    A, rng = _matrix(1000, 300, density, seed=1)
    csr = A.tocsr()
    op = spmv.CsrOperand(csr.indptr, csr.indices, csr.data, A.shape[1], dev,
                         dtype)
    x = torch.from_numpy(rng.standard_normal(A.shape[1])).to(dtype).to(dev)
    before = kernels.LAUNCHES["csr_spmv"]
    y = spmv.csr_spmv(op, x)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["csr_spmv"] == before + 1
    assert _rel(y, spmv.csr_spmv_plain(op, x)) <= RTOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_spmv_plan(dev, dtype):
    """K1 through its plan (kernels.SpmvPlan, cached on the operand): 1e-12
    (f64) or 1e-5 (f32) of csr_spmv_plain, bit for bit from run to run and
    against a direct call of the plan, one launch counted per csr_spmv, and
    right at every lanes-per-row setting the plan takes."""
    A, rng = _matrix(1000, 300, 0.03, seed=21)
    csr = A.tocsr()
    op = spmv.CsrOperand(csr.indptr, csr.indices, csr.data, A.shape[1], dev,
                         dtype)
    x = torch.from_numpy(rng.standard_normal(A.shape[1])).to(dtype).to(dev)
    before = kernels.LAUNCHES["csr_spmv"]
    y = kernels.csr_spmv(op, x).clone()
    y2 = kernels.csr_spmv(op, x)
    assert kernels.LAUNCHES["csr_spmv"] == before + 2
    plan = kernels.plan_of(op)
    assert plan is kernels.plan_of(op) and plan.vec == kernels.k1_lanes(op)
    assert torch.equal(y, y2) and torch.equal(y, plan(x))
    out = torch.empty_like(y)
    assert kernels.csr_spmv(op, x, out=out) is out
    want = spmv.csr_spmv_plain(op, x)
    assert _rel(y, want) <= RTOL[dtype]
    for vec in (2, 4, 8, 16, 32):
        assert _rel(kernels.SpmvPlan(op, vec)(x), want) <= RTOL[dtype], vec
    with pytest.raises(ValueError, match="lanes per row"):
        kernels.SpmvPlan(op, 3)


def _rows_of(lengths, n, seed):
    """A CSC matrix with n columns whose row i holds lengths[i] entries."""
    rng = np.random.default_rng(seed)
    indptr = np.concatenate([[0], np.cumsum(lengths)])
    indices = np.concatenate([np.sort(rng.choice(n, k, replace=False))
                              for k in lengths]).astype(np.int32)
    return sp.csc_matrix(sp.csr_matrix(
        (rng.standard_normal(indptr[-1]), indices, indptr),
        shape=(len(lengths), n))), rng


@pytest.mark.parametrize("lengths", [[20] * 800 + [5] * 1200, [10] * 1000,
                                     [40, 3, 9, 1] * 150, [7] * 5],
                         ids=["vecs-differ", "vecs-agree", "ragged",
                              "empty-last"])
def test_block_products_in_one_launch(dev, lengths):
    """The P = 4 block products in one K1 launch (BlockSpmvPlan) against P
    per-block K1 launches: out and the partials bit for bit (each block
    keeps its own lanes per row, k1_lanes), the layout the C entry's, 1e-12
    of the plain version, bit for bit from run to run, one launch counted; a
    done CR state makes the launch return at once."""
    from ipx_tpu_torch.parallel import sharding
    A, rng = _rows_of(lengths, 100, seed=len(lengths))
    m, n = A.shape
    snm = sharding.ShardedNormalMatrix(A, 4, dev)
    vecs = [kernels.k1_lanes(op) for op in snm.op_A]
    if len(lengths) == 2000:
        assert vecs == [16, 8, 4, 4]
    _, blk_off = kernels.block_layout([op.rows for op in snm.op_A], vecs)
    lib = kernels.load()
    assert np.diff(blk_off).tolist() == [
        int(lib.ipxt_spmv_blocks(op.rows, vec))
        for op, vec in zip(snm.op_A, vecs)]
    t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    u, Wl, v = t(rng.standard_normal(n)), t(rng.uniform(0.5, 2.0, m)), \
        t(rng.standard_normal(m))
    out = torch.empty(m, dtype=torch.float64, device=dev)
    parts = torch.empty(blk_off[-1], dtype=torch.float64, device=dev)
    plan = kernels.BlockSpmvPlan(snm.op_A, u, out, Wl, v, parts)
    before = kernels.LAUNCHES["csr_spmv"]
    plan.launch()
    out1, parts1 = out.clone(), parts.clone()
    plan.launch()
    assert kernels.LAUNCHES["csr_spmv"] == before + 2
    assert torch.equal(out, out1) and torch.equal(parts, parts1)
    ref_out = torch.full_like(out, float("nan"))
    ref_parts = torch.full_like(parts, float("nan"))
    kernels._block_products(kernels.csr_spmv, snm.op_A, u, ref_out, Wl, v,
                            kernels._slices(ref_parts, np.diff(blk_off)),
                            None)
    assert torch.equal(out, ref_out) and torch.equal(parts, ref_parts)
    plain = torch.cat([spmv.csr_spmv_plain(op, u) + Wl[r0:r1] * v[r0:r1]
                       for op, (r0, r1) in zip(snm.op_A, snm.bounds)])
    assert _rel(out, plain) <= 1e-12
    state = torch.zeros(int(lib.ipxt_cr_state_len()), dtype=torch.float64,
                        device=dev)
    state[5] = 1.0                              # the done flag
    idle = torch.full_like(out, 7.0)
    kernels.BlockSpmvPlan(snm.op_A, u, idle, Wl, v, state=state).launch()
    assert bool((idle == 7.0).all())


@pytest.mark.parametrize("dtype", DTYPES)
def test_normal_apply_is_right_and_repeatable(dev, dtype):
    A, rng = _matrix(700, 1500, 0.01, seed=2)
    m, n = A.shape
    nmd = spmv.NormalMatrixDevice(A, dev, dtype)
    W = torch.from_numpy(rng.uniform(0.1, 3.0, n + m)).to(dtype).to(dev)
    v = torch.from_numpy(rng.standard_normal(m)).to(dtype).to(dev)
    Cv, vCv = nmd.apply(W, v)
    Cv2, vCv2 = nmd.apply(W, v)
    want, want_dot = spmv.normal_apply_plain(nmd, W, v)
    assert _rel(Cv, want) <= RTOL[dtype]
    assert abs(float(vCv) - float(want_dot)) <= RTOL[dtype] * abs(
        float(want_dot))
    # fixed-order reductions: bit-identical from run to run
    assert torch.equal(Cv, Cv2) and float(vCv) == float(vCv2)


def _cr_inputs(dev, dtype, W_sign=1.0, diag_sign=1.0):
    A, rng = _matrix(600, 900, 0.01, seed=3)
    m, n = A.shape
    W = W_sign * rng.uniform(0.5, 2.0, n + m)
    A2 = A.copy()
    A2.data **= 2
    diag = diag_sign * (A2 @ np.abs(W[:n]) + np.abs(W[n:]))
    t = lambda x: torch.from_numpy(np.asarray(x, dtype=np.float64)).to(
        dtype).to(dev)
    nmd = spmv.NormalMatrixDevice(A, dev, dtype)
    return (nmd, t(W), t(1.0 / diag), t(1.0 / np.sqrt(np.abs(W[n:]))),
            t(rng.standard_normal(m)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_cr_solve_matches_plain(dev, dtype):
    """K3 on the card, one cooperative launch a solve with its K2 applies
    inside (1 + the trips + a recheck's every 5th, as its state counts
    them, and no K2 launch of its own), against the plain version."""
    nmd, W, invd, resscale, rhs = _cr_inputs(dev, dtype)
    tol = 1e-10 if dtype == torch.float64 else 1e-4
    before = dict(kernels.LAUNCHES)
    inside = kernels.INSIDE["normal_apply"]
    y, it, err = device_cr.cr_solve(nmd, W, invd, resscale, rhs, tol, 1000)
    assert kernels.LAUNCHES["cr_step"] == before["cr_step"] + 1
    assert kernels.LAUNCHES["normal_apply"] == before["normal_apply"]
    assert kernels.INSIDE["normal_apply"] == inside + 1 + it + it // 5
    y_p, it_p, err_p = device_cr.cr_solve_plain(nmd, W, invd, resscale, rhs,
                                                tol, 1000)
    assert err == err_p == 0
    assert abs(it - it_p) <= 2
    if dtype == torch.float64:
        assert _rel(y, y_p) <= 1e-8


@pytest.mark.parametrize("case", ["iter_limit", "not_posdef",
                                  "precond_not_posdef", "converged_first"])
def test_cr_solve_stop_codes_match_plain(dev, case):
    kw, tol, maxiter = {}, 1e-14, 1000
    if case == "iter_limit":
        maxiter = 7        # stops on a trip that follows a recheck
    elif case == "not_posdef":
        kw = dict(W_sign=-1.0, diag_sign=-1.0)
    elif case == "precond_not_posdef":
        kw = dict(diag_sign=-1.0)
    nmd, W, invd, resscale, rhs = _cr_inputs(dev, torch.float64, **kw)
    if case == "converged_first":
        rhs = torch.zeros_like(rhs)
        maxiter = 0
    got = device_cr.cr_solve(nmd, W, invd, resscale, rhs, tol, maxiter)
    want = device_cr.cr_solve_plain(nmd, W, invd, resscale, rhs, tol,
                                    maxiter)
    assert got[1:] == want[1:]
    assert _rel(got[0], want[0]) <= 1e-10 or float(want[0].abs().max()) == 0


# the cases of the cooperative K3 against its host-issued form: the stop
# codes above, a tolerance no trip meets (the loop ends by stagnation or
# the trip limit), and a solve that converges after more than 5 rechecks
COOP_CASES = ["iter_limit", "not_posdef", "precond_not_posdef",
              "converged_first", "unreachable", "converged_f64",
              "converged_f32"]


def _coop_case(case):
    """Runs K3 in both forms on `case` and asserts them equal bit for bit:
    lhs, iterations and error code. Run in a subprocess by the test below,
    so that a grid that deadlocks fails on its time limit."""
    from ipx_tpu_torch import backend
    dev = backend.cuda_device()
    dtype = torch.float32 if case == "converged_f32" else torch.float64
    kw, tol, maxiter = {}, 1e-14, 1000
    if case == "iter_limit":
        maxiter = 7
    elif case == "not_posdef":
        kw = dict(W_sign=-1.0, diag_sign=-1.0)
    elif case == "precond_not_posdef":
        kw = dict(diag_sign=-1.0)
    elif case == "unreachable":
        tol, maxiter = 0.0, 400
    elif case in ("converged_f64", "converged_f32"):
        tol = 1e-9 if dtype == torch.float64 else 1e-4
    nmd, W, invd, resscale, rhs = _cr_inputs(dev, dtype, **kw)
    if case == "converged_first":
        rhs = torch.zeros_like(rhs)
        maxiter = 0
    got = device_cr.cr_solve(nmd, W, invd, resscale, rhs, tol, maxiter)
    want = kernels.CrStep(nmd.op_At, nmd.op_A, W, invd, resscale, rhs).solve(
        maxiter, tol, cooperative=False)
    torch.cuda.synchronize()
    assert got[1:] == want[1:], (got[1:], want[1:])
    assert torch.equal(got[0], want[0])
    if case == "converged_f64":     # more than 5 rechecks
        assert got[2] == 0 and got[1] > 6 * 5, got[1:]
    elif case == "converged_f32":
        assert got[2] == 0, got[1:]
    print(case, got[1:])


@pytest.mark.parametrize("case", COOP_CASES)
def test_cr_solve_cooperative_matches_host_issued(dev, case):
    """K3's cooperative launch against its host-issued passes, bit for bit,
    in a subprocess with a time limit."""
    import os
    import subprocess
    import sys
    here = os.path.dirname(os.path.abspath(__file__))
    code = (f"import sys; sys.path.insert(0, {here!r}); "
            f"import test_torch_cuda as t; t._coop_case({case!r})")
    out = subprocess.run([sys.executable, "-c", code],
                         cwd=os.path.dirname(here), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]


def _nnt_operands(dev, P, seed=4, m=500, n=800):
    """N' and N (split at P column blocks) of a 500 x 800 matrix with a
    long and an empty row, and the per-block operands of the plain
    version."""
    from ipx_tpu_torch.parallel import sharding
    A, rng = _matrix(m, n, 0.01, seed=seed)
    nnt = sharding.ShardedSplittedNNt(m, n, P, dev)
    nnt.set_operand(A)
    return nnt, torch.from_numpy(rng.standard_normal(m)).to(dev)


def test_nnt(dev):
    """K4 through device_cr2.nnt: one launch, no K1, 1e-12 of the plain
    version."""
    nnt, w = _nnt_operands(dev, 1)
    Nt, N = nnt.plan.Nt, nnt.plan.N
    before = dict(kernels.LAUNCHES)
    z = device_cr2.nnt(Nt, N, w)
    assert kernels.LAUNCHES["nnt"] == before["nnt"] + 1
    assert kernels.LAUNCHES["csr_spmv"] == before["csr_spmv"]
    assert _rel(z, device_cr2.nnt_plain(Nt, N, w)) <= 1e-12


@pytest.mark.parametrize("cooperative", [True, False],
                         ids=["cooperative", "two-launch"])
@pytest.mark.parametrize("P", [1, 4])
def test_nnt_plan_forms(dev, P, cooperative):
    """K4 at P = 1 and 4 in both forms: 1e-12 of nnt_plain and
    block_nnt_plain, equal bit for bit across two runs and across the two
    forms, one launch counted per apply, and the host apply through the
    pinned buffers gives the same z."""
    from ipx_tpu_torch.parallel import sharding
    nnt, w = _nnt_operands(dev, P)
    plan = device_cr2.NntPlan(nnt.plan.Nt, nnt.plan.N, None)
    before = kernels.LAUNCHES["nnt"]
    z = plan._kernel.launch(w, cooperative).clone()
    z2 = plan._kernel.launch(w, cooperative).clone()
    assert kernels.LAUNCHES["nnt"] == before + 2
    assert torch.equal(z, z2)
    assert torch.equal(z, plan._kernel.launch(w, not cooperative))
    assert torch.equal(z, plan(w))
    want = (device_cr2.nnt_plain(nnt.blocks[0][0], nnt.blocks[0][1], w)
            if P == 1 else sharding.block_nnt_plain(nnt.blocks, w))
    assert _rel(z, want) <= 1e-12
    assert _rel(z, device_cr2.nnt_plain(nnt.plan.Nt, nnt.plan.N, w)) <= 1e-12
    host = plan.apply(w.cpu().numpy())
    assert np.array_equal(host, z.cpu().numpy())


def test_split_refuses_more_blocks_than_it_takes(dev):
    """K4 and K14v take at most kernels.MAX_SPLIT blocks; more raise."""
    from ipx_tpu_torch.parallel import sharding
    A, rng = _matrix(60, 90, 0.05, seed=5)
    nnt = sharding.ShardedSplittedNNt(60, 90, kernels.MAX_SPLIT + 1, dev)
    with pytest.raises(ValueError, match="blocks"):
        nnt.set_operand(A)


def test_launcher_checks_raise(dev):
    A, rng = _matrix(50, 40, 0.1, seed=5)
    csr = A.tocsr()
    op = spmv.CsrOperand(csr.indptr, csr.indices, csr.data, A.shape[1], dev,
                         torch.float64)
    with pytest.raises(ValueError, match="dtype"):
        kernels.csr_spmv(op, torch.zeros(40, dtype=torch.float32,
                                         device=dev))
    with pytest.raises(ValueError, match="shape"):
        kernels.csr_spmv(op, torch.zeros(41, dtype=torch.float64,
                                         device=dev))


def test_refused_launch_raises(dev):
    """An error the C entry returns (here: 3 lanes per row, which it
    refuses) reaches Python as an exception."""
    A, _ = _matrix(50, 40, 0.1, seed=6)
    csr = A.tocsr()
    op = spmv.CsrOperand(csr.indptr, csr.indices, csr.data, A.shape[1], dev,
                         torch.float64)
    x = torch.zeros(40, dtype=torch.float64, device=dev)
    y = torch.empty(50, dtype=torch.float64, device=dev)
    lib = kernels.load()
    err = lib.ipxt_csr_spmv_f64(
        op.rows, op.indptr.data_ptr(), op.indices.data_ptr(),
        op.vals.data_ptr(), x.data_ptr(), None, None, None, y.data_ptr(),
        None, None, 3, torch.cuda.current_stream(dev).cuda_stream)
    assert err != 0
    with pytest.raises(RuntimeError, match="CUDA error"):
        kernels._raise_if(err, "csr_spmv")


# -- the batched kernels K5-K9 ------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", [1, 3, 4, 300])
def test_csr_spmm(dev, dtype, B):
    A, rng = _matrix(700, 300, 0.02, seed=7)
    for indptr, indices, data, cols in ((A.tocsr().indptr, A.tocsr().indices,
                                         A.tocsr().data, A.shape[1]),
                                        (A.indptr, A.indices, A.data,
                                         A.shape[0])):
        op = spmv.CsrOperand(indptr, indices, data, cols, dev, dtype)
        U = torch.from_numpy(rng.standard_normal((cols, B))).to(dtype).to(dev)
        before = kernels.LAUNCHES["csr_spmm"]
        Y = spmv.csr_spmm(op, U)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["csr_spmm"] == before + 1
        assert _rel(Y, spmv.csr_spmm_plain(op, U)) <= RTOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", [1, 7, 256])
def test_csr_spmm_unrolled_matches_one_at_a_time(dev, dtype, B):
    """K5 with two gathers issued together against its loop of one nonzero
    at a time, bit for bit, with and without the epilogues (rowscale, addw
    and addv, the partials), on A (long and empty rows) and A' of a random
    matrix and on A' of the transportation pattern (2 nonzeros a row, where
    k5_unroll takes 2)."""
    A, rng = _matrix(700, 1500, 0.01, seed=8)
    ops = [spmv.NormalMatrixDevice(A, dev, dtype),
           _transportation_nmd(dev, dtype)]
    assert kernels.k5_unroll(ops[1].op_At) == 2
    assert kernels.k5_unroll(ops[0].op_A) == 1
    t = lambda x: torch.from_numpy(x).to(dtype).to(dev)  # noqa: E731
    for op in (ops[0].op_A, ops[0].op_At, ops[1].op_At):
        U = t(rng.standard_normal((op.cols, B)))
        rows = t(rng.uniform(0.1, 3.0, (3, op.rows, B)))
        vw = kernels.spmm_width(B, dtype, U, *rows)
        got = {}
        for unroll in (1, 2):
            Y, Y2 = (torch.full((op.rows, B), 7.0, dtype=dtype, device=dev)
                     for _ in range(2))
            p = torch.full((kernels.lane_blocks(op.rows, B // vw), B), 7.0,
                           dtype=dtype, device=dev)
            kernels._spmm(op, U, Y, unroll=unroll)
            kernels._spmm(op, U, Y2, rowscale=rows[0], addw=rows[1],
                          addv=rows[2], partials=p, unroll=unroll)
            got[unroll] = (Y, Y2, p)
        torch.cuda.synchronize()
        for a, b in zip(got[1], got[2]):
            assert torch.equal(a, b)
        assert _rel(got[2][0], spmv.csr_spmm_plain(op, U)) <= RTOL[dtype]


def _long_rows_operand(dtype, dev, seed=9):
    """A CSR operand whose first row has 3000 nonzeros, so that its row
    tile holds more than the K5_STAGE_NZ nonzeros a tile stages, beside
    rows of 0 to 12."""
    rng = np.random.default_rng(seed)
    lengths = [3000] + list(rng.integers(0, 13, 400))
    indptr = np.concatenate([[0], np.cumsum(lengths)])
    indices = np.concatenate([np.sort(rng.choice(3000, k, replace=False))
                              for k in lengths])
    return spmv.CsrOperand(indptr, indices, rng.standard_normal(indptr[-1]),
                           3000, dev, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", [1, 4, 7, 8, 256])
def test_csr_spmm_tiled_matches_row_body(dev, dtype, B):
    """K5's tiled form (the plain product) against its row body at unroll 1
    and 2, bit for bit: on A (a row longer than a warp and the ring, an
    empty row) and A' of a random matrix, A and A' of the transportation
    pattern, and an operand whose row tile holds more nonzeros than a tile
    stages (read in place); and k5_form's pick through csr_spmm."""
    A, rng = _matrix(700, 1500, 0.01, seed=8)
    nmds = [spmv.NormalMatrixDevice(A, dev, dtype),
            _transportation_nmd(dev, dtype)]
    t = lambda x: torch.from_numpy(x).to(dtype).to(dev)  # noqa: E731
    ops = [nmds[0].op_A, nmds[0].op_At, nmds[1].op_A, nmds[1].op_At,
           _long_rows_operand(dtype, dev)]
    for op in ops:
        U = t(rng.standard_normal((op.cols, B)))
        want = {}
        for unroll in (1, 2):
            want[unroll] = torch.full((op.rows, B), 7.0, dtype=dtype,
                                      device=dev)
            kernels._spmm(op, U, want[unroll], form="row", unroll=unroll)
        Y = torch.full((op.rows, B), 7.0, dtype=dtype, device=dev)
        kernels._spmm(op, U, Y, form="tile")
        torch.cuda.synchronize()
        assert torch.equal(Y, want[1]), op.rows
        assert torch.equal(want[1], want[2])
        before = kernels.LAUNCHES["csr_spmm"]
        Y = kernels.csr_spmm(op, U)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["csr_spmm"] == before + 1
        assert torch.equal(Y, want[1])
        assert _rel(Y, spmv.csr_spmm_plain(op, U)) <= RTOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_csr_spmm_tiled_empty_operands(dev, dtype):
    """The tiled form on an operand of no rows, whose arrays are null
    (PyTorch's pointer of an empty tensor), and on one of rows without
    nonzeros: no launch error, Y empty or zero."""
    B = 8
    U = torch.ones((5, B), dtype=dtype, device=dev)
    empty = spmv.CsrOperand(np.zeros(1, dtype=np.int64),
                            np.zeros(0, dtype=np.int32), np.zeros(0), 5,
                            dev, dtype)
    Y = torch.empty((0, B), dtype=dtype, device=dev)
    kernels._spmm(empty, U, Y, form="tile")
    hollow = spmv.CsrOperand(np.zeros(4, dtype=np.int64),
                             np.zeros(0, dtype=np.int32), np.zeros(0), 5,
                             dev, dtype)
    Y = torch.full((3, B), 7.0, dtype=dtype, device=dev)
    kernels._spmm(hollow, U, Y, form="tile")
    torch.cuda.synchronize()
    assert torch.equal(Y, torch.zeros_like(Y))


def test_csr_spmm_tiled_refuses_an_epilogue(dev):
    A, rng = _matrix(50, 40, 0.1, seed=5)
    op = spmv.NormalMatrixDevice(A, dev).op_A
    U = torch.ones((40, 4), dtype=torch.float64, device=dev)
    Y = torch.empty((50, 4), dtype=torch.float64, device=dev)
    with pytest.raises(ValueError, match="tiled form"):
        kernels._spmm(op, U, Y, addw=Y, addv=Y, form="tile")
    # a tile of more rows than a block takes: the C entry's refusal
    # reaches Python
    err = kernels.load().ipxt_csr_spmm_tile_f64(
        op.rows, 4, op.indptr.data_ptr(), op.indices.data_ptr(),
        op.vals.data_ptr(), U.data_ptr(), Y.data_ptr(), 2, 2, 1000,
        torch.cuda.current_stream(dev).cuda_stream)
    assert err != 0
    with pytest.raises(RuntimeError, match="CUDA error"):
        kernels._raise_if(err, "csr_spmm (tiled)")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", [3, 8])
def test_normal_apply_batched_is_right_and_repeatable(dev, dtype, B):
    A, rng = _matrix(700, 1500, 0.01, seed=8)
    m, n = A.shape
    nmd = spmv.NormalMatrixDevice(A, dev, dtype)
    W = torch.from_numpy(rng.uniform(0.1, 3.0, (n + m, B))).to(dtype).to(dev)
    V = torch.from_numpy(rng.standard_normal((m, B))).to(dtype).to(dev)
    out, dots = nmd.apply_batched(W, V)
    out2, dots2 = nmd.apply_batched(W, V)
    want, want_dots = spmv.normal_apply_batched_plain(nmd, W, V)
    assert _rel(out, want) <= RTOL[dtype]
    assert torch.all((dots.double() - want_dots.double()).abs()
                     <= RTOL[dtype] * want_dots.double().abs())
    # fixed-order reductions: bit-identical from run to run
    assert torch.equal(out, out2) and torch.equal(dots, dots2)


def _transportation_nmd(dev, dtype):
    """A' and A of a small transportation LP: every column of A has 2
    nonzeros, the pattern on which K6's plan takes the fused launch."""
    from ipx_tpu_torch import testgen as tg
    data = tg.transportation(40, 60, 0.1, seed=5)
    A = sp.csc_matrix((data["Ax"], data["Ai"], data["Ap"]),
                      shape=(data["num_constr"], data["num_var"]))
    return spmv.NormalMatrixDevice(A, dev, dtype)


@pytest.mark.parametrize("state", [None, "running", "done"])
@pytest.mark.parametrize("B", [1, 7, 256])
@pytest.mark.parametrize("dtype", DTYPES)
def test_normal_apply_batched_fused_matches_two_launches(dev, dtype, B,
                                                         state):
    """K6's fused launch against its two K5 launches: out and the partials
    bit for bit, at B = 1, 7 (no vector loads) and 256, on an operand with
    long and empty rows (the two-launch pattern of the plan) and on the
    transportation pattern (the fused one); within RTOL of the plain
    version; the wrapper takes the plan's form and counts one apply; with a
    done CR state neither form writes out."""
    A, rng = _matrix(700, 1500, 0.01, seed=8)
    for nmd in (spmv.NormalMatrixDevice(A, dev, dtype),
                _transportation_nmd(dev, dtype)):
        m, n = nmd.m, nmd.n
        t = lambda x: torch.from_numpy(x).to(dtype).to(dev)  # noqa: E731
        W, V = t(rng.uniform(0.1, 3.0, (n + m, B))), t(
            rng.standard_normal((m, B)))
        st = None
        if state is not None:
            st = torch.zeros(int(kernels.load().ipxt_bcr_state_len(B)),
                             dtype=dtype, device=dev)
            st[5] = float(state == "done")          # kDone
        plan = kernels.normal_plan_of(nmd.op_At, nmd.op_A)
        outs, parts = {}, {}
        for fused in (True, False, None):
            out = torch.full((m, B), 7.0, dtype=dtype, device=dev)
            p = torch.full(plan.partials_shape(W, V, out), 7.0, dtype=dtype,
                           device=dev)
            if fused is None:       # the wrapper, in the plan's form
                before = kernels.LAUNCHES["normal_apply_batched"]
                kernels.normal_apply_batched(nmd.op_At, nmd.op_A, W, V,
                                             out=out, partials=p, state=st)
                assert kernels.LAUNCHES["normal_apply_batched"] == before + 1
            else:
                plan(W, V, out=out, partials=p, state=st, fused=fused)
            outs[fused], parts[fused] = out, p
        torch.cuda.synchronize()
        for form in (False, None):
            assert torch.equal(outs[True], outs[form])
            assert torch.equal(parts[True], parts[form])
        if state == "done":
            assert bool((outs[True] == 7.0).all())
            continue
        want, want_dots = spmv.normal_apply_batched_plain(nmd, W, V)
        assert _rel(outs[True], want) <= RTOL[dtype]
        dots = parts[True].double().sum(0)
        assert torch.all((dots - want_dots.double()).abs()
                         <= RTOL[dtype] * (V * want).double().abs().sum(0))


def test_k6_plan_takes_the_fused_form_by_column_lengths(dev):
    """On the transportation pattern the plan takes the fused launch and
    K7's step object allocates no U; on an operand with a dense row (a
    column length of m in A') the two launches and U."""
    A, _ = _matrix(700, 1500, 0.01, seed=8)
    for nmd, fused in ((_transportation_nmd(dev, torch.float32), True),
                       (spmv.NormalMatrixDevice(A.T.tocsc(), dev,
                                                torch.float32), False)):
        m, n = nmd.m, nmd.n
        assert kernels.normal_plan_of(nmd.op_At, nmd.op_A).fused is fused
        e = lambda *s: torch.ones(s, dtype=torch.float32, device=dev)  # noqa
        cr = kernels.BatchedCrStep(nmd.op_At, nmd.op_A, e(n + m, 8), e(m, 8),
                                   e(m, 8), e(8), e(m, 8))
        assert (cr.U is None) is fused


def _batched_cr_inputs(dev, dtype, B=4):
    A, rng = _matrix(600, 900, 0.01, seed=9)
    m, n = A.shape
    W = rng.uniform(0.5, 2.0, (n + m, B))
    A2 = A.copy()
    A2.data **= 2
    diag = A2 @ W[:n] + W[n:]
    rs = 1.0 / np.sqrt(W[n:])
    rhs = rng.standard_normal((m, B))
    base = np.max(np.abs(rs * rhs), axis=0)
    t = lambda x: torch.from_numpy(np.asarray(x, dtype=np.float64)).to(
        dtype).to(dev)
    return (spmv.NormalMatrixDevice(A, dev, dtype), t(W), t(1.0 / diag),
            t(rs), t(rhs), base)


def test_batched_cr_lanes_converge_apart(dev):
    """K7 in float64 with lanes that converge at different trips (one
    already at trip 0): the trips and each lane's Y equal the plain batched
    CR's, and a frozen lane keeps its Y bit for bit."""
    nmd, W, invd, rs, rhs, base = _batched_cr_inputs(dev, torch.float64)
    tol = torch.from_numpy(base * np.array([10.0, 1e-2, 1e-6, 1e-11])).to(
        dev)
    before = kernels.LAUNCHES["batched_cr_step"]
    Y, trips = batch.batched_cr(nmd, W, invd, rs, rhs, tol, 1000)
    assert kernels.LAUNCHES["batched_cr_step"] > before
    Y_p, trips_p = batch.batched_cr_plain(nmd, W, invd, rs, rhs, tol, 1000)
    assert trips == trips_p > 0
    assert torch.all(Y[:, 0] == 0)
    for b in range(1, 4):
        assert _rel(Y[:, b], Y_p[:, b]) <= 1e-8, b
    Y1, trips1 = batch.batched_cr(nmd, W, invd, rs, rhs, tol, trips - 1)
    assert trips1 == trips - 1
    assert torch.equal(Y1[:, 1], Y[:, 1]) and torch.equal(Y1[:, 0], Y[:, 0])
    # the same loop twice: bit for bit
    Y2, _ = batch.batched_cr(nmd, W, invd, rs, rhs, tol, 1000)
    assert torch.equal(Y, Y2)


def test_batched_cr_f32_and_iteration_limit(dev):
    """K7 in float32 meets each lane's tolerance within 10% of the plain
    version's trips; with maxiter 7 both stop at 7 with close Y."""
    nmd, W, invd, rs, rhs, base = _batched_cr_inputs(dev, torch.float32)
    tol = torch.from_numpy(1e-4 * base).float().to(dev)
    Y, trips = batch.batched_cr(nmd, W, invd, rs, rhs, tol, 1000)
    Y_p, trips_p = batch.batched_cr_plain(nmd, W, invd, rs, rhs, tol, 1000)
    assert abs(trips - trips_p) <= 0.1 * trips_p
    assert _rel(Y, Y_p) <= 1e-3
    Y7, t7 = batch.batched_cr(nmd, W, invd, rs, rhs, tol, 7)
    Y7_p, t7_p = batch.batched_cr_plain(nmd, W, invd, rs, rhs, tol, 7)
    assert t7 == t7_p == 7
    assert _rel(Y7, Y7_p) <= 1e-4


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", [1, 7, 256, 300])
def test_batched_cr_lane_passes_over_blocks(dev, dtype, B):
    """K7 with its lane passes a warp per lane over blocks, at B below a
    warp, not a multiple of 8, one block's 256 lanes and past them, the
    lanes' tolerances spread over decades so that they freeze at different
    trips, and every 37th lane from lane 5 done at once: every lane meets
    its tolerance (its scaled residual in float64 on the host, within the
    rounding of the recurrence: 1e-6 in f64, 1e-3 in f32), a lane done at
    once keeps Y = 0, the trips are within 2 (f64) or 10% (f32) of the plain
    version's, and two runs agree bit for bit."""
    nmd, W, invd, rs, rhs, base = _batched_cr_inputs(dev, dtype, B)
    A, _ = _matrix(600, 900, 0.01, seed=9)
    n = A.shape[1]
    rng = np.random.default_rng(B)
    f64 = dtype == torch.float64
    rel = 10.0 ** (rng.uniform(-8, -3, B) if f64 else rng.uniform(-4, -2, B))
    rel[5::37] = 10.0
    tol = torch.from_numpy(base * rel).to(dtype).to(dev)
    before = kernels.LAUNCHES["batched_cr_step"]
    Y, trips = batch.batched_cr(nmd, W, invd, rs, rhs, tol, 1000)
    assert kernels.LAUNCHES["batched_cr_step"] > before
    Y2, trips2 = batch.batched_cr(nmd, W, invd, rs, rhs, tol, 1000)
    assert trips2 == trips and torch.equal(Y, Y2)
    _, trips_p = batch.batched_cr_plain(nmd, W, invd, rs, rhs, tol, 1000)
    if f64:
        assert abs(trips - trips_p) <= 2
    else:
        assert abs(trips - trips_p) <= 0.1 * trips_p
    assert bool((Y[:, 5::37] == 0).all())
    h = lambda x: x.double().cpu().numpy()  # noqa: E731
    Yn, Wn = h(Y), h(W)
    res = h(rhs) - (A @ (Wn[:n] * (A.T @ Yn)) + Wn[n:] * Yn)
    slack = 1e-6 if f64 else 1e-3
    assert np.all(np.max(np.abs(h(rs) * res), axis=0)
                  <= h(tol) * (1 + slack))


@pytest.mark.parametrize("maxiter", [0, 1, 5])
def test_batched_cr_stops_on_the_trip_limit(dev, maxiter):
    """K7 at B = 300 in float64 with a tolerance no lane reaches: the loop
    stops on trip `maxiter` exactly, as the plain version does, with Y
    within 1e-10 of the plain version's (Y = 0 at maxiter 0)."""
    nmd, W, invd, rs, rhs, base = _batched_cr_inputs(dev, torch.float64, 300)
    tol = torch.from_numpy(base * 1e-30).to(dev)
    Y, trips = batch.batched_cr(nmd, W, invd, rs, rhs, tol, maxiter)
    Y_p, trips_p = batch.batched_cr_plain(nmd, W, invd, rs, rhs, tol,
                                          maxiter)
    assert trips == trips_p == maxiter
    assert _rel(Y, Y_p) <= 1e-10
    if maxiter == 0:
        assert bool((Y == 0).all())


def _step_inputs(dev, dtype, nm=3000, B=5, seed=10):
    rng = np.random.default_rng(seed)
    finl = rng.random(nm) < 0.8
    finu = rng.random(nm) < 0.4
    a = {}
    for name, fin in (("XL", finl), ("XU", finu), ("ZL", finl),
                      ("ZU", finu)):
        x = rng.uniform(1e-3, 10.0, (nm, B))
        x[~fin] = np.inf if name.startswith("X") else 0.0
        a[name] = x
        a["D" + name] = rng.standard_normal((nm, B)) * 5.0
    t = lambda x: torch.from_numpy(np.asarray(x)).to(dev)
    a = {k: t(v).to(dtype) for k, v in a.items()}
    return a, t(finl), t(finu), rng


ORDER = ("XL", "XU", "ZL", "ZU", "DXL", "DXU", "DZL", "DZU")


@pytest.mark.parametrize("dtype", DTYPES)
def test_step_batch_exact(dev, dtype):
    a, finl, finu, _ = _step_inputs(dev, dtype)
    args = [a[k] for k in ORDER] + [finl, finu]
    before = kernels.LAUNCHES["step_batch"]
    maxp, maxd = batch.step_batch(*args)
    assert kernels.LAUNCHES["step_batch"] == before + 1
    want_p, want_d = batch.step_batch_plain(*args)
    assert torch.equal(maxp, want_p) and torch.equal(maxd, want_d)
    assert bool((maxp < 1).any()) and bool((maxd < 1).any())
    mu = batch.muaff(*args, maxp, maxd, 1234)
    want_mu = batch.muaff_plain(*args, maxp, maxd, 1234)
    assert _rel(mu, want_mu) <= RTOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_ipm_update_exact(dev, dtype):
    a, finl, finu, rng = _step_inputs(dev, dtype, seed=11)
    nm, B = a["XL"].shape
    m = 1000
    t = lambda x: torch.from_numpy(np.asarray(x)).to(dtype).to(dev)
    X, DX = t(rng.standard_normal((nm, B))), t(rng.standard_normal((nm, B)))
    Y, DY = t(rng.standard_normal((m, B))), t(rng.standard_normal((m, B)))
    a["DXL"][7] = -a["XL"][7] * 3.0          # crosses the barrier floor
    ap, ad = t(rng.uniform(0.1, 1.0, B)), t(rng.uniform(0.1, 1.0, B))
    done = torch.tensor([False, True, False, False, True], device=dev)
    state = dict(X=X, XL=a["XL"], XU=a["XU"], Y=Y, ZL=a["ZL"], ZU=a["ZU"])
    got = {k: v.clone() for k, v in state.items()}
    want = {k: v.clone() for k, v in state.items()}
    dirs = (DX, a["DXL"], a["DXU"], DY, a["DZL"], a["DZU"])
    batch.ipm_update(*got.values(), *dirs, ap, ad, done, finl, finu)
    batch.ipm_update_plain(*want.values(), *dirs, ap, ad, done, finl, finu)
    for k in state:
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(got["X"][:, 1], state["X"][:, 1])   # a done lane
    assert bool((got["XL"] == 1e-30).any())


def test_batched_stage_matches_plain(dev):
    """BatchedPhase1Solver through K5-K9 against the same solver with the
    plain versions on the card, in float64: every lane converges in both,
    and pobj agrees within 2e-8, twice the optimality tolerance. The step
    counts are not compared: the CR stops at a loose tolerance, so a
    rounding difference that moves its last trip moves the trajectory, and
    per-lane step counts differ by up to 8 between ipx_tpu's and the
    port's runs of one batch on the CPU."""
    from ipx_tpu_torch import testgen as tg

    data = tg.transportation(30, 45, 0.1, seed=3)
    rng = np.random.default_rng(0)
    b = data["rhs"][None, :] * rng.uniform(0.97, 1.03, (8, data["num_constr"]))
    blp = batch.BatchedScenarioSolver(data, b).blp
    kernels.reset_launches()
    got = batch.BatchedPhase1Solver(blp, device="cuda", cr_dtype="f64").solve()
    for name in ("csr_spmm", "normal_apply_batched", "batched_cr_step",
                 "step_batch", "ipm_update"):
        assert kernels.LAUNCHES[name] > 0, name
    want = batch.PlainBatchedPhase1Solver(blp, device="cuda",
                                          cr_dtype="f64").solve()
    assert np.all(got["done"]) and np.all(want["done"])
    assert np.all(np.abs(got["pobj"] - want["pobj"])
                  <= 2e-8 * np.abs(want["pobj"]))


def test_batched_request_crosses_through_page_locked_memory(dev):
    """On the card a request's arrays go up and its answer comes down
    through page-locked host memory: both byte counters are read, none
    went through pageable memory, and the returned X is page-locked (by
    CUDA's pointer attributes, which Tensor.is_pinned reads). The
    constructor's b', c', norms and limits equal the "cpu" path's bit for
    bit; the copy out of a card state equals the tensors copied one by one
    bit for bit, with pobj within 1e-12 of numpy's sum of c' .* X; and a
    whole solve agrees with the "cpu" path as the stage's kernels agree
    with their plain versions (test_batched_stage_matches_plain: every
    lane converged, pobj within 2e-8)."""
    from ipx_tpu_torch import testgen as tg

    data = tg.transportation(30, 45, 0.1, seed=3)
    rng = np.random.default_rng(0)
    b = data["rhs"][None, :] * rng.uniform(0.97, 1.03, (8, data["num_constr"]))
    blp = batch.BatchedScenarioSolver(data, b).blp
    got_s = batch.BatchedPhase1Solver(blp, device="cuda", cr_dtype="f64")
    want_s = batch.BatchedPhase1Solver(blp, device="cpu", cr_dtype="f64")
    assert torch.equal(got_s.bT.cpu(), want_s.bT)
    assert torch.equal(got_s.cT.cpu(), want_s.cT)
    for k in ("norm_bounds", "norm_c"):
        assert got_s.static[k] == want_s.static[k], k
    assert got_s._tests == want_s._tests
    c = got_s.trace.counts
    up = sum(a.nbytes for a in (blp.lb, blp.ub, blp.b, blp.c))
    assert c["copy_bytes_pinned"] >= up and c["copy_bytes_pageable"] == 0
    assert c["host_syncs"] == 1

    S = got_s._starting_point()
    out = got_s._copy_out(S)
    for k, v in S.items():
        want = v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
        assert out[k].dtype == want.dtype and out[k].shape == want.shape, k
        assert out[k].flags.c_contiguous, k
        assert np.array_equal(out[k], want), k
    pobj = np.sum(blp.c.T * out["X"], axis=0)
    assert np.all(np.abs(out["pobj"] - pobj) <= 1e-12 * np.abs(pobj))

    got = got_s.solve()
    c = got_s.trace.counts
    assert c["copy_bytes_pinned"] > up and c["copy_bytes_pageable"] == 0
    assert torch.from_numpy(got["X"]).is_pinned()
    want = want_s.solve()
    assert set(got) == set(want)
    assert np.all(got["done"]) and np.all(want["done"])
    assert np.all(np.abs(got["pobj"] - want["pobj"])
                  <= 2e-8 * np.abs(want["pobj"]))


def test_batched_launcher_checks_raise(dev):
    A, rng = _matrix(50, 40, 0.1, seed=12)
    csr = A.tocsr()
    op = spmv.CsrOperand(csr.indptr, csr.indices, csr.data, A.shape[1], dev,
                         torch.float64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.csr_spmm(op, torch.zeros((40, 3), dtype=torch.float64))
    with pytest.raises(ValueError, match="dtype"):
        kernels.csr_spmm(op, torch.zeros((40, 3), dtype=torch.float32,
                                         device=dev))
    with pytest.raises(ValueError, match="shape"):
        kernels.csr_spmm(op, torch.zeros((41, 3), dtype=torch.float64,
                                         device=dev))
    with pytest.raises(ValueError, match="shape"):
        kernels.csr_spmm(op, torch.zeros(40, dtype=torch.float64,
                                         device=dev))
    a, finl, finu, _ = _step_inputs(dev, torch.float64, nm=40, B=3)
    with pytest.raises(ValueError, match="dtype"):
        kernels.step_batch(*(a[k] for k in ORDER), finl.double(), finu)
    with pytest.raises(ValueError, match="shape"):
        kernels.step_batch(*(a[k] for k in ORDER), finl[:-1], finu)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.step_batch(*(a[k] for k in ORDER[:-1]),
                           torch.zeros((3, 40), dtype=torch.float64,
                                       device=dev).t(), finl, finu)


# -- the rest of the batched step, K10-K13 (float64) --------------------------
def _iterate(dev, B, n=400, m=150, seed=13):
    """A seeded batched iterate over a random A: bounds finite below only,
    above only, both and neither, XL / XU infinite where the bound is, two
    lanes done, and the K5 products A X[:n] and A' Y."""
    A, rng = _matrix(m, n, 0.02, seed)
    nm = n + m
    finl = rng.random(nm) < 0.7
    finu = rng.random(nm) < 0.4
    lb = np.where(finl, rng.uniform(-2.0, 0.0, nm), -np.inf)
    ub = np.where(finu, rng.uniform(0.5, 3.0, nm), np.inf)
    s = {"X": rng.standard_normal((nm, B)), "Y": rng.standard_normal((m, B)),
         "bT": rng.standard_normal((m, B)), "cT": rng.standard_normal((nm, B))}
    for name, fin in (("XL", finl), ("XU", finu), ("ZL", finl),
                      ("ZU", finu)):
        x = 10.0 ** rng.uniform(-4, 1, (nm, B))
        x[~fin] = np.inf if name.startswith("X") else 0.0
        s[name] = x
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa
    s = {k: t(v) for k, v in s.items()}
    done = np.zeros(B, dtype=bool)
    done[1::3] = True
    s.update(done=t(done), lb=t(lb), ub=t(ub), finl=t(finl), finu=t(finu))
    nmd = spmv.NormalMatrixDevice(A, dev)
    s["AX"] = kernels.csr_spmm(nmd.op_A, s["X"][:n])
    s["ATY"] = kernels.csr_spmm(nmd.op_At, s["Y"])
    return s, nmd, int(finl.sum() + finu.sum())


PRO_IN = ("AX", "ATY", "X", "XL", "XU", "Y", "ZL", "ZU", "done", "bT", "cT",
          "lb", "ub", "finl", "finu")


def _abs_sums(s, num_fin):
    """Per lane, the sums of the absolute terms of pobj, dobj and mu: the
    scale of their rounding."""
    fl, fu = s["finl"][:, None], s["finu"][:, None]
    z = torch.zeros_like(s["X"])
    t_l = torch.where(fl, s["lb"][:, None] * s["ZL"], z).abs().sum(0)
    t_u = torch.where(fu, s["ub"][:, None] * s["ZU"], z).abs().sum(0)
    c_l = torch.where(fl, s["XL"] * s["ZL"], z).abs().sum(0)
    c_u = torch.where(fu, s["XU"] * s["ZU"], z).abs().sum(0)
    return dict(pobj=(s["cT"] * s["X"]).abs().sum(0),
                dobj=(s["bT"] * s["Y"]).abs().sum(0) + t_l + t_u,
                mu=(c_l + c_u) / num_fin)


@pytest.mark.parametrize("B", [5, 40])
def test_ipm_prologue(dev, B):
    """K10 against its plain version: the residuals bit for bit; W and
    resscale bit for bit from the kernel's own regval; pres and dres exact;
    pobj, dobj and mu within 1e-13 of the sums of their terms' absolute
    values; done equal on the lanes whose gap is not within 1e-12 of the
    limit; and two runs bit for bit."""
    s, nmd, num_fin = _iterate(dev, B)
    n = nmd.n
    args = [s[k] for k in PRO_IN]
    probe = batch.ipm_prologue_plain(*args, 1e30, 1e30, 0.0, 0.3, num_fin)
    gaps = np.sort(probe.gap.cpu().numpy())
    opt_tol = float(np.sqrt(gaps[B // 2 - 1] * gaps[B // 2]))
    tests = (1e30, 1e30, opt_tol, 0.3, num_fin)
    before = kernels.LAUNCHES["ipm_prologue"]
    got = batch.ipm_prologue(*args, *tests)
    again = batch.ipm_prologue(*args, *tests)
    assert kernels.LAUNCHES["ipm_prologue"] == before + 2
    want = batch.ipm_prologue_plain(*args, *tests)
    for k in ("RB", "RC", "RL", "RU", "pres", "dres"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    fl, fu = s["finl"][:, None], s["finu"][:, None]
    G = torch.where(fl, s["ZL"] / s["XL"], 0.0) \
        + torch.where(fu, s["ZU"] / s["XU"], 0.0)
    W, rs = batch.kkt_weights_plain(G, got.regval, n)
    assert torch.equal(got.W, W) and torch.equal(got.resscale, rs)
    scale = _abs_sums(s, num_fin)
    for k in ("pobj", "dobj", "mu"):
        err = (getattr(got, k) - getattr(want, k)).abs()
        assert torch.all(err <= 1e-13 * scale[k]), k
    by_min = want.regval < want.mu     # regval is min G there: exact
    assert torch.equal(got.regval[by_min], want.regval[by_min])
    clear = (want.gap - opt_tol).abs() > 1e-12 * opt_tol
    assert torch.equal(got.done[clear], want.done[clear])
    assert bool(got.done.any()) and not bool(got.done.all())
    for k, v in got._asdict().items():
        assert torch.equal(v, getattr(again, k)), k
    mu = batch.lane_mu(s["XL"], s["XU"], s["ZL"], s["ZU"], s["finl"],
                       s["finu"], num_fin)
    assert torch.all((mu - want.mu).abs() <= 1e-13 * scale["mu"])


@pytest.mark.parametrize("corrector", [False, True])
def test_newton_rhs_and_recover(dev, monkeypatch, corrector):
    """K11 and K12 against their plain versions, bit for bit: the plain
    versions take the kernel's K5 products (K5 sums each row in another
    order than the plain product), so every output must be equal."""
    B = 6
    s, nmd, num_fin = _iterate(dev, B, seed=14)
    P = batch.ipm_prologue(*(s[k] for k in PRO_IN), 1e-6, 1e-6, 1e-8, 0.3,
                           num_fin)
    rng = np.random.default_rng(15)
    t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    nm = nmd.n + nmd.m
    corr = ()
    if corrector:
        corr = (t(rng.uniform(0.0, 1.0, B)), P.mu) + tuple(
            t(rng.standard_normal((nm, B))) for _ in range(4))
    rhs_in = (nmd.op_A, P.RC, P.RL, P.RU, s["XL"], s["XU"], s["ZL"], s["ZU"],
              P.W, P.RB, s["finl"], s["finu"], *corr)
    monkeypatch.setattr(spmv, "csr_spmm_plain", kernels.csr_spmm)
    before = dict(kernels.LAUNCHES)
    got = batch.newton_rhs(*rhs_in)
    want = batch.newton_rhs_plain(*rhs_in)
    for k, a, b in zip(("SL", "SU", "RHS1", "rhs"), got, want):
        assert torch.equal(a, b), k
    SL, SU, RHS1, rhs = got
    DY = t(rng.standard_normal((nmd.m, B)))
    DY[:, 2] = 0.0
    ATDY = kernels.csr_spmm(nmd.op_At, DY)
    rec_in = (nmd.op_A, ATDY, DY, RHS1, P.W, P.RB, P.RC, P.RL, P.RU, SL, SU,
              s["XL"], s["XU"], s["ZL"], s["ZU"], s["finl"], s["finu"])
    got = batch.newton_recover(*rec_in)
    want = batch.newton_recover_plain(*rec_in)
    for k, a, b in zip(("DX", "DXL", "DXU", "DYn", "DZL", "DZU"), got, want):
        assert torch.equal(a, b), k
    assert kernels.LAUNCHES["newton_rhs"] == before["newton_rhs"] + 1
    assert kernels.LAUNCHES["newton_recover"] == before["newton_recover"] + 1


def test_starting_point(dev):
    """K13 against its plain version: fed the kernel's per-lane scalars, the
    plain passes give every output bit for bit; xshift and zshift (maxima)
    are exact and xsum, zsum and mu agree to 1e-13 relative."""
    B = 7
    s, nmd, _ = _iterate(dev, B, seed=16)
    rng = np.random.default_rng(17)
    n, m = nmd.n, nmd.m
    t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    X0 = torch.clamp(torch.zeros_like(s["X"]), s["lb"][:, None],
                     s["ub"][:, None])
    DY, Y = t(rng.standard_normal((m, B))), t(rng.standard_normal((m, B)))
    ATY = kernels.csr_spmm(nmd.op_At, Y)
    cT = s["cT"].clone()
    # a lane whose dual residual Z = c - AI'Y is small against c: the fix-up
    cT[:, 3] = torch.cat([ATY, Y])[:, 3] + 1e-3 * cT[:, 3]
    args = (X0, kernels.csr_spmm(nmd.op_At, DY), DY, ATY, Y, cT, s["lb"],
            s["ub"], s["finl"], s["finu"])
    before = kernels.LAUNCHES["starting_point"]
    *got, lane = kernels.starting_point(*args, batch.RHO)
    assert kernels.LAUNCHES["starting_point"] == before + 1
    for k, a, b in zip(("X", "XL", "XU", "Y", "ZL", "ZU"), got,
                       batch.starting_point_plain(*args, lane=lane)):
        assert torch.equal(a, b), k
    L = dict(zip(kernels.START_ROWS, lane))
    fl, fu = s["finl"][:, None], s["finu"][:, None]
    X = args[0] + torch.cat([args[1], DY])
    XL, XU = X - s["lb"][:, None], s["ub"][:, None] - X
    xinf = torch.maximum(torch.where(fl, -XL, 0.0).amax(0),
                         torch.where(fu, -XU, 0.0).amax(0))
    assert torch.equal(L["xshift"], 1.0 + 1.5 * xinf.clamp(min=0.0))
    # without the kernel's scalars: the sums' rounding only
    for a, b in zip(got, batch.starting_point_plain(*args)):
        fin = torch.isfinite(b)
        assert torch.equal(fin, torch.isfinite(a))
        assert _rel(a[fin], b[fin]) <= 1e-12
    assert bool((L["fixup"] != 0).any())
    assert bool(L["fixup"][3] != 0)


def _start_inputs(dev, n, m, B, seed):
    """Seeded inputs of K13 with bounds finite below only, above only, both
    and neither, and a lane whose dual residual is small (the fix-up)."""
    rng = np.random.default_rng(seed)
    nm = n + m
    finl = rng.random(nm) < 0.7
    finu = rng.random(nm) < 0.4
    lb = np.where(finl, rng.uniform(-2.0, 0.0, nm), -np.inf)
    ub = np.where(finu, rng.uniform(0.5, 3.0, nm), np.inf)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa
    g = lambda *s: t(rng.standard_normal(s))  # noqa: E731
    X0 = torch.clamp(torch.zeros((nm, B), dtype=torch.float64, device=dev),
                     t(lb)[:, None], t(ub)[:, None])
    ATY, Y = g(n, B), g(m, B)
    cT = g(nm, B)
    cT[:, min(3, B - 1)] = torch.cat([ATY, Y])[:, min(3, B - 1)] \
        + 1e-3 * cT[:, min(3, B - 1)]
    return (X0, g(n, B), g(m, B), ATY, Y, cT, t(lb), t(ub), t(finl),
            t(finu))


@pytest.mark.parametrize("n, m, B", [(40000, 10000, 256), (3000, 1000, 7),
                                     (3000, 1000, 6), (30, 20, 1)])
def test_starting_point_one_launch_matches_seven(dev, n, m, B):
    """K13's one cooperative launch against the seven launches of its
    earlier form: X, XL, XU, Y, ZL, ZU and the lane scalars bit for bit, at
    n + m = 50 000 and B = 256 (4096 virtual blocks, several a block of the
    grid), at B = 7 (a lane a thread), B = 6 (two lanes a thread in blocks
    of 126 threads) and B = 1."""
    args = _start_inputs(dev, n, m, B, seed=n + B)
    before = kernels.LAUNCHES["starting_point"]
    one = kernels.starting_point(*args, batch.RHO)
    seven = kernels.starting_point(*args, batch.RHO, cooperative=False)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["starting_point"] == before + 2
    for k, a, b in zip(("X", "XL", "XU", "Y", "ZL", "ZU", "lane"), one,
                       seven):
        assert torch.equal(a, b), k
    assert bool((one[-1][1] != 0).any())   # a fix-up lane
    for k, a, b in zip(("X", "XL", "XU", "Y", "ZL", "ZU"), one[:-1],
                       batch.starting_point_plain(*args, lane=one[-1])):
        assert torch.equal(a, b), k


# -- the shared-basis polish (parallel/batch2.py) -----------------------------
def _polish_setup(B=4):
    """test_batch2.py's pipeline LP: a loose batched phase 1 on the CPU and
    the factorized mean-scenario basis."""
    from ipx_tpu_torch import LpSolver, Parameters
    from ipx_tpu_torch import testgen as tg
    data = tg.transportation(50, 100, 0.06, seed=12)
    m = data["num_constr"]
    rng = np.random.default_rng(6)
    b = data["rhs"][None, :] * rng.uniform(0.98, 1.05, size=(B, m))
    blp = batch.BatchedScenarioSolver(data, b).blp
    state = batch.BatchedPhase1Solver(
        blp, feasibility_tol=1e-3, optimality_tol=1e-3, maxiter=60,
        device="cpu").solve()
    s = LpSolver(Parameters(display=0, device="cpu", scale=0, dualize=0,
                            crossover=0))
    assert tg.load_into_solver(dict(data, rhs=b.mean(axis=0)), s) == 0
    assert s.solve() == 1000
    if not s.basis.factorization_is_fresh:
        assert s.basis.factorize() == 0
    return data, blp, state, s


def test_polish_kernels_against_plain(dev):
    """Three polish steps on the card through the kernels and through the
    plain versions (PlainBatchedPhase1Solver) on the card, the plain run
    taking the kernel run's shared-basis CR solutions (the CR is the same
    host code in both; on its own, rounding moves its last trip and
    maxvolume's exchanges): the first step's per-lane mu agrees to 1e-8
    of the lane's mu before it (a lane that converges in the step cancels
    most of its complementarity, so the rounding is measured against the
    terms it came from), mu is finite and falls on every lane in the first
    step, and
    K10-K12 were launched by the kernels' run only. Later steps are not
    compared: once the weights spread, a replayed solution no longer fits
    the other run's right-hand side to its rounding."""
    from ipx_tpu_torch.parallel import batch2
    _, blp, state, s = _polish_setup()
    solutions, mus = [], {}
    for name, cls in (("kernels", batch.BatchedPhase1Solver),
                      ("plain", batch.PlainBatchedPhase1Solver)):
        pol = batch2.SharedBasisBatchedPolish(
            blp, s.basis, feasibility_tol=1e-8, optimality_tol=1e-8,
            maxiter=3, device="cuda", solver_cls=cls)
        if name == "kernels":
            def record(*a, cr_solve=pol._ph1._cr_solve):
                Y, iters = cr_solve(*a)
                solutions.append((Y.clone(), iters))
                return Y, iters
            pol._ph1._cr_solve = record
        else:
            replay = iter(solutions)
            pol._ph1._cr_solve = lambda *a: next(replay)
        kernels.reset_launches()
        out = pol.run(state)
        torch.cuda.synchronize()
        launched = dict(kernels.LAUNCHES)
        mus[name] = np.array(pol.mu_history)
        assert np.all(np.isfinite(mus[name])), name
        assert np.all(mus[name][1] < mus[name][0]), name
        assert np.all(out["mu"] < mus[name][0]), name
        assert pol.correction_failures == pol.refresh_failures == 0
        for k in ("ipm_prologue", "newton_rhs", "newton_recover"):
            assert (launched[k] > 0) == (name == "kernels"), (name, k)
    assert mus["kernels"].shape == mus["plain"].shape
    assert np.all(np.abs(mus["kernels"][1] - mus["plain"][1])
                  <= 1e-8 * mus["plain"][0])


def test_scenario_solver_polish_on_the_card(dev):
    """BatchedScenarioSolver(phase2_polish=True) on device="cuda": every
    scenario at status 1000 with the host solve's objective to 1e-8."""
    from ipx_tpu_torch import LpSolver, Parameters
    from ipx_tpu_torch import testgen as tg
    data = tg.transportation(40, 80, 0.08, seed=2)
    m = data["num_constr"]
    rng = np.random.default_rng(7)
    b = data["rhs"][None, :] * rng.uniform(0.98, 1.04, size=(3, m))
    sv = batch.BatchedScenarioSolver(
        data, b, parameters=Parameters(display=0, device="cuda"),
        phase2_polish=True)
    kernels.reset_launches()
    res = sv.solve()
    assert sv.polish is not None and sv.polish.device.type == "cuda"
    assert kernels.LAUNCHES["ipm_prologue"] > 0
    for k, (st, info, _) in enumerate(res):
        host = LpSolver(Parameters(display=0, device="cpu"))
        assert tg.load_into_solver(dict(data, rhs=b[k]), host) == 0
        assert host.solve() == 1000 and st == 1000, k
        want = host.get_info().objval
        assert abs(info.objval - want) <= 1e-8 * max(1.0, abs(want)), k


# -- the sharded solves (parallel/sharding.py): K14-K16 -----------------------
def _sharded_inputs(dev, m, n, seed, B=None, P=4):
    """A row-blocked operator on the card and seeded float64 inputs, as
    tests/test_sharded.py makes them."""
    from ipx_tpu_torch.parallel import sharding
    A, rng = _matrix(m, n, 0.05, seed)
    shape = (n + m,) if B is None else (n + m, B)
    W = rng.uniform(0.5, 2.0, size=shape)
    A2 = A.copy()
    A2.data **= 2
    diag = np.asarray(A2 @ W[:n]) + W[n:]
    rhs = rng.standard_normal((m,) + shape[1:])
    t = lambda x: torch.from_numpy(np.asarray(x, dtype=np.float64)).to(dev)
    snm = sharding.ShardedNormalMatrix(A, P, dev)
    return (A, snm, t(W[:n]), t(W[n:]), t(1.0 / diag),
            t(1.0 / np.sqrt(W[n:])), t(rhs))


@pytest.mark.parametrize("P", [1, 3, 4])
def test_block_sum_bit_for_bit(dev, P):
    """K14 equals the plain ordered sum bit for bit, scaled or not, and
    counts its launches."""
    from ipx_tpu_torch.parallel import sharding
    rng = np.random.default_rng(P)
    parts = torch.from_numpy(rng.standard_normal((P, 1001, 3))).to(dev)
    scale = torch.from_numpy(rng.standard_normal((1001, 3))).to(dev)
    before = kernels.LAUNCHES["block_sum"]
    for s in (scale, None):
        got = sharding.block_sum(parts, s)
        assert torch.equal(got, sharding.block_sum_plain(parts, s))
    assert kernels.LAUNCHES["block_sum"] == before + 2


@pytest.mark.parametrize("m, B", [(613, None), (613, 5), (5, None), (5, 4)])
def test_block_normal_apply_on_card(dev, m, B):
    """K14v and one K1 launch over the row blocks (vector); through K16's
    plan (batched), K5 per row block and K14 at m = 613, one fused launch
    at m = 5: 1e-12 of the plain version, a ragged last block and (m = 5
    over 4 blocks) an empty one; two launches for the vector apply, with no
    K14, and 2P + 1 or one for the batched one; bit for bit from run to
    run."""
    from ipx_tpu_torch.parallel import sharding
    _, snm, Ws, Wl, _, _, v = _sharded_inputs(dev, m, 300, seed=7, B=B)
    before = dict(kernels.LAUNCHES)
    got = sharding.block_normal_apply(snm, Ws, Wl, v)
    after = dict(kernels.LAUNCHES)
    want = sharding._block_apply_plain(
        snm, Ws, Wl, v, spmv.csr_spmm_plain if B else spmv.csr_spmv_plain)
    assert _rel(got, want) <= 1e-12
    assert torch.equal(got, sharding.block_normal_apply(snm, Ws, Wl, v))
    moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    if B is None:
        assert moved == {"block_spmv_sum": 1, "csr_spmv": 1}
    else:       # the fused form on m = 5 (columns of 1-2 entries)
        fused = kernels.block_plan_of(snm.op_At_split, snm.op_At,
                                      snm.op_A).fused
        assert fused is (m == 5)
        assert moved == ({"sharded_batched_cr_step": 1} if fused
                         else {"csr_spmm": 8, "block_sum": 1})


@pytest.mark.parametrize("P", [1, 3, 4])
def test_block_spmv_sum(dev, P):
    """K14v on the whole A' split at P row blocks: 1e-12 of its plain
    version, bit for bit from run to run, one launch, and a done CR state
    makes it return at once."""
    from ipx_tpu_torch.parallel import sharding
    A, snm, Ws, _, _, _, v = _sharded_inputs(dev, 613, 300, seed=13, P=P)
    op = snm.op_At_split
    before = kernels.LAUNCHES["block_spmv_sum"]
    u = spmv.split_spmv(op, v, Ws)
    assert kernels.LAUNCHES["block_spmv_sum"] == before + 1
    assert torch.equal(u, spmv.split_spmv(op, v, Ws))
    assert _rel(u, spmv.split_spmv_plain(op, v, Ws)) <= 1e-12
    parts = torch.stack([spmv.csr_spmv_plain(o, v[r0:r1]) for o, (r0, r1)
                         in zip(snm.op_At, snm.bounds)])
    assert _rel(u, sharding.block_sum_plain(parts, Ws)) <= 1e-12
    state = torch.zeros(int(kernels.load().ipxt_cr_state_len()),
                        dtype=torch.float64, device=dev)
    state[5] = 1.0                              # the done flag
    out = torch.full_like(u, 7.0)
    kernels.block_spmv_sum(op, v, Ws, out=out, state=state)
    assert bool((out == 7.0).all())


@pytest.mark.parametrize("ladder", [True, False])
def test_sharded_cr_per_trip_and_converged(dev, ladder):
    """K15 against its plain version on the card: after each of trips 1-5
    the iterate within 1e-12, the same trip count and error code; solved to
    1e-10, the same stop within 2 trips; two runs agree bit for bit."""
    from ipx_tpu_torch.parallel import sharding
    _, snm, Ws, Wl, invd, rs, rhs = _sharded_inputs(dev, 613, 900, seed=8)
    rs = rs if ladder else None
    before = kernels.LAUNCHES["sharded_cr_step"]
    for trips in range(1, 6):
        y, it, err, _ = sharding.sharded_cr(snm, Ws, Wl, invd, rs, rhs,
                                            1e-14, trips, ladder)
        y_p, it_p, err_p, _ = sharding.sharded_cr_plain(
            snm, Ws, Wl, invd, rs, rhs, 1e-14, trips, ladder)
        assert it == it_p == trips and err == err_p == 0
        assert _rel(y, y_p) <= 1e-12, trips
    assert kernels.LAUNCHES["sharded_cr_step"] > before
    y, it, err, res = sharding.sharded_cr(snm, Ws, Wl, invd, rs, rhs, 1e-10,
                                          2000, ladder)
    y2, _, _, _ = sharding.sharded_cr(snm, Ws, Wl, invd, rs, rhs, 1e-10,
                                      2000, ladder)
    _, it_p, err_p, _ = sharding.sharded_cr_plain(snm, Ws, Wl, invd, rs, rhs,
                                                  1e-10, 2000, ladder)
    assert err == err_p == 0 and abs(it - it_p) <= 2 and res <= 1e-10
    assert torch.equal(y, y2)


@pytest.mark.parametrize("case, errflag", [("negative_weight", 203),
                                           ("nan_rhs", 0)])
def test_sharded_cr_ladder_on_card(dev, case, errflag):
    """K15's ladder: negative weights stop the first trip with 203 and y
    unchanged; a NaN residual stops the loop before it (the post-check of
    ShardedDiagCR then gives 205), as the plain version does."""
    from ipx_tpu_torch.parallel import sharding
    _, snm, Ws, Wl, invd, rs, rhs = _sharded_inputs(dev, 613, 900, seed=9)
    if case == "negative_weight":
        Ws, Wl, invd = -Ws, -Wl, -invd
    else:
        rhs[7] = float("nan")
    got = sharding.sharded_cr(snm, Ws, Wl, invd, rs, rhs, 1e-10, 100)
    want = sharding.sharded_cr_plain(snm, Ws, Wl, invd, rs, rhs, 1e-10, 100)
    assert got[1:3] == want[1:3] == ((1, errflag) if errflag else (0, 0))
    assert torch.equal(got[0], want[0])


# K15's cooperative launch against its host-issued passes: (P, m, n) of
# the operator, one with an empty last row block ([3, 3, 3, 0])
SCR_CONFIGS = {"P1": (1, 613, 900), "P2": (2, 613, 900), "P4": (4, 613, 900),
               "P4-empty": (4, 9, 30)}


def _scr_coop_config(config):
    """Runs K15 in both forms on the cases of one operator and asserts them
    equal bit for bit: y, iterations, error code and residual norm; each
    ladder case is the plain version's too. Trips 1-5 and a converged
    solve with and without the ladder, the ladder's 202 (negative weights,
    positive preconditioner), 203 (both negative) and 205 (a right-hand
    side whose dots overflow), and a NaN in the right-hand side (the loop
    stops before the first trip). Also K15's counts: one launch a solve,
    the applies it ran (1 + trips) inside it as one K14v and one K1 each,
    no K14v or K1 launch, the same on a second read. Run in a subprocess by
    the test below, so that a grid that deadlocks fails on its time
    limit."""
    from ipx_tpu_torch import backend
    from ipx_tpu_torch.parallel import sharding
    dev = backend.cuda_device()
    P, m, n = SCR_CONFIGS[config]
    base = _sharded_inputs(dev, m, n, seed=20 + P, P=P)
    _, snm, Ws0, Wl0, invd0, rs0, rhs0 = base
    if config == "P4-empty":
        assert snm.rows[-1] == 0, snm.rows
    cases = [(f"trips{k}", k) for k in range(1, 6)] + [
        ("converged", None), ("202", 202), ("203", 203), ("205", 205),
        ("nan", "nan")]
    for ladder in (True, False):
        for name, case in cases:
            Ws, Wl, invd, rs, rhs = Ws0, Wl0, invd0, rs0, rhs0.clone()
            tol, maxiter = 1e-10, 2000
            if isinstance(case, int) and case < 10:
                tol, maxiter = 0.0, case
            elif case == 202:
                Ws, Wl = -Ws, -Wl
            elif case == 203:
                Ws, Wl, invd = -Ws, -Wl, -invd
            elif case == 205:
                rhs = rhs * 1e160
            elif case == "nan":
                rhs[m // 2] = float("nan")
            r = rs if ladder else None

            def form(cooperative):
                return kernels.ShardedCrStep(
                    snm.op_At_split, snm.op_A, Ws, Wl, invd, r, rhs,
                    ladder).solve(maxiter, tol, cooperative)
            kernels.reset_launches()
            y, it, err, res = form(True)
            launched = {k: v for k, v in kernels.LAUNCHES.items() if v}
            inside = dict(kernels.INSIDE)
            assert launched == {"sharded_cr_step": 1}, (name, launched)
            assert inside["block_spmv_sum"] == inside["csr_spmv"] == 1 + it
            y_h, it_h, err_h, res_h = form(False)
            torch.cuda.synchronize()
            assert (it, err) == (it_h, err_h), (config, name, ladder,
                                                (it, err), (it_h, err_h))
            # bit for bit, NaN included (a solve that overflows)
            assert torch.equal(y.view(torch.int64), y_h.view(torch.int64)), (
                config, name, ladder)
            assert res == res_h or (np.isnan(res) and np.isnan(res_h))
            want = sharding.sharded_cr_plain(snm, Ws, Wl, invd, r, rhs, tol,
                                             maxiter, ladder)
            if name.startswith("trips"):
                assert it == case and err == 0, (name, it, err)
                assert _rel(y, want[0]) <= 1e-12, (config, name)
            elif name == "converged":
                assert err == 0 and res <= tol and abs(it - want[1]) <= 2
            elif name == "nan":
                assert (it, err) == (0, 0) and np.isnan(res)
                assert not bool(y.any())
            elif ladder:    # the trip stops with y unchanged
                assert (it, err) == want[1:3] == (1, case), (name, it, err)
                assert not bool(y.any())
            print(config, name, ladder, it, err)


@pytest.mark.parametrize("config", list(SCR_CONFIGS))
def test_sharded_cr_cooperative_matches_host_issued(dev, config):
    """K15's cooperative launch against its host-issued passes, bit for
    bit in every stop case, at P = 1, 2 and 4 and with an empty row block,
    in a subprocess with a time limit."""
    import os
    import subprocess
    import sys
    here = os.path.dirname(os.path.abspath(__file__))
    code = (f"import sys; sys.path.insert(0, {here!r}); "
            f"import test_torch_cuda as t; t._scr_coop_config({config!r})")
    out = subprocess.run([sys.executable, "-c", code],
                         cwd=os.path.dirname(here), capture_output=True,
                         text=True, timeout=180)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]


def _pairs(m, n, seed):
    """A CSC matrix of m rows whose n columns hold 2 nonzeros each (random
    values), the pattern of the transportation LPs, on which K16's plan
    takes the fused apply."""
    rng = np.random.default_rng(seed)
    rows = np.sort(np.stack([rng.choice(m, 2, replace=False)
                             for _ in range(n)]), axis=1)
    return sp.csc_matrix((rng.uniform(0.5, 1.5, 2 * n), rows.ravel(),
                          np.arange(0, 2 * n + 1, 2)), shape=(m, n))


# (P, matrix): the pattern of the fused form (2 a column, an empty last
# block at P = 4 and m = 9) and of the three-stage one (random columns of
# about 30)
K16_OPERATORS = {
    "pairs-P1": (1, lambda: _pairs(200, 500, 1)),
    "pairs-P2": (2, lambda: _pairs(200, 500, 2)),
    "pairs-P4": (4, lambda: _pairs(613, 900, 3)),
    "pairs-P4-empty": (4, lambda: _pairs(9, 30, 4)),
    "random-P4": (4, lambda: _matrix(613, 300, 0.05, 5)[0]),
}


@pytest.mark.parametrize("B", [1, 7, 256])
@pytest.mark.parametrize("name", list(K16_OPERATORS))
def test_block_normal_batched_fused_matches_three_stage(dev, name, B):
    """K16's fused apply against the three-stage form's 2P + 1 launches
    (K5 per block, K14, K5 per block): out and the partials bit for bit,
    on operators where the plan takes either form, at B = 1, 7 (no vector
    loads) and 256; 1e-12 of the plain version; the fused form one K16
    launch and no K5 or K14, the three-stage 2P + 1; with a done CR state
    neither form writes out."""
    from ipx_tpu_torch.parallel import sharding
    P, make = K16_OPERATORS[name]
    A = make()
    m, n = A.shape
    snm = sharding.ShardedNormalMatrix(A, P, dev)
    plan = kernels.block_plan_of(snm.op_At_split, snm.op_At, snm.op_A)
    assert plan.fused is name.startswith("pairs")
    if name.endswith("empty"):
        assert snm.rows[-1] == 0
    rng = np.random.default_rng(B)
    t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    Ws, Wl, V = t(rng.uniform(0.1, 3.0, (n, B))), t(
        rng.uniform(0.1, 3.0, (m, B))), t(rng.standard_normal((m, B)))
    vw = plan.width(Ws, Wl, V, V)
    rows = sum(plan.partials_rows(B, vw))
    outs, parts = {}, {}
    for fused in (True, False):
        out = torch.full((m, B), 7.0, dtype=torch.float64, device=dev)
        pc = torch.full((rows, B), 7.0, dtype=torch.float64, device=dev)
        kernels.reset_launches()
        plan(Ws, Wl, V, out=out, partials=pc, fused=fused)
        launched = {k: v for k, v in kernels.LAUNCHES.items() if v}
        assert launched == ({"sharded_batched_cr_step": 1} if fused else
                            {"csr_spmm": 2 * P, "block_sum": 1}), launched
        outs[fused], parts[fused] = out, pc
    torch.cuda.synchronize()
    assert torch.equal(outs[True], outs[False])
    assert torch.equal(parts[True], parts[False])
    want = sharding._block_apply_plain(snm, Ws, Wl, V, spmv.csr_spmm_plain)
    assert _rel(outs[True], want) <= 1e-12
    state = torch.zeros(int(kernels.load().ipxt_sbcr_state_len(B)),
                        dtype=torch.float64, device=dev)
    state[5] = 1.0                              # kDone
    for fused in (True, False):
        idle = torch.full((m, B), 7.0, dtype=torch.float64, device=dev)
        plan(Ws, Wl, V, out=idle, state=state, fused=fused)
        assert bool((idle == 7.0).all())


@pytest.mark.parametrize("name", ["pairs-P4", "pairs-P4-empty", "random-P4"])
def test_sharded_batched_cr_fused_matches_three_stage(dev, name):
    """K16's solve with the fused apply and with the three-stage one, bit
    for bit (Y and trips) at B = 5, converged; only the three-stage step
    allocates the parts and U; with the fused apply its K14 sums run
    inside, one an apply that did work (1 + trips)."""
    from ipx_tpu_torch.parallel import sharding
    P, make = K16_OPERATORS[name]
    A = make()
    m, n = A.shape
    snm = sharding.ShardedNormalMatrix(A, P, dev)
    rng = np.random.default_rng(6)
    W = rng.uniform(0.5, 2.0, (n + m, 5))
    A2 = A.copy()
    A2.data **= 2
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa
    args = (snm.op_At_split, snm.op_At, snm.op_A, t(W[:n]), t(W[n:]),
            t(1.0 / (A2 @ W[:n] + W[n:])), t(rng.standard_normal((m, 5))))
    got = {}
    for fused in (True, False):
        kernels.reset_launches()
        cr = kernels.ShardedBatchedCrStep(*args, fused=fused)
        assert (cr.U is None) is fused and (cr.parts is None) is fused
        got[fused] = cr.solve(2000, 1e-10)
        assert kernels.INSIDE["block_sum"] == (1 + got[fused][1]
                                               if fused else 0)
        assert (kernels.LAUNCHES["block_sum"] > 0) is not fused
    torch.cuda.synchronize()
    assert got[True][1] == got[False][1] > 0
    assert torch.equal(got[True][0], got[False][0])


def test_sharded_batched_cr_per_trip_and_converged(dev):
    """K16 against its plain version on the card, B = 5 with a lane that is
    done at once: after each of trips 1-5 Y within 1e-12 and the same trip
    count; solved to 1e-10, every lane's normal-equation residual within
    1e-9, the same stop within 2 trips, bit for bit from run to run."""
    from ipx_tpu_torch.parallel import sharding
    A, snm, Ws, Wl, invd, _, R = _sharded_inputs(dev, 613, 900, seed=10, B=5)
    R[:, 2] = 0.0
    before = kernels.LAUNCHES["sharded_batched_cr_step"]
    for trips in range(1, 6):
        Y, it = sharding.sharded_batched_cr(snm, Ws, Wl, invd, R, 1e-14,
                                            trips)
        Y_p, it_p = sharding.sharded_batched_cr_plain(snm, Ws, Wl, invd, R,
                                                      1e-14, trips)
        assert it == it_p == trips
        assert _rel(Y, Y_p) <= 1e-12, trips
        assert bool((Y[:, 2] == 0).all())
    assert kernels.LAUNCHES["sharded_batched_cr_step"] > before
    Y, it = sharding.sharded_batched_cr(snm, Ws, Wl, invd, R, 1e-10, 2000)
    Y2, _ = sharding.sharded_batched_cr(snm, Ws, Wl, invd, R, 1e-10, 2000)
    _, it_p = sharding.sharded_batched_cr_plain(snm, Ws, Wl, invd, R, 1e-10,
                                                2000)
    assert abs(it - it_p) <= 2 and torch.equal(Y, Y2)
    res = R - sharding._block_apply_plain(snm, Ws, Wl, Y,
                                          spmv.csr_spmm_plain)
    assert float(res.abs().max()) <= 1e-9 * max(1.0, float(R.abs().max()))


def test_sharded_nnt_on_card(dev):
    """The column-blocked N N' with its psum in one K4 launch per apply
    against the plain version: 1e-12, no K14."""
    from ipx_tpu_torch.parallel import sharding
    A, rng = _matrix(400, 1001, 0.02, seed=11)
    nnt = sharding.ShardedSplittedNNt(400, 1001, 4, dev)
    nnt.set_operand(A)
    w = rng.standard_normal(400)
    before = dict(kernels.LAUNCHES)
    got = nnt.apply(w)
    assert kernels.LAUNCHES["nnt"] == before["nnt"] + 1
    assert kernels.LAUNCHES["block_sum"] == before["block_sum"]
    want = sharding.block_nnt_plain(nnt.blocks, torch.from_numpy(w).to(dev))
    assert _rel(torch.from_numpy(got), want) <= 1e-12


def test_sharded_blocks_default_to_the_card(dev):
    """With no device given, ShardedDiagCR and ShardedSplittedNNt put their
    blocks on the card, and a ShardedDiagCR solve launches K15."""
    from ipx_tpu_torch.parallel import sharding
    A, rng = _matrix(613, 900, 0.05, seed=12)
    cr = sharding.ShardedDiagCR(A, 4)
    assert cr.device.type == "cuda" and cr.snm.device.type == "cuda"
    assert sharding.ShardedSplittedNNt(613, 900, 4).device.type == "cuda"
    W = rng.uniform(0.5, 2.0, 900 + 613)
    A2 = A.copy()
    A2.data **= 2
    before = kernels.LAUNCHES["sharded_cr_step"]
    _, it, err = cr.solve(W[:900], W[900:], A2 @ W[:900] + W[900:],
                          1.0 / np.sqrt(W[900:]), rng.standard_normal(613),
                          1e-10, 2000)
    assert err == 0 and it > 0
    assert kernels.LAUNCHES["sharded_cr_step"] > before


@pytest.mark.parametrize("device", ["cuda", "auto"])
def test_sharded_lp_solve_on_card(dev, device):
    """LpSolver(shards=4) with device "cuda" and "auto" (row-blocked
    phase 1 and column-blocked N N' in phase 2, both on the card): status
    1000, the host solve's objective to 1e-8, K15 launched once a sharded
    CR solve with its applies inside (K14v and K1 launched no time, their
    applies inside K15 equal, 1 + trips a solve), K4 launched and K14 not
    (the vector paths have no standalone psum)."""
    from ipx_tpu_torch import LpSolver, Parameters
    from ipx_tpu_torch import testgen as tg
    data = tg.transportation(60, 90, 0.05, seed=3)
    host = LpSolver(Parameters(display=0, device="cpu"))
    assert tg.load_into_solver(data, host) == 0 and host.solve() == 1000
    s = LpSolver(Parameters(display=0, device=device, shards=4))
    assert tg.load_into_solver(data, s) == 0
    kernels.reset_launches()
    assert s.solve() == 1000
    want = host.get_info().objval
    assert abs(s.get_info().objval - want) <= 1e-8 * abs(want)
    cr = s.model._sharded_cr[1]
    assert kernels.LAUNCHES["block_spmv_sum"] == 0
    assert kernels.LAUNCHES["csr_spmv"] == 0
    assert kernels.LAUNCHES["block_sum"] == 0
    assert kernels.LAUNCHES["sharded_cr_step"] == cr.solves > 0
    assert (kernels.INSIDE["block_spmv_sum"] == kernels.INSIDE["csr_spmv"]
            == cr.solves + cr.iterations)
    assert kernels.LAUNCHES["nnt"] > 0
    assert cr.device.type == "cuda"
    nnt = s.model._sharded_nnt[1]
    assert nnt.applies > 0 and nnt.device.type == "cuda"


def test_f64_precision_solve_on_card(dev):
    """Parameters(precision="f64") on "cuda" runs phase 1 through the f64
    device CR: the 20k transportation LP at status 1000 with the host
    path's objective to 1e-8."""
    from ipx_tpu_torch import LpSolver, Parameters
    from ipx_tpu_torch import testgen as tg
    data = tg.transportation(8000, 12000, 0.001, seed=1)
    host = LpSolver(Parameters(display=0, device="cpu"))
    assert tg.load_into_solver(data, host) == 0 and host.solve() == 1000
    calls = []
    orig = device_cr.DeviceNormalCR.solve
    s = LpSolver(Parameters(display=0, device="cuda", precision="f64"))
    assert tg.load_into_solver(data, s) == 0
    device_cr.DeviceNormalCR.solve = lambda self, *a: (calls.append(1),
                                                       orig(self, *a))[1]
    try:
        assert s.solve() == 1000
    finally:
        device_cr.DeviceNormalCR.solve = orig
    want = host.get_info().objval
    assert abs(s.get_info().objval - want) <= 1e-8 * abs(want)
    assert calls


# -- K17 and the entry points --------------------------------------------------
def _triangular(lower):
    """A factor of splu of a 1500 x 1500 matrix with one dense row and one
    dense column (rows of the factor longer than a warp), with one stored
    entry set to an explicit zero."""
    import scipy.sparse.linalg as spla
    rng = np.random.default_rng(17)
    A = sp.random(1500, 1500, density=0.002, random_state=rng,
                  format="lil") + sp.diags(rng.uniform(1.0, 2.0, 1500))
    A = sp.lil_matrix(A)
    A[1499, ::7] = rng.uniform(0.1, 0.2, len(range(0, 1500, 7)))
    A[::7, 0] = rng.uniform(0.1, 0.2, (len(range(0, 1500, 7)), 1))
    lu = spla.splu(sp.csc_matrix(A), permc_spec="COLAMD")
    T = (lu.L if lower else lu.U).tocsr()
    off = np.flatnonzero(np.repeat(np.arange(1500), np.diff(T.indptr))
                         != T.indices)
    T.data[off[len(off) // 2]] = 0.0
    assert np.diff(T.indptr).max() > 32
    return T


@pytest.mark.parametrize("B", [1, 3, 256, 300])
@pytest.mark.parametrize("lower", [True, False], ids=["L", "U"])
def test_level_solve(dev, lower, B):
    """K17 against its plain version on the card and spsolve_triangular,
    1e-12 relative; one launch a sweep; two runs equal bit for bit."""
    import scipy.sparse.linalg as spla
    from ipx_tpu_torch.ops import trisolve
    T = _triangular(lower)
    sched = trisolve.level_schedule(T, lower, dev)
    V = torch.from_numpy(np.random.default_rng(B).standard_normal(
        (T.shape[0], B))).to(dev)
    before = kernels.LAUNCHES["level_solve"]
    X = trisolve.level_solve(sched, V)
    X2 = trisolve.level_solve(sched, V)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["level_solve"] == before + 2
    assert torch.equal(X, X2)
    assert _rel(X, trisolve.level_solve_plain(sched, V)) <= 1e-12
    want = spla.spsolve_triangular(T, V.cpu().numpy(), lower=lower)
    assert _rel(X, torch.from_numpy(want)) <= 1e-12


# lanes of a tile of the sweep held against the per-level form: the
# rule's, and 1, 4 and 32 lanes a tile
SWEEP_LANES = [None, 1, 4, 32]


@pytest.mark.parametrize("lanes", SWEEP_LANES,
                         ids=lambda t: "rule" if t is None else f"{t}lanes")
@pytest.mark.parametrize("B", [1, 3, 256, 300, 1024])
@pytest.mark.parametrize("lower", [True, False], ids=["L", "U"])
def test_level_sweep_matches_per_level(dev, lower, B, lanes):
    """K17's sweep in one launch equals its per-level form bit for bit (the
    same roundings in the same order a row, warp tree at B = 1 included),
    whatever its tiles, on a factor with rows longer than a warp and an
    explicit zero; LAUNCHES counts 1 a sweep against nlev."""
    from ipx_tpu_torch.ops import trisolve
    T = _triangular(lower)
    sched = trisolve.level_schedule(T, lower, dev)
    V = torch.from_numpy(np.random.default_rng(B + 5).standard_normal(
        (T.shape[0], B))).to(dev)
    before = kernels.LAUNCHES["level_solve"]
    X = kernels.level_solve(sched, V, lanes=lanes)
    assert kernels.LAUNCHES["level_solve"] == before + 1
    X_l = kernels.level_solve(sched, V, per_level=True)
    assert kernels.LAUNCHES["level_solve"] == before + 1 + sched.nlev
    torch.cuda.synchronize()
    assert torch.equal(X, X_l)
    assert _rel(X, trisolve.level_solve_plain(sched, V)) <= 1e-12


def test_level_sweep_x_in_global_memory(dev):
    """At B = 1 a schedule of more rows than shared memory holds as
    doubles keeps X in global memory: still equal to the per-level form."""
    from ipx_tpu_torch.ops import trisolve
    m = 40000
    rng = np.random.default_rng(40)
    i = np.repeat(np.arange(1, m), 2)             # two entries a row ...
    j = (rng.random(len(i)) * i).astype(np.int64)  # ... left of the diagonal
    T = sp.csr_matrix((0.1 * rng.standard_normal(len(i)), (i, j)),
                      shape=(m, m)) + sp.diags(rng.uniform(1.0, 2.0, m))
    T = sp.csr_matrix(T)
    sched = trisolve.level_schedule(T, True, dev)
    assert sched.nlev > 2
    V = torch.from_numpy(rng.standard_normal((m, 1))).to(dev)
    X = kernels.level_solve(sched, V)
    X_l = kernels.level_solve(sched, V, per_level=True)
    torch.cuda.synchronize()
    assert torch.equal(X, X_l)
    assert _rel(X, trisolve.level_solve_plain(sched, V)) <= 1e-12


@pytest.mark.parametrize("dtype", DTYPES)
def test_normal_apply_one_launch_matches_three(dev, dtype):
    """The stand-alone K2 in one cooperative launch, its two halves with a
    grid barrier after each and the sum of the partials inside, equals the
    three launches bit for bit, out, the partials and the dot; and out and
    the partials equal the two K1 launches without the dot. One apply
    counted each time."""
    A, rng = _matrix(700, 1500, 0.01, seed=12)
    m, n = A.shape
    nmd = spmv.NormalMatrixDevice(A, dev, dtype)
    W = torch.from_numpy(rng.uniform(0.1, 3.0, n + m)).to(dtype).to(dev)
    v = torch.from_numpy(rng.standard_normal(m)).to(dtype).to(dev)
    nblk = kernels.plan_of(nmd.op_A, nmd.op_A.vec).nblk
    got = {}
    before = kernels.LAUNCHES["normal_apply"]
    for form in ("one", "three", "two"):
        pc = torch.full((nblk,), 7.0, dtype=dtype, device=dev)
        dot = None if form == "two" else torch.zeros(1, dtype=dtype,
                                                     device=dev)
        out = kernels.normal_apply(nmd.op_At, nmd.op_A, W, v, partials=pc,
                                   dot=dot, one_launch=form == "one")
        got[form] = (out, pc, dot)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["normal_apply"] == before + 3
    (o1, p1, d1), (o3, p3, d3), (o2, p2, _) = (got[k] for k in
                                               ("one", "three", "two"))
    assert torch.equal(o1, o3) and torch.equal(p1, p3) and torch.equal(d1, d3)
    assert torch.equal(o1, o2) and torch.equal(p1, p2)
    want, want_dot = spmv.normal_apply_plain(nmd, W, v)
    assert _rel(o1, want) <= RTOL[dtype]
    assert abs(float(d1) - float(want_dot)) <= RTOL[dtype] * abs(
        float(want_dot))


def test_entry_step_on_the_card(dev):
    """entry() with its default device: the state on the card, one step
    through K5-K13, finite, with mu down on every lane."""
    from ipx_tpu_torch import entry
    step, (S,) = entry.entry()
    assert S["X"].device.type == "cuda"
    mu_of = step.__self__._mu_of
    mu0 = mu_of(S).clone()
    kernels.reset_launches()
    out = step(S)
    torch.cuda.synchronize()
    for k in ("X", "Y", "mu"):
        assert bool(torch.isfinite(out[k]).all()), k
    for name in ("csr_spmm", "batched_cr_step", "ipm_prologue",
                 "newton_rhs", "newton_recover", "step_batch",
                 "ipm_update"):
        assert kernels.LAUNCHES[name] > 0, name
    assert bool((mu_of(out) < mu0).all())


def test_dryrun_multichip_on_the_card(dev):
    """dryrun_multichip(4) on one card passes its asserts, through K14,
    K15 and K16."""
    from ipx_tpu_torch import entry
    kernels.reset_launches()
    entry.dryrun_multichip(4)
    for name in ("block_sum", "sharded_cr_step", "sharded_batched_cr_step"):
        assert kernels.LAUNCHES[name] > 0, name


# -- the mesh (parallel/mesh.py): 4 ranks sharing the card ----------------------
@pytest.fixture(scope="module")
def card_mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from ipx_tpu_torch import backend
    from ipx_tpu_torch.parallel import mesh as pm
    m = pm.Mesh((4,), ("rows",), [str(backend.cuda_device())] * 4,
                timeout=120.0)
    yield m
    m.close()


def _mesh_system(m, n, B=None, seed=15):
    """A with rows and columns longer than a warp (so the ranks' split sums
    start at lanes the whole rows set), W, diag and rhs."""
    A, rng = _matrix(m, n, 0.05, seed)
    A = sp.csc_matrix(A + sp.eye(m, n))
    shape = (n + m,) if B is None else (n + m, B)
    W = 10.0 ** rng.uniform(-1, 1, shape)
    A2 = A.copy()
    A2.data = A2.data ** 2
    diag = np.asarray(A2 @ W[:n]) + W[n:]
    rhs = rng.standard_normal((m,) if B is None else (m, B))
    return A, W, diag, rhs


def test_mesh_cr_is_k15_bit_for_bit(dev, card_mesh):
    """ShardedDiagCR and sharded_cr_solve over 4 ranks sharing the card
    against the one-card K15 (its cooperative launch) at P = 4, on an A
    whose rows of A' are long: y, trips and error code bit for bit."""
    from ipx_tpu_torch.parallel import sharding
    A, W, diag, rhs = _mesh_system(403, 700)
    n = 700
    rs = 1.0 / np.sqrt(W[n:])
    want = sharding.ShardedDiagCR(A, 4, dev).solve(W[:n], W[n:], diag, rs,
                                                   rhs, 1e-10, 500)
    got = sharding.ShardedDiagCR(A, 4, mesh=card_mesh).solve(
        W[:n], W[n:], diag, rs, rhs, 1e-10, 500)
    assert got[1:] == want[1:] and want[1] > 0
    np.testing.assert_array_equal(got[0], want[0])
    want = sharding.sharded_cr_solve(sharding.ShardedNormalMatrix(A, 4, dev),
                                     W[:n], W[n:], diag, rhs, 1e-10, 500)
    got = sharding.sharded_cr_solve(
        sharding.ShardedNormalMatrix(A, 4, mesh=card_mesh), W[:n], W[n:],
        diag, rhs, 1e-10, 500)
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[0], want[0])
    assert all(s["k15_launches"] > 0 for s in card_mesh.last[-1])


def test_mesh_nnt_is_k4_bit_for_bit(dev, card_mesh):
    """N N' over 4 ranks' column blocks against one K4 launch at P = 4, on
    an N whose rows are longer than a warp: bit for bit."""
    from ipx_tpu_torch.parallel import sharding
    N, rng = _matrix(300, 1001, 0.05, seed=16)
    w = rng.standard_normal(300)
    one = sharding.ShardedSplittedNNt(300, 1001, 4, dev)
    one.set_operand(N)
    over = sharding.ShardedSplittedNNt(300, 1001, 4, mesh=card_mesh)
    over.set_operand(N)
    np.testing.assert_array_equal(over.apply(w), one.apply(w))


@pytest.mark.parametrize("B", [64, 8])
def test_mesh_batched_cr_is_k16_bit_for_bit(dev, card_mesh, B):
    """sharded_batched_cr_solve on 2 x 2 ranks against K16 at P = 2 over all
    B lanes: bit for bit at B = 64 (each rank's K5 partials at the whole
    batch's lane chunks, its grids the one card's: every rank `exact`),
    converged to 1e-10; at B = 8 the lane groups' reducing grids group rows
    otherwise than the whole batch's (no rank `exact`), so 20 trips of
    both, Y within 1e-12."""
    from ipx_tpu_torch.parallel import sharding
    A, W, diag, RHS = _mesh_system(403, 700, B=B)
    n = 700
    tol, maxiter = (1e-10, 300) if B == 64 else (1e-14, 20)
    snm = sharding.ShardedNormalMatrix(A, 2, dev)
    want = sharding.sharded_batched_cr_solve(snm, W[:n], W[n:], diag, RHS,
                                             tol, maxiter)
    m2 = card_mesh.reshape((2, 2), ("rows", "batch"))
    got = sharding.sharded_batched_cr_solve(snm, W[:n], W[n:], diag, RHS, tol,
                                            maxiter, mesh=m2)
    assert got[1] == want[1] > 0
    exact = [st["exact"] for st in m2.last[-1]]
    assert exact == [B == 64] * 4
    if B == 64:
        np.testing.assert_array_equal(got[0], want[0])
    else:
        assert _rel(torch.from_numpy(got[0]),
                    torch.from_numpy(want[0])) <= 1e-12
