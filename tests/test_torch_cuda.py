"""The CUDA kernels K1-K9 against their plain PyTorch versions on the card,
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
K8's step sizes and K9 are exact.
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
    nmd, W, invd, resscale, rhs = _cr_inputs(dev, dtype)
    tol = 1e-10 if dtype == torch.float64 else 1e-4
    before = kernels.LAUNCHES["cr_step"]
    y, it, err = device_cr.cr_solve(nmd, W, invd, resscale, rhs, tol, 1000)
    assert kernels.LAUNCHES["cr_step"] > before
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


def test_nnt(dev):
    A, rng = _matrix(500, 800, 0.01, seed=4)
    csr = A.tocsr()
    Nt = spmv.CsrOperand(A.indptr, A.indices, A.data, A.shape[0], dev,
                         torch.float64)
    N = spmv.CsrOperand(csr.indptr, csr.indices, csr.data, A.shape[1], dev,
                        torch.float64)
    w = torch.from_numpy(rng.standard_normal(A.shape[0])).to(dev)
    before = dict(kernels.LAUNCHES)
    z = device_cr2.nnt(Nt, N, w)
    assert kernels.LAUNCHES["nnt"] == before["nnt"] + 1
    assert kernels.LAUNCHES["csr_spmv"] == before["csr_spmv"] + 2
    assert _rel(z, device_cr2.nnt_plain(Nt, N, w)) <= 1e-12


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


# -- the batched kernels K5-K9 --------------------------------------------------
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
    from ipx_tpu_torch.host import testgen as tg

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
