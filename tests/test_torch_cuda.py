"""The CUDA kernels K1-K13 against their plain PyTorch versions on the card,
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


# -- the rest of the batched step, K10-K13 (float64) ------------------------------
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


# -- the shared-basis polish (parallel/batch2.py) -------------------------------------
def _polish_setup(B=4):
    """test_batch2.py's pipeline LP: a loose batched phase 1 on the CPU and
    the factorized mean-scenario basis."""
    from ipx_tpu_torch import LpSolver, Parameters
    from ipx_tpu_torch.host import testgen as tg
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
    from ipx_tpu_torch.host import testgen as tg
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
