"""K1 csr_spmv and K2 normal_apply of ipx_tpu_torch against ipx_tpu's
jax programs (apply_csr, normal_apply_tree) on the same seeded inputs.

Tolerances, relative to the largest entry of the reference result: 1e-12
in float64 (the two sum each row in another order) and 1e-5 in float32
(the reference's cumsum formulation rounds each prefix sum to float32).
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ipx_tpu.ops import spmv as ref
from ipx_tpu_torch.ops import spmv as port

CPU = torch.device("cpu")
RTOL = {"float64": 1e-12, "float32": 1e-5}


def _matrix(m, n, seed):
    rng = np.random.default_rng(seed)
    A = sp.random(m, n, density=0.08, random_state=rng, format="csc",
                  data_rvs=rng.standard_normal)
    A.sort_indices()
    return A, rng


def _rel(got, want):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want,
                                                             dtype=np.float64)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_csr_spmv_matches_apply_csr(dtype):
    import jax.numpy as jnp
    A, rng = _matrix(70, 110, seed=1)
    np_dt = np.dtype(dtype).type
    tdt = getattr(torch, dtype)
    A_csr = A.tocsr()
    u = rng.standard_normal(A.shape[1])
    v = rng.standard_normal(A.shape[0])
    # A u (CSR) and A' v (the CSC read as the CSR of A')
    for (indptr, indices, data, rows, cols, x) in (
            (A_csr.indptr, A_csr.indices, A_csr.data, A.shape[0],
             A.shape[1], u),
            (A.indptr, A.indices, A.data, A.shape[1], A.shape[0], v)):
        want = ref.apply_csr(
            ref.SpmvOperand(indptr, indices, data, rows, np_dt),
            jnp.asarray(x.astype(np_dt)))
        op = port.CsrOperand(indptr, indices, data, cols, CPU, tdt)
        got = port.csr_spmv(op, torch.from_numpy(x.astype(np_dt)))
        assert got.dtype == tdt and got.shape == (rows,)
        assert _rel(got.numpy(), want) <= RTOL[dtype]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_normal_apply_matches_normal_apply_tree(dtype):
    import jax.numpy as jnp
    A, rng = _matrix(60, 90, seed=2)
    m, n = A.shape
    np_dt = np.dtype(dtype).type
    W = rng.uniform(0.1, 3.0, size=n + m).astype(np_dt)
    v = rng.standard_normal(m).astype(np_dt)
    nmd = ref.NormalMatrixDevice(A, dtype=np_dt)
    want = ref.normal_apply_tree(ref.normal_tree(nmd), n, nmd.op_A.R,
                                 nmd.op_At.R, jnp.asarray(W), jnp.asarray(v))
    want = np.asarray(want, dtype=np.float64)
    want_dot = float(np.dot(v.astype(np.float64), want))

    pnmd = port.NormalMatrixDevice(A, CPU, getattr(torch, dtype))
    Cv, vCv = pnmd.apply(torch.from_numpy(W), torch.from_numpy(v))
    assert Cv.shape == (m,) and vCv.dim() == 0
    assert _rel(Cv.numpy(), want) <= RTOL[dtype]
    assert abs(float(vCv) - want_dot) <= RTOL[dtype] * abs(want_dot)


def test_device_operands_follow_the_model_matrix():
    """The operands cached on a Model belong to the matrix they were built
    from; a model cleared and refilled with another LP gets new ones."""
    from ipx_tpu_torch.model import Model
    md = Model()
    md.A, _ = _matrix(6, 9, seed=4)
    first = port.NormalMatrixDevice.from_model(md, CPU)
    assert port.NormalMatrixDevice.from_model(md, CPU) is first
    assert port.NormalMatrixDevice.from_model(md, CPU, torch.float32) \
        is not first
    md.clear()
    md.A, _ = _matrix(11, 7, seed=5)
    second = port.NormalMatrixDevice.from_model(md, CPU)
    assert second is not first and (second.m, second.n) == (11, 7)


def test_lanes_per_row_follows_mean_row_length():
    assert port.lanes_per_row(np.array([0, 2, 4])) == 2       # A' rows
    assert port.lanes_per_row(np.array([0, 10, 19])) == 16    # A rows
    assert port.lanes_per_row(np.array([0, 500])) == 32
    assert port.lanes_per_row(np.array([0])) == 2


def test_wrappers_refuse_a_device_they_cannot_run_on():
    """A tensor that is neither on the CPU nor on a card makes the wrapper
    raise instead of computing the plain version."""
    from ipx_tpu_torch import kernels
    A, _ = _matrix(8, 5, seed=3)
    op = port.CsrOperand(A.tocsr().indptr, A.tocsr().indices,
                         A.tocsr().data, 5, CPU, torch.float64)
    x = torch.zeros(5, dtype=torch.float64, device="meta")
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        port.csr_spmv(op, x)
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("one_launch", [True, False],
                         ids=["one_launch", "three_launches"])
def test_normal_apply_kernel_refuses_what_it_cannot_run(one_launch):
    """K2's wrapper, in its one-launch and its three-launch form, refuses
    a tensor off the card before any launch is counted;
    spmv.normal_apply on the meta device raises instead of computing the
    plain version."""
    from ipx_tpu_torch import kernels
    A, rng = _matrix(30, 50, seed=4)
    nmd = port.NormalMatrixDevice(A, CPU, torch.float64)
    m, n = A.shape
    W = torch.from_numpy(rng.uniform(0.5, 2.0, n + m))
    v = torch.from_numpy(rng.standard_normal(m))
    dot = torch.empty(1, dtype=torch.float64)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.normal_apply(nmd.op_At, nmd.op_A, W, v, dot=dot,
                             one_launch=one_launch)
    with pytest.raises(ValueError, match="CUDA"):
        port.normal_apply(nmd, W, v.to("meta"))
    assert kernels.LAUNCHES == before
    # the plain version on the CPU: the same pair, twice alike
    got, again = port.normal_apply(nmd, W, v), port.normal_apply(nmd, W, v)
    assert torch.equal(got[0], again[0]) and float(got[1]) == float(again[1])
