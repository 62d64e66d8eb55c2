"""The host side of the kernels' plans (ipx_tpu_torch/kernels.py), on the
CPU: the layout of the block products' one launch over P row blocks, which
must give each block the CUDA blocks and partial slots of its own K1
launch; the rules by which K6's and K16's plans take their fused launches;
and the plans' and the step objects' refusal of CPU tensors before the
kernel library is built or loaded.

The layout is held exactly against blocks_for(rows, 256 // vec) per block,
computed here, on the row blocks that ShardedNormalMatrix cuts (the blocks'
lanes per row agreeing and differing, an empty last block). The block
products' values are held against ipx_tpu's mesh program by
tests/test_torch_sharding.py and tests/test_torch_block_layout.py, and on
the card by tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ipx_tpu_torch import kernels
from ipx_tpu_torch.ops import spmv
from ipx_tpu_torch.parallel import batch
from ipx_tpu_torch.parallel import sharding as port

CPU = torch.device("cpu")


def _rows_of(lengths, n, seed):
    """A CSR matrix with n columns whose row i holds lengths[i] entries."""
    rng = np.random.default_rng(seed)
    indptr = np.concatenate([[0], np.cumsum(lengths)])
    indices = np.concatenate([np.sort(rng.choice(n, k, replace=False))
                              for k in lengths]).astype(np.int32)
    return sp.csr_matrix((rng.standard_normal(indptr[-1]), indices, indptr),
                         shape=(len(lengths), n))


# (row lengths, P): long rows, then short ones, so that the row blocks'
# lanes per row differ; uniform rows (they agree); one block, eight blocks,
# an empty last block, and rows above a warp
CASES = [
    pytest.param([20] * 800 + [5] * 1200, 4, id="long-then-short-P4"),
    pytest.param([10] * 1000, 4, id="uniform-P4"),
    pytest.param([3] * 333, 1, id="P1"),
    pytest.param([2, 40, 5, 1, 9] * 100, 8, id="mixed-P8"),
    pytest.param([6] * 5, 4, id="P4-empty-last"),
    pytest.param([60] * 70 + [1] * 70, 2, id="long-short-P2"),
]


@pytest.mark.parametrize("lengths, P", CASES)
def test_block_layout_matches_per_block_launches(lengths, P):
    """block_layout's row and partial offsets are the prefix sums of the
    blocks' rows and of blocks_for(rows_p, 256 // vec_p), each block keeping
    its own lanes per row (k1_lanes), as P separate K1 launches lay them
    out."""
    A = _rows_of(lengths, 100, seed=P + len(lengths))
    snm = port.ShardedNormalMatrix(sp.csc_matrix(A), P, CPU)
    rows = [op.rows for op in snm.op_A]
    vecs = [kernels.k1_lanes(op) for op in snm.op_A]
    row_off, blk_off = kernels.block_layout(rows, vecs)
    per_block = [-(-r // (256 // v)) for r, v in zip(rows, vecs)]
    assert row_off == [0] + np.cumsum(rows).tolist()
    assert blk_off == [0] + np.cumsum(per_block).tolist()
    assert row_off[-1] == A.shape[0]
    if len(set(vecs)) > 1:      # the one launch keeps each block's VEC
        assert blk_off[-1] != -(-A.shape[0] // (256 // max(vecs)))


@pytest.mark.parametrize("mean, want", [(0.0, 2), (1.0, 2), (2.0, 2),
                                        (3.9, 2), (4.0, 4), (9.6, 8),
                                        (12.0, 8), (16.0, 16), (31.0, 16),
                                        (32.0, 32), (500.0, 32)])
def test_k1_lanes_is_the_power_of_two_at_or_below_the_mean(mean, want):
    """K1's lanes per row: the power of two at or below the mean row
    length, within [2, 32] (lanes_per_row, which K2, K4 and K14v keep,
    takes the one at or above it)."""
    class Op:
        rows = 10
        vals = torch.empty(int(round(mean * 10)))
    assert kernels.k1_lanes(Op) == want


def test_block_layout_of_the_transportation_pattern():
    """Rows of 20 then of 5 entries over 4 blocks: K1's lanes per row are
    16, 8, 4 and 4 (the second block holds both kinds), so the one launch
    lays out each block at its own lanes."""
    A = _rows_of([20] * 800 + [5] * 1200, 50, seed=1)
    snm = port.ShardedNormalMatrix(sp.csc_matrix(A), 4, CPU)
    vecs = [kernels.k1_lanes(op) for op in snm.op_A]
    assert vecs == [16, 8, 4, 4]
    _, blk_off = kernels.block_layout([op.rows for op in snm.op_A], vecs)
    assert blk_off == [0, 32, 48, 56, 64]


def _columns_of(lengths, m, seed):
    """A CSC matrix with m rows whose column k holds lengths[k] entries."""
    return sp.csc_matrix(_rows_of(lengths, m, seed).T)


def _transportation():
    from ipx_tpu_torch import testgen as tg
    data = tg.transportation(30, 45, 0.1, seed=3)
    return sp.csc_matrix((data["Ax"], data["Ai"], data["Ap"]),
                         shape=(data["num_constr"], data["num_var"]))


# (matrix, whether K6's plan takes the fused launch): the transportation
# pattern (sum of squared column lengths 2 nnz), columns of 4 (4 nnz, the
# limit) and of 5, and one dense column among short ones
K6_CASES = [
    pytest.param(_transportation, True, id="transportation"),
    pytest.param(lambda: _columns_of([4] * 50, 30, seed=6), True,
                 id="columns-of-4"),
    pytest.param(lambda: _columns_of([5] * 50, 30, seed=7), False,
                 id="columns-of-5"),
    pytest.param(lambda: _columns_of([2] * 60 + [200], 200, seed=8), False,
                 id="one-dense-column"),
]


@pytest.mark.parametrize("make, fused", K6_CASES)
def test_k6_plan_rule_by_column_lengths(make, fused):
    """K6's rule (kernels.k6_fused) on A': the fused launch where the sum
    of A's squared column lengths is at most K6_FUSED_RATIO nnz(A), the two
    launches otherwise; CsrOperand.sq_rows is that sum."""
    A = make()
    nmd = spmv.NormalMatrixDevice(A, CPU)
    lengths = np.diff(A.indptr)
    assert nmd.op_At.sq_rows == int(np.sum(lengths ** 2))
    assert kernels.k6_fused(nmd.op_At) is fused
    if make is _transportation:
        assert nmd.op_At.sq_rows == 2 * A.nnz


@pytest.mark.parametrize("P", [1, 4])
@pytest.mark.parametrize("make, fused", K6_CASES)
def test_k16_plan_rule_by_column_lengths(make, fused, P):
    """K16's plan (BlockNormalBatchedPlan.takes_fused) on the whole A'
    split at P row blocks: the fused launch where the sum of A's squared
    column lengths is at most K6_FUSED_RATIO nnz(A), K6's rule, whatever
    the blocks; the split operand's sq_rows is that sum over whole columns,
    not over the blocks' segments."""
    A = make()
    snm = port.ShardedNormalMatrix(A, P, CPU)
    lengths = np.diff(A.indptr)
    assert snm.op_At_split.sq_rows == int(np.sum(lengths ** 2))
    assert kernels.BlockNormalBatchedPlan.takes_fused(
        snm.op_At_split) is fused


def _lp_shapes(mean, rows=20000):
    """A stand-in for an operand of the batched stage: `rows` rows holding
    `mean` nonzeros each on average (only rows and vals are read)."""
    class Op:
        pass
    op = Op()
    op.rows = rows
    op.vals = torch.empty(int(round(mean * rows)))
    return op


# (mean row length, B, itemsize, vw, (tpr, rpg)): the stage's A U (9.6 a
# row) and A' V (2 a row) at B = 256 in f64 and f32, the entry step's B = 8
# and phase 7's B = 4, one lane a thread at B = 7, and an operand without
# nonzeros
K5_TILES = [
    pytest.param(9.6, 256, 8, 2, (16, 2), id="A-U-f64-256"),
    pytest.param(2.0, 256, 8, 2, (16, 12), id="At-V-f64-256"),
    pytest.param(9.6, 256, 4, 4, (16, 2), id="A-U-f32-256"),
    pytest.param(2.0, 256, 4, 4, (16, 12), id="At-V-f32-256"),
    pytest.param(9.6, 8, 8, 2, (4, 1), id="A-U-f64-8"),
    pytest.param(2.0, 4, 8, 2, (2, 2), id="At-V-f64-4"),
    pytest.param(9.6, 7, 8, 1, (7, 2), id="A-U-f64-7"),
    pytest.param(0.0, 256, 8, 2, (16, 16), id="no-nonzeros"),
]


@pytest.mark.parametrize("mean, B, itemsize, vw, want", K5_TILES)
def test_k5_tile_geometry(mean, B, itemsize, vw, want):
    """K5's tiled form on the host (kernels.k5_tile): a group's segment at
    most K5_SEG_BYTES and at most B lanes, rows a group from the mean row
    length (about K5_GROUP_NZ nonzeros), the block's tile at most
    K5_TILE_ROWS rows and, where it has nonzeros, about half of what a tile
    stages; the arguments the C entry takes."""
    op = _lp_shapes(mean)
    tpr, rpg = kernels.k5_tile(op, B, vw, itemsize)
    assert (tpr, rpg) == want
    groups = kernels.THREADS // tpr
    assert tpr * vw * itemsize <= kernels.K5_SEG_BYTES and tpr <= B // vw
    assert 1 <= rpg and groups * rpg <= kernels.K5_TILE_ROWS
    if mean > 0 and rpg > 1:
        assert groups * rpg * mean <= kernels.K5_STAGE_NZ / 2
        assert rpg * mean <= kernels.K5_GROUP_NZ


# (B, itemsize, epilogue, form): the stage's B = 256 in f64 and f32, the
# entry step's B = 8 and phase 7's B = 4, the least B whose row of U holds
# a whole segment (32 in f64, 64 in f32) and the one below it, and any
# launch with an epilogue
K5_FORMS = [
    pytest.param(256, 8, False, "tile", id="f64-256"),
    pytest.param(256, 4, False, "tile", id="f32-256"),
    pytest.param(8, 8, False, "row", id="f64-8"),
    pytest.param(4, 8, False, "row", id="f64-4"),
    pytest.param(32, 8, False, "tile", id="f64-32"),
    pytest.param(16, 8, False, "row", id="f64-16"),
    pytest.param(64, 4, False, "tile", id="f32-64"),
    pytest.param(32, 4, False, "row", id="f32-32"),
    pytest.param(256, 8, True, "row", id="f64-256-epilogue"),
]


@pytest.mark.parametrize("B, itemsize, epilogue, form", K5_FORMS)
def test_k5_form_rule(B, itemsize, epilogue, form):
    """K5's form on the host (kernels.k5_form): the tiled form for a plain
    product whose rows of U hold at least K5_SEG_BYTES, the row body for
    narrower ones and for every launch with an epilogue, partials or a
    loop state."""
    assert kernels.k5_form(B, itemsize, epilogue) == form


@pytest.fixture
def no_library(monkeypatch):
    """Fails the test if anything builds or loads the kernel library."""
    def refuse(*a, **k):
        raise AssertionError("the kernel library was asked for")
    monkeypatch.setattr(kernels, "load", refuse)
    monkeypatch.setattr(kernels._build, "build", refuse)


def _cpu_blocks():
    A = _rows_of([4] * 30, 12, seed=3)
    snm = port.ShardedNormalMatrix(sp.csc_matrix(A), 3, CPU)
    z = lambda k: torch.zeros(k, dtype=torch.float64)  # noqa: E731
    return snm, z


def _spmv_plan():
    snm, z = _cpu_blocks()
    kernels.SpmvPlan(snm.op_A[0])


def _csr_spmv():
    snm, z = _cpu_blocks()
    kernels.csr_spmv(snm.op_A[0], z(12))


def _block_plan():
    snm, z = _cpu_blocks()
    kernels.BlockSpmvPlan(snm.op_A, z(12), z(30), z(30), z(30), z(30))


def _batched_cr_step():
    A = _rows_of([4] * 30, 12, seed=4)
    nmd = spmv.NormalMatrixDevice(sp.csc_matrix(A), CPU)
    e = lambda *s: torch.ones(s, dtype=torch.float64)  # noqa: E731
    kernels.BatchedCrStep(nmd.op_At, nmd.op_A, e(42, 3), e(30, 3), e(30, 3),
                          e(3), e(30, 3))


def _normal_operands():
    A = _rows_of([4] * 30, 12, seed=4)
    nmd = spmv.NormalMatrixDevice(sp.csc_matrix(A), CPU)
    e = lambda *s: torch.ones(s, dtype=torch.float64)  # noqa: E731
    return nmd, e


def _normal_plan():
    nmd, _ = _normal_operands()
    kernels.NormalBatchedPlan(nmd.op_At, nmd.op_A)


def _normal_apply_batched():
    nmd, e = _normal_operands()
    kernels.normal_apply_batched(nmd.op_At, nmd.op_A, e(42, 3), e(30, 3))


def _cr_step():
    nmd, e = _normal_operands()
    kernels.CrStep(nmd.op_At, nmd.op_A, e(42), e(30), e(30), e(30))


def _sharded_operands():
    A = _rows_of([4] * 30, 12, seed=5)
    snm = port.ShardedNormalMatrix(sp.csc_matrix(A), 3, CPU)
    e = lambda *s: torch.ones(s, dtype=torch.float64)  # noqa: E731
    return snm, e


def _block_batched_plan():
    snm, _ = _sharded_operands()
    kernels.BlockNormalBatchedPlan(snm.op_At_split, snm.op_At, snm.op_A)


def _sharded_batched_cr_step():
    snm, e = _sharded_operands()
    kernels.ShardedBatchedCrStep(snm.op_At_split, snm.op_At, snm.op_A,
                                 e(12, 3), e(30, 3), e(30, 3), e(30, 3))


def _csr_spmm():
    nmd, e = _normal_operands()
    kernels.csr_spmm(nmd.op_A, e(12, 3))


def _starting_point():
    e = lambda *s: torch.ones(s, dtype=torch.float64)  # noqa: E731
    fin = torch.ones(42, dtype=torch.bool)
    kernels.starting_point(e(42, 3), e(12, 3), e(30, 3), e(12, 3), e(30, 3),
                           e(42, 3), e(42), e(42), fin, fin, 0.1)


def _sharded_cr_solve():
    snm, e = _sharded_operands()
    kernels.ShardedCrStep(snm.op_At_split, snm.op_A, e(12), e(30), e(30),
                          e(30), e(30), True).solve(5, 1e-10)


@pytest.mark.parametrize("make", [_spmv_plan, _csr_spmv, _block_plan,
                                  _batched_cr_step, _normal_plan,
                                  _normal_apply_batched, _cr_step,
                                  _block_batched_plan,
                                  _sharded_batched_cr_step,
                                  _sharded_cr_solve, _csr_spmm,
                                  _starting_point],
                         ids=["SpmvPlan", "csr_spmv", "BlockSpmvPlan",
                              "BatchedCrStep", "NormalBatchedPlan",
                              "normal_apply_batched", "CrStep",
                              "BlockNormalBatchedPlan",
                              "ShardedBatchedCrStep", "ShardedCrStep.solve",
                              "csr_spmm", "starting_point"])
def test_plans_refuse_cpu_tensors_before_loading(no_library, make):
    """K1's plans, csr_spmv, K7's step object, K6's plan and wrapper, K3's
    step object (its cooperative solve and host-issued passes), K16's plan
    and step object, K15's step object (its cooperative solve), K5 and
    K13's one launch take CUDA tensors only, and say so before the kernel
    library is built or loaded."""
    with pytest.raises(ValueError, match="CUDA tensors"):
        make()


@pytest.mark.parametrize("B", [1, 7, 300])
def test_batched_cr_plain_meets_each_lane_tolerance(B):
    """K7's plain version at the lane counts the card tests take (below a
    warp, not a multiple of 8, past one block of 256 lanes): every lane's
    scaled residual within its own tolerance, spread over decades so lanes
    freeze at different trips."""
    rng = np.random.default_rng(B)
    A = sp.csc_matrix(_rows_of(list(rng.integers(1, 9, 60)), 90, seed=B))
    m, n = A.shape
    nmd = spmv.NormalMatrixDevice(A, CPU)
    W = rng.uniform(0.5, 2.0, (n + m, B))
    A2 = A.copy()
    A2.data **= 2
    invd = 1.0 / (A2 @ W[:n] + W[n:])
    rs = 1.0 / np.sqrt(W[n:])
    rhs = rng.standard_normal((m, B))
    tol = np.max(np.abs(rs * rhs), axis=0) * 10.0 ** rng.uniform(-8, -2, B)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))  # noqa: E731
    Y, trips = batch.batched_cr(nmd, t(W), t(invd), t(rs), t(rhs), t(tol),
                                1000)
    assert 0 < trips < 1000
    Yn = Y.numpy()
    res = rhs - (A @ (W[:n] * (A.T @ Yn)) + W[n:] * Yn)
    assert np.all(np.max(np.abs(rs * res), axis=0) <= tol * (1 + 1e-6))
