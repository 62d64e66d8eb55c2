"""The yardstick's frozen copies against what they were copied from: the
transportation generator against the program's, the byte counts against
chip_smoke.py's at the shapes of PERF.md's kernel table."""
import numpy as np
import pytest

from lpbench import yardstick
from lpbench.generators import transportation

# the 20k transportation LP at B = 256 (PERF.md's kernel table)
M, N, NNZ, B = 20000, 96002, 192004, 256


@pytest.mark.parametrize("args", [(30, 45, 0.3, 1), (30, 45, 0.3, 7),
                                  (60, 90, 0.05, 2), (200, 300, 0.01, 5),
                                  (12, 7, 0.5, 2 ** 31 + 11)])
def test_generator_is_the_programs(args):
    from ipx_tpu_torch import testgen
    got = transportation.make(*args)
    want = testgen.transportation(*args)
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k])
        else:
            assert got[k] == want[k]


def test_scenarios_follow_the_rule_and_the_seed():
    data = transportation.make(30, 45, 0.3, 1)
    b = transportation.scenarios(data, 30, 8, seed=2 ** 31 + 3, request=4)
    fac = b / data["rhs"][None, :]
    assert b.shape == (8, 75)
    assert np.all((fac[:, :30] >= 1.0) & (fac[:, :30] <= 1.1))
    assert np.all((fac[:, 30:] >= 0.9) & (fac[:, 30:] <= 1.0))
    again = transportation.scenarios(data, 30, 8, seed=2 ** 31 + 3,
                                     request=4)
    other = transportation.scenarios(data, 30, 8, seed=2 ** 31 + 3,
                                     request=5)
    assert np.array_equal(b, again) and not np.array_equal(b, other)


def test_stage_lp_is_the_scenario_solvers():
    from ipx_tpu_torch.parallel.batch import BatchedScenarioSolver
    data = transportation.make(30, 45, 0.3, 1)
    b = transportation.scenarios(data, 30, 4, seed=3, request=0)
    A, bb, c, lb, ub = yardstick.stage_lp(data, b)
    want = BatchedScenarioSolver(data, b).blp
    assert (A != want.A).nnz == 0
    for got, ref in ((bb, want.b), (c, want.c), (lb, want.lb),
                     (ub, want.ub)):
        assert np.array_equal(got, ref)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_k6_bytes_are_chip_smokes(dtype):
    import torch
    import chip_smoke
    from ipx_tpu_torch.ops.spmv import NormalMatrixDevice
    data = transportation.make(8000, 12000, 0.001, 1)
    A, _, _, _, _ = yardstick.stage_lp(data, data["rhs"][None, :])
    tdt = {"f32": torch.float32, "f64": torch.float64}[dtype]
    nmd = NormalMatrixDevice(A, torch.device("cpu"), tdt)

    def e(*shape):
        return torch.empty(shape, dtype=tdt)
    # chip_smoke's phase 5: bound(op_bytes(A) + op_bytes(A') + nbytes(W, V,
    # out, dots), ...)
    want = (chip_smoke.op_bytes(nmd.op_A) + chip_smoke.op_bytes(nmd.op_At)
            + chip_smoke.nbytes(e(N + M, B), e(M, B), e(M, B), e(B)))
    got = yardstick.k6_bytes(M, N, NNZ, B, dtype)
    assert got == want
    # PERF.md's table: 48.9 us (f32), 97.0 us (f64)
    us = {"f32": 48.9, "f64": 97.0}[dtype]
    assert round(1e6 * yardstick.bound_s(got), 1) == us
    assert chip_smoke.bound(want, 0, dtype)["bound_ms"] == pytest.approx(
        1e3 * yardstick.bound_s(got), rel=1e-15)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_k7_bytes_are_chip_smokes(dtype):
    import chip_smoke
    npa = yardstick.lane_blocks(M, B)
    assert npa == 1024        # the grid's cap: m rows a lane tile of 256
    assert yardstick.k7_elem_arrays(M, B, npa) == \
        chip_smoke.k7_elem_arrays(M, B, npa)
    got = yardstick.k7_bytes(M, B, dtype)
    want = chip_smoke.k7_elem_bounds(M, B, npa)
    for name in ("kPassCA", "kPassB"):
        assert 1e3 * yardstick.bound_s(got[name]) == pytest.approx(
            want[f"{name} {dtype}"], rel=1e-15)
    # PERF.md's table (chip_smoke run 9, PR 11)
    table = {("kPassCA", "f32"): 55.65, ("kPassCA", "f64"): 111.29,
             ("kPassB", "f32"): 55.02, ("kPassB", "f64"): 110.04}
    for name in ("kPassCA", "kPassB"):
        assert round(1e6 * yardstick.bound_s(got[name]), 2) == \
            table[(name, dtype)]


@pytest.mark.parametrize("rows,lanes,want", [(20000, 256, 1024),
                                             (100000, 64, 1024),
                                             (75, 4, 2), (75, 256, 75),
                                             (1, 1, 1)])
def test_lane_blocks(rows, lanes, want):
    assert yardstick.lane_blocks(rows, lanes) == want
