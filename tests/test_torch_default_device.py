"""The port's entry points default to the card: with the card hidden
(CUDA_VISIBLE_DEVICES=""), Parameters().device is "cuda"; a
default-constructed batched solver, polish, scenario solver, row-blocked
operator or entry() raises instead of running on the CPU, and
LpSolver.solve and capi.ipx_solve return INTERNAL_ERROR (1004), as they do
for an unknown device, before any work: neither presolve nor the IPM is
entered.

All cases run in one fresh process, which prints one line per case."""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RUN = r'''
import json, sys
sys.path.insert(0, "tests")
import numpy as np
import scipy.sparse as sp
import torch
import ipx_tpu_torch
from ipx_tpu_torch import LpSolver, Parameters, capi, entry, testgen
from ipx_tpu_torch.lp_solver import LpSolver as _L
from ipx_tpu_torch.parallel import batch, batch2, sharding
from lp_fixtures import afiro

entered = []
for name in ("_presolve", "_interior_point_solve"):
    orig = getattr(_L, name)
    setattr(_L, name, lambda self, _o=orig, _n=name: (entered.append(_n),
                                                      _o(self))[1])


def outcome(fn):
    try:
        out = fn()
    except RuntimeError as e:
        return "raised: " + str(e)
    return f"returned {out}"


def lp_solve(device=None):
    p = Parameters(display=0)
    if device is not None:
        p.device = device
    s = LpSolver(p)
    assert afiro().load_into(s) == 0
    return s.solve()


def capi_solve():
    h = capi.ipx_new()
    a = afiro().arrays()
    capi.ipx_load_model(h, a["num_var"], a["obj"], a["lb"], a["ub"],
                        a["num_constr"], a["Ap"], a["Ai"], a["Ax"], a["rhs"],
                        a["constr_type"])
    return capi.ipx_solve(h)


data = testgen.transportation(10, 15, 0.3, seed=3)
b = data["rhs"][None, :] * np.array([[1.0], [1.02]])
blp = batch.BatchedScenarioSolver(data, b).blp
A = sp.random(9, 7, density=0.4, format="csc", random_state=6)
cases = {
    "LpSolver.solve": lp_solve,
    "capi.ipx_solve": capi_solve,
    "LpSolver.solve unknown device": lambda: lp_solve("tpu"),
    "BatchedPhase1Solver": lambda: batch.BatchedPhase1Solver(blp),
    "SharedBasisBatchedPolish":
        lambda: batch2.SharedBasisBatchedPolish(blp, None),
    "BatchedScenarioSolver.solve":
        lambda: batch.BatchedScenarioSolver(data, b).solve(),
    "ShardedNormalMatrix": lambda: sharding.ShardedNormalMatrix(A, 2),
    "ShardedDiagCR": lambda: sharding.ShardedDiagCR(A, 2),
    "ShardedSplittedNNt": lambda: sharding.ShardedSplittedNNt(9, 7, 2),
    "entry": entry.entry,
}
out = {name: outcome(fn) for name, fn in cases.items()}
out["Parameters().device"] = Parameters().device
out["cuda.is_available"] = torch.cuda.is_available()
out["entered"] = entered
print(json.dumps(out))
'''

CASES = ["BatchedPhase1Solver", "SharedBasisBatchedPolish",
         "BatchedScenarioSolver.solve", "ShardedNormalMatrix",
         "ShardedDiagCR", "ShardedSplittedNNt", "entry"]
SOLVES = ["LpSolver.solve", "capi.ipx_solve", "LpSolver.solve unknown device"]


@pytest.fixture(scope="module")
def hidden():
    out = subprocess.run([sys.executable, "-c", RUN], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["cuda.is_available"] is False
    return res


def test_parameters_default_to_cuda(hidden):
    assert hidden["Parameters().device"] == "cuda"


@pytest.mark.parametrize("case", CASES)
def test_default_constructed_raises_without_a_card(hidden, case):
    assert hidden[case].startswith("raised: "), hidden[case]
    assert "is_available" in hidden[case]


@pytest.mark.parametrize("case", SOLVES)
def test_solve_returns_internal_error_without_a_card(hidden, case):
    """LpSolver.solve and the C API's ipx_solve return INTERNAL_ERROR
    (1004) without a card or for an unknown device, as the reference and
    IPX's C API return a status for every error; they do not raise."""
    assert hidden[case] == "returned 1004", hidden[case]


def test_no_host_solve_without_a_card(hidden):
    """The solves that stopped never entered presolve or the IPM."""
    assert hidden["entered"] == []
