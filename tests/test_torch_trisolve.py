"""The level-scheduled triangular solve of ipx_tpu_torch (ops/trisolve.py,
the plain version of K17 on the CPU) and its tool, against
tools/device_trisolve_proto.py and scipy.

The reference's level_solve is nested inside that tool's main(), so the
parity test runs both tools at the same small LP, each in a subprocess,
and compares their JSON lines: the schedule statistics must be equal and
each tool's sweep within 1e-12 of spsolve_triangular. The plain sweeps are
held against spsolve_triangular on L and U of a small splu to 1e-12
relative (the two sum each row in another order).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from ipx_tpu_torch import kernels
from ipx_tpu_torch.ops import trisolve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ("40", "60", "0.05")         # m = 100 after presolve
SCHEDULE_KEYS = ("m", "levels_L", "levels_U", "Rmax", "Emax", "nnzL",
                 "nnzU")


def _tool(script, backend, env=None):
    out = subprocess.run(
        [sys.executable, os.path.join("tools", script), backend, *SMALL],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, **(env or {})))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_tool_schedule_matches_reference_tool():
    """tools/torch_trisolve_proto.py torch_cpu against
    tools/device_trisolve_proto.py host at transportation(40, 60, 0.05,
    1): equal level counts, Rmax, Emax and factor sizes; every sweep of the
    port's within 1e-12 of spsolve_triangular; the library yardstick
    agrees."""
    want = _tool("device_trisolve_proto.py", "host",
                 env={"JAX_PLATFORMS": "cpu"})
    got = _tool("torch_trisolve_proto.py", "torch_cpu")
    assert {k: got[k] for k in SCHEDULE_KEYS} == \
        {k: want[k] for k in SCHEDULE_KEYS}
    assert got["levels_L"] > 1 and got["levels_U"] > 1
    for B in (1, 256, 1024):
        assert got[f"relerr_B{B}"] <= 1e-12, B
        assert got[f"library_relerr_B{B}"] <= 1e-12, B
        for key in (f"lvl_solveL_B{B}_ms", f"full_solve_B{B}_ms",
                    f"compile_B{B}_s"):
            assert key in want and got[key] > 0, key
    for key in ("host_native_solve_ms", "host_blocked_solve256_ms",
                "host_blocked_solve1024_ms"):
        assert key in want and got[key] > 0, key
    assert got["backend"] == "torch_cpu" and "OMP_NUM_THREADS" in got


@pytest.fixture(scope="module")
def factors():
    """L and U of splu (COLAMD) of a sparse nonsymmetric 400 x 400 matrix,
    as CSR."""
    rng = np.random.default_rng(3)
    A = sp.random(400, 400, density=0.01, random_state=rng, format="csc") \
        + sp.diags(rng.uniform(1.0, 2.0, 400))
    lu = spla.splu(sp.csc_matrix(A), permc_spec="COLAMD")
    return {"L": lu.L.tocsr(), "U": lu.U.tocsr()}


@pytest.mark.parametrize("B", [1, 8, 256])
@pytest.mark.parametrize("which", ["L", "U"])
def test_plain_sweep_matches_spsolve_triangular(factors, which, B):
    T = factors[which]
    lower = which == "L"
    sched = trisolve.level_schedule(T, lower, device="cpu")
    assert sched.nlev > 1
    V = np.random.default_rng(B).standard_normal((T.shape[0], B))
    before = dict(kernels.LAUNCHES)
    X = trisolve.level_solve(sched, torch.from_numpy(V)).numpy()
    assert kernels.LAUNCHES == before       # the CPU runs no kernel
    want = spla.spsolve_triangular(T, V, lower=lower)
    assert np.max(np.abs(X - want)) <= 1e-12 * np.max(np.abs(want))


@pytest.mark.parametrize("lower", [True, False], ids=["lower", "upper"])
def test_schedule_layout(factors, lower):
    """Each row stands once, ascending within its level; each row's entries
    are its off-diagonal ones in storage order and inv_diag is 1 / its
    diagonal; a row's level is one more than the highest level among the
    rows it names (0 if none), the definition the reference's loop
    computes; Rmax and Emax are the most rows and entries of a level."""
    T = factors["L" if lower else "U"]
    m = T.shape[0]
    sched = trisolve.level_schedule(T, lower, device="cpu")
    rows, ptr = sched.rows.numpy(), sched.level_ptr
    ep, cols, vals = (sched.entry_ptr.numpy(), sched.cols.numpy(),
                      sched.vals.numpy())
    assert sorted(rows) == list(range(m))
    lev = np.empty(m, dtype=np.int64)
    for l in range(sched.nlev):
        r = rows[ptr[l]:ptr[l + 1]]
        assert len(r) > 0 and np.all(np.diff(r) > 0)
        lev[r] = l
    for p, i in enumerate(rows):
        c = T.indices[T.indptr[i]:T.indptr[i + 1]]
        v = T.data[T.indptr[i]:T.indptr[i + 1]]
        off = c < i if lower else c > i
        assert np.array_equal(cols[ep[p]:ep[p + 1]], c[off])
        assert np.array_equal(vals[ep[p]:ep[p + 1]], v[off])
        assert sched.inv_diag.numpy()[p] == 1.0 / T[i, i]
        assert lev[i] == (lev[c[off]].max() + 1 if off.any() else 0), i
    per_level = np.diff(ptr)
    assert sched.Rmax == per_level.max() and sched.nlev > 1
    assert sched.Emax == max(np.diff(ep[ptr]).max(), 1)


def test_explicit_zeros_are_dependencies():
    """An explicit zero stored off the diagonal is an entry, as in the
    reference's schedule: it makes its row wait for the row it names, and
    the sweep is still exact."""
    # [[2, 0, 0], [0, 4, 0], [1, 0, 1]], row 1 storing T[1, 0] = 0
    T = sp.csr_matrix((np.array([2.0, 0.0, 4.0, 1.0, 1.0]),
                       np.array([0, 0, 1, 0, 2]), np.array([0, 1, 3, 5])),
                      shape=(3, 3))
    assert T.nnz == 5 and T[1, 0] == 0.0
    sched = trisolve.level_schedule(T, lower=True, device="cpu")
    assert sched.nlev == 2 and sched.level_ptr.tolist() == [0, 1, 3]
    assert sched.rows.tolist() == [0, 1, 2]
    V = torch.tensor([[2.0], [8.0], [3.0]], dtype=torch.float64)
    X = trisolve.level_solve(sched, V)
    assert X.flatten().tolist() == [1.0, 2.0, 2.0]


def test_level_solve_checks_its_input(factors):
    """V must be (m, B), float64 and on the schedule's device; a tensor on
    neither the CPU nor a card makes the wrapper raise, with no launch
    counted."""
    sched = trisolve.level_schedule(factors["L"], lower=True,
                                    device="cpu")
    m = sched.m
    with pytest.raises(ValueError, match="shape"):
        trisolve.level_solve(sched, torch.zeros((m + 1, 2),
                                                dtype=torch.float64))
    with pytest.raises(ValueError, match="float64"):
        trisolve.level_solve(sched, torch.zeros((m, 2)))
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError):
        trisolve.level_solve(sched, torch.zeros((m, 2), dtype=torch.float64,
                                                device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.level_solve(sched, torch.zeros((m, 2), dtype=torch.float64))
    assert kernels.LAUNCHES == before


def test_schedule_defaults_to_the_card(factors, monkeypatch):
    """level_schedule with no device puts the schedule where the port's
    rule puts it, backend.cuda_device(): without a card it raises, as the
    port's other entry points do; with one (monkeypatched here to the meta
    device) every tensor lies there, level_ptr_dev too; "cpu" keeps it on
    the CPU."""
    from ipx_tpu_torch import backend
    T = factors["L"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        trisolve.level_schedule(T, lower=True)
    card = torch.device("meta")
    monkeypatch.setattr(backend, "cuda_device", lambda: card)
    sched = trisolve.level_schedule(T, lower=True)
    for name in ("level_ptr_dev", "rows", "entry_ptr", "cols", "vals",
                 "inv_diag"):
        assert getattr(sched, name).device == card, name
    assert sched.device == card
    for device in ("cpu", torch.device("cpu")):
        assert trisolve.level_schedule(T, True, device).device.type == "cpu"


@pytest.mark.parametrize("lower", [True, False], ids=["lower", "upper"])
def test_schedule_device_level_pointer(factors, lower):
    """level_ptr_dev is the host level_ptr on the schedule's device: int64,
    contiguous, nlev + 1 entries from 0 to m, equal value for value; the
    sweep's schedule check takes it and refuses one of the wrong length or
    type."""
    import dataclasses
    sched = trisolve.level_schedule(factors["L" if lower else "U"], lower,
                                    device="cpu")
    lp = sched.level_ptr_dev
    assert lp.dtype == torch.int64 and lp.is_contiguous()
    assert lp.shape == (sched.nlev + 1,) and lp.device == sched.device
    assert np.array_equal(lp.numpy(), sched.level_ptr)
    assert int(lp[0]) == 0 and int(lp[-1]) == sched.m
    cpu = torch.device("cpu")
    kernels._check_schedule(sched, cpu)
    for bad in (lp[:-1], lp.int(), lp.double()):
        with pytest.raises(ValueError, match="level_ptr_dev"):
            kernels._check_schedule(
                dataclasses.replace(sched, level_ptr_dev=bad), cpu)
    with pytest.raises(ValueError, match="level_ptr"):
        kernels._check_schedule(dataclasses.replace(
            sched, level_ptr=sched.level_ptr.astype(np.int32)), cpu)


@pytest.mark.parametrize("B, want", [(1, 1), (3, 1), (254, 1), (255, 2),
                                     (256, 2), (300, 2), (1024, 8),
                                     (100000, 32)])
def test_sweep_tiles_rule(B, want):
    """k17_tile: the widest tile of at most 32 lanes that still leaves
    K17_TILES tiles, one block a tile; sweep_tiles takes it where the
    caller gives no choice."""
    assert kernels.k17_tile(B) == want
    assert kernels.sweep_tiles(B) == want
    assert -(-B // want) >= min(kernels.K17_TILES, B)


def test_sweep_checks_its_input(factors):
    """The one-launch sweep's wrapper takes tiles of 1-32 lanes (a power of
    two); the per-level form and the sweep both refuse a CPU tensor before
    any launch is counted."""
    for lanes in (3, 64, 0, -4):
        with pytest.raises(ValueError, match="lanes a tile"):
            kernels.sweep_tiles(256, lanes)
    assert kernels.sweep_tiles(256, 4) == 4
    sched = trisolve.level_schedule(factors["L"], lower=True, device="cpu")
    V = torch.zeros((sched.m, 4), dtype=torch.float64)
    before = dict(kernels.LAUNCHES)
    for per_level in (False, True):
        with pytest.raises(ValueError, match="CUDA"):
            kernels.level_solve(sched, V, per_level=per_level)
    assert kernels.LAUNCHES == before
