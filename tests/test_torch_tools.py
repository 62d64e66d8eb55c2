"""The port's device measuring tools (tools/torch_*.py) on the CPU, each in
a fresh process with --device torch_cpu, the device path with the kernels'
plain versions.

The batched phase 1, the pipeline and the finish strategies are held
against the reference's tools (tools/device_batch_solve_bench.py,
pipeline_e2e_bench.py, batched_finish_bench.py on jax's CPU backend) at
the same small instance, to the tolerances of tests/test_torch_batch.py:
steps and mean IPM iterations within 3 (the inexact CR makes per-lane step
counts differ by rounding, in the reference too), the same converged and
optimal counts, and objectives to 1e-8 relative, the port's against the
reference's host solves of the same scenarios. The K6 sweep and the
scaling table run on the port's side only (the reference's scaling table
writes docs/SCALING.tbl): their keys, and every row's fixed trip count
with a finite residual. Without a card each tool's default device, "cuda",
makes it exit non-zero."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import ipx_tpu
from ipx_tpu import testgen as ref_tg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--src", "30", "--snk", "45", "--density", "0.3", "--B", "4"]
B = 4
ITER_TOL = 3
OBJ_RTOL = 1e-8


def run(tool, args, env=None):
    """(returncode, last line as JSON or None, stderr) of one tool."""
    out = subprocess.run([sys.executable, os.path.join("tools", tool)]
                         + args, cwd=REPO, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, **(env or {})))
    lines = out.stdout.strip().splitlines()
    last = json.loads(lines[-1]) if lines and lines[-1].startswith("{") \
        else None
    return out.returncode, last, out.stderr


def port(tool, args):
    rc, line, err = run(tool, args + ["--device", "torch_cpu"])
    assert rc == 0, err[-3000:]
    assert line["card"] == "cpu" and line["failures"] == []
    assert {"OMP_NUM_THREADS", "blas_pools", "blas_in_solve"} <= set(line)
    return line


def reference(tool, args):
    rc, line, err = run(tool, args, env={"JAX_PLATFORMS": "cpu"})
    assert rc == 0, err[-3000:]
    return line


def reference_objectives():
    """pobjval of each scenario of TINY solved cold by ipx_tpu's host path:
    the scenarios of tools/device_batch_solve_bench.py:72-81."""
    data = ref_tg.transportation(30, 45, 0.3, 1)
    m = data["num_constr"]
    rng = np.random.default_rng(0)
    fac = np.empty((B, m))
    fac[:, :30] = rng.uniform(1.0, 1.1, size=(B, 30))
    fac[:, 30:] = rng.uniform(0.9, 1.0, size=(B, m - 30))
    objs = []
    for b in data["rhs"][None, :] * fac:
        s = ipx_tpu.LpSolver(ipx_tpu.Parameters(display=0, device="cpu"))
        ref_tg.load_into_solver(dict(data, rhs=b), s)
        assert s.solve() == 1000
        objs.append(s.get_info().pobjval)
    return np.array(objs)


def close_iters(a, b):
    return abs(a - b) <= ITER_TOL


def same_objectives(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return bool(np.all(np.abs(got - want) <= OBJ_RTOL * np.abs(want)))


def check_batch_solve():
    p = port("torch_device_batch_solve_bench.py", TINY)
    r = reference("device_batch_solve_bench.py", TINY + ["--backend",
                                                         "host"])
    assert p["platform"] == "cpu" and p["B"] == B
    assert p["converged_all"] == r["converged_all"]
    assert p["done_count"] == r["done_count"] == B
    assert close_iters(p["steps"], r["steps"])
    assert close_iters(p["mean_ipm_iters"], r["mean_ipm_iters"])
    keys = set(r) - {"backend", "compile_start_s", "compile_step_s"}
    assert keys | {"device", "warmup_s", "launches"} <= set(p)


def check_pipeline():
    p = port("torch_pipeline_e2e_bench.py", TINY)
    r = reference("pipeline_e2e_bench.py", TINY + ["--phase1-backend",
                                                   "host"])
    assert p["optimal"] == r["optimal"] == B
    for k in ("phase1_steps", "finish_mean_iters", "cold_mean_iters"):
        assert close_iters(p[k], r[k]), k
    assert p["max_obj_rel_diff"] <= OBJ_RTOL
    assert same_objectives(p["objs"], reference_objectives())
    keys = set(r) - {"phase1_backend", "compile_s"}
    assert keys | {"phase1_device", "warmup_s"} <= set(p)


def check_finish():
    """The port finishes every scenario in every strategy. The reference's
    r4 and r5 run its polish, which in some runs hands on a lane whose
    duals diverged, and that lane's finish ends at 1004 (ROADMAP Queue 3,
    standing differences): where the reference's polish run finished
    fewer than B, that strategy is held on the port's side only, and its
    objectives against the reference's host solves."""
    p = port("torch_batched_finish_bench.py", TINY)
    r = reference("batched_finish_bench.py", TINY)
    for k in ("r3_finish_only", "r4_shared_basis_polish",
              "r5_polish_with_correction"):
        assert p[k]["optimal"] == B, k
        assert p[k]["max_obj_rel_diff"] <= OBJ_RTOL, k
        if k == "r3_finish_only" or r[k]["optimal"] == B:
            assert r[k]["optimal"] == B, k
            assert close_iters(p[k]["mean_finish_iters"],
                               r[k]["mean_finish_iters"]), k
    assert p["r3_finish_only"]["polish_steps"] is None
    assert p["r5_polish_with_correction"]["polish_steps"] > 0
    assert same_objectives(p["cold_objs"], reference_objectives())
    assert set(r) <= set(p)


PARITY = {"batch_solve": check_batch_solve, "pipeline": check_pipeline,
          "finish": check_finish}


@pytest.mark.parametrize("case", sorted(PARITY))
def test_tool_matches_the_reference(case):
    PARITY[case]()


def test_batched_sweep_runs_on_torch_cpu():
    p = port("torch_device_batched_bench.py",
             ["--sources", "30", "--sinks", "45", "--density", "0.3",
              "--batches", "4", "8"])
    assert p["k6_form"] in ("fused", "two K5 launches")
    assert [row["B"] for row in p["rows"]] == [4, 8]
    for row in p["rows"]:
        assert set(row) == {"B", "device_ms", "device_lane_applies_per_s",
                            "scipy_ms", "scipy_lane_applies_per_s",
                            "device_vs_native"}
        assert row["device_lane_applies_per_s"] > 0
    assert p["native_matvec_per_s"] > 0 and p["launches"] == {}


def test_scaling_table_runs_its_fixed_trips():
    """Every P runs 200 trips to a finite residual; docs/SCALING.tbl, the
    reference tool's output, is left as it is."""
    tbl = os.path.join(REPO, "docs", "SCALING.tbl")
    before = os.stat(tbl).st_mtime_ns
    p = port("torch_scaling_table.py", ["--src", "300", "--snk", "450"])
    assert [row["blocks"] for row in p["rows"]] == [1, 2, 4, 8]
    for row in p["rows"]:
        assert row["trips"] == p["trips"] == 200
        assert np.isfinite(row["residual"]) and row["wall_s"] > 0
    assert p["rows"][0]["t_P_over_t_1"] == 1.0
    assert os.stat(tbl).st_mtime_ns == before


NO_CARD = {"torch_device_batch_solve_bench.py": TINY,
           "torch_pipeline_e2e_bench.py": TINY,
           "torch_batched_finish_bench.py": TINY,
           "torch_device_batched_bench.py": ["--sources", "30", "--sinks",
                                             "45", "--batches", "4"],
           "torch_scaling_table.py": ["--src", "30", "--snk", "45"]}


@pytest.mark.parametrize("tool", sorted(NO_CARD))
def test_default_device_without_a_card_fails(tool):
    """The default --device is "cuda": with the card hidden the tool raises
    before any work and prints no result."""
    rc, line, err = run(tool, NO_CARD[tool], env={"CUDA_VISIBLE_DEVICES":
                                                  ""})
    assert rc != 0 and line is None
    assert "torch.cuda.is_available() is False" in err
