"""The port's benchmark (tools/torch_bench.py) on the CPU: --quick with
--device torch_cpu at a small instance, in a fresh process. Every key of
its line is there, and its host path's solve_status (status, status_ipm,
status_crossover, IPM iterations, CR iterations) is bench.py's full_solve
at the same size, with the objective to 1e-8 relative; the torch_cpu
path ends at the same status with the objective to 1e-8. Without a card
its default device, "cuda", makes it exit non-zero."""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = (300, 450, 0.01, 1)
ARGS = ["--src", "300", "--snk", "450", "--density", "0.01", "--B", "8"]
KEYS = {"solve_status", "objval", "full_solve_s", "full_solve_cpu_s",
        "full_solve_cpu_walls_s", "highs_ipm_s", "highs_ipm_status",
        "highs_dual_simplex_s", "full_solve_100k_rows_s",
        "full_solve_100k_rows_cpu_s", "highs_ipm_100k_s",
        "vs_baseline_100k_rows", "solve_status_100k", "launches_100k",
        "host_matvec_per_s", "native_matvec_per_s",
        "device_f32_matvec_per_s", "device_f64_matvec_per_s",
        "device_f32_batched8_matvec_per_s", "device_vs_host_batched",
        "batched_stage_device", "batched_stage_step2_ratio",
        "batched_stage_step2_host_s", "batched_stage_step2_device_s",
        "batched_stage_torch_cpu",
        "launches", "device", "card", "OMP_NUM_THREADS", "blas_pools",
        "blas_in_solve"}


def run(args, env=None):
    return subprocess.run([sys.executable, "tools/torch_bench.py"] + args,
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300, env=dict(os.environ, **(env or {})))


@pytest.fixture(scope="module")
def line():
    out = run(["--quick", "--device", "torch_cpu"] + ARGS)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_quick_bench_prints_every_key(line):
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "extra",
                         "failures"}
    assert line["failures"] == []
    assert line["metric"] == "full_solve_transportation_750_rows"
    assert line["value"] > 0 and line["vs_baseline"] > 0
    extra = line["extra"]
    assert set(extra) == KEYS
    assert extra["card"] == "cpu" and extra["device"] == "torch_cpu"
    stage = extra["batched_stage_device"]
    assert stage["steps"] > 0 and stage["cr_trips"] > 0
    # not measured under --quick
    assert extra["full_solve_100k_rows_s"] is None
    assert extra["batched_stage_step2_ratio"] is None


def test_solve_status_matches_bench_full_solve(line):
    sys.path.insert(0, REPO)
    import bench
    src, snk, density, seed = SMALL
    _, _, stats = bench.full_solve(src, snk, seed, density=density)
    extra = line["extra"]
    assert extra["solve_status"]["cpu"] == list(stats)
    assert extra["solve_status"]["torch_cpu"][:3] == list(stats[:3])
    assert abs(extra["solve_status"]["torch_cpu"][3] - stats[3]) <= 3
    want = ref_objval()
    for path in ("cpu", "torch_cpu"):
        assert abs(extra["objval"][path] - want) <= 1e-8 * abs(want), path


def ref_objval():
    from ipx_tpu import LpSolver, Parameters
    from ipx_tpu.testgen import load_into_solver, transportation
    s = LpSolver(Parameters(display=0, device="cpu"))
    load_into_solver(transportation(*SMALL), s)
    assert s.solve() == 1000
    return s.get_info().objval


def test_default_device_without_a_card_fails():
    out = run(["--quick"] + ARGS, env={"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and not out.stdout.strip()
    assert "torch.cuda.is_available() is False" in out.stderr
