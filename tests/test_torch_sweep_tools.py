"""The port's host sweep tools (tools/torch_stress_sweep.py,
torch_results_table.py, torch_lu_update_compare.py) on the CPU, each in a
fresh process with --device cpu (the host path) and --device torch_cpu
(the device path with the kernels' plain versions), on a small slice: one
seed per generator with --quick, the quick table and the quick LU
comparison.

Each solve is held against the reference's own solve of the same
ipx_tpu.testgen instance (the reference tools' generators and instances)
on ipx_tpu's host path ("cpu"): the same status, pobjval within 1e-8
relative, and IPM iterations within 2 (the shared LU refactorizes on
measured time, ipxlu.cc need_fresh_impl, so iteration counts may differ
from run to run). Every --out goes to tmp_path, and the reference's
docs/*.tbl stay as they are. Without a card each tool's default device,
"cuda", makes it exit non-zero before any work."""
import json
import os
import subprocess
import sys

import pytest

import ipx_tpu
from ipx_tpu import testgen as ref_tg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import lu_update_compare  # noqa: E402
import results_table  # noqa: E402
import stress_sweep  # noqa: E402

OBJ_RTOL = 1e-8
ITER_TOL = 2
DEVICES = ("cpu", "torch_cpu")
TOOLS = {"stress": ("torch_stress_sweep.py", ["--quick", "--seeds", "0-0"]),
         "table": ("torch_results_table.py", ["--quick"]),
         "lu": ("torch_lu_update_compare.py", ["--quick"])}
REF_TABLES = ("RESULTS.tbl", "RESULTS_quick.tbl", "LU_UPDATE.tbl")


def run(tool, args, env=None):
    """(returncode, last line as JSON or None, stderr) of one tool."""
    out = subprocess.run([sys.executable, os.path.join("tools", tool)]
                         + args, cwd=REPO, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, **(env or {})))
    lines = out.stdout.strip().splitlines()
    last = json.loads(lines[-1]) if lines and lines[-1].startswith("{") \
        else None
    return out.returncode, last, out.stderr


def ref_solve(data, time_limit=None, **params):
    """(status, pobjval, iter) of ipx_tpu's host path on `data`."""
    p = ipx_tpu.Parameters(display=0, device="cpu", **params)
    if time_limit is not None:
        p.time_limit = time_limit
    s = ipx_tpu.LpSolver(p)
    assert ref_tg.load_into_solver(data, s) == 0
    status = s.solve()
    i = s.get_info()
    return status, i.pobjval, i.iter


def stress_ref(row):
    data = dict(stress_sweep.GENS)[row["gen"]](row["seed"])
    return ref_solve(data, **row["variant"])


def table_ref(row):
    data = dict(results_table.instances("quick"))[row["instance"]]
    assert (row["m"], row["n"], row["nnz"]) == (
        data["num_constr"], data["num_var"], int(data["Ap"][-1]))
    return ref_solve(data, time_limit=120.0)


def lu_ref(row):
    data = dict(lu_update_compare.instances(True))[row["instance"]]
    return ref_solve(data, lu_kernel={"pfi": 0, "ft": 1}[row["kern"]])


def stress_rows(line):
    want = [(name, 0, var) for name, _ in stress_sweep.GENS
            for var in stress_sweep.VARIANTS[:3]]
    assert [(r["gen"], r["seed"], r["variant"]) for r in line["rows"]] \
        == want
    assert line["total"] == len(want) and line["wall_s"] > 0
    for r in line["rows"]:
        assert r["highs_status"] == 0
        assert abs(r["pobjval"] - r["highs"]) <= 1e-6 * max(1.0,
                                                           abs(r["highs"]))
    return line["rows"], stress_ref, "pobjval"


def table_rows(line):
    assert [r["instance"] for r in line["rows"]] == [
        name for name, _ in results_table.instances("quick")]
    assert line["tier"] == "quick"
    for r in line["rows"]:
        assert r["relHiGHS"] <= 1e-6 and r["hg_time"] > 0
    with open(line["out"]) as f:
        text = f.read()
    assert "# card: cpu;" in text and f'device "{line["device"]}"' in text
    for r in line["rows"]:
        assert r["instance"] in text
    return line["rows"], table_ref, "objective"


def lu_rows(line):
    names = [name for name, _ in lu_update_compare.instances(True)]
    assert [(r["instance"], r["kern"]) for r in line["rows"]] == [
        (name, kern) for name in names for kern in ("pfi", "ft")]
    with open(line["out"]) as f:
        assert "# card: cpu;" in f.read()
    return line["rows"], lu_ref, "obj"


CHECK_ROWS = {"stress": stress_rows, "table": table_rows, "lu": lu_rows}


@pytest.fixture(scope="module")
def ref_cache():
    """The reference's solves, shared by the cpu and torch_cpu cases."""
    return {}


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("case", sorted(TOOLS))
def test_tool_matches_the_reference(case, device, tmp_path, ref_cache):
    before = {t: os.stat(os.path.join(REPO, "docs", t)).st_mtime_ns
              for t in REF_TABLES}
    tool, args = TOOLS[case]
    if case != "stress":
        args = args + ["--out", str(tmp_path / f"{case}.tbl")]
    rc, line, err = run(tool, args + ["--device", device])
    assert rc == 0, err[-3000:]
    assert line["failures"] == [] and line["device"] == device
    assert line["card"] == "cpu"
    assert {"OMP_NUM_THREADS", "blas_pools", "blas_in_solve"} <= set(line)
    if case != "stress":
        assert line["out"] == str(tmp_path / f"{case}.tbl")
    rows, ref, obj_key = CHECK_ROWS[case](line)
    for r in rows:
        key = json.dumps({k: r.get(k) for k in ("gen", "seed", "variant",
                                                  "instance", "kern")},
                         sort_keys=True)
        if key not in ref_cache:
            ref_cache[key] = ref(r)
        status, pobjval, iters = ref_cache[key]
        assert r["status"] == status == 1000, key
        assert abs(r[obj_key] - pobjval) <= OBJ_RTOL * abs(pobjval), key
        assert abs(r["iter"] - iters) <= ITER_TOL, key
        # no card here: no kernel launched
        assert r["launches"] == {}, key
    assert {t: os.stat(os.path.join(REPO, "docs", t)).st_mtime_ns
            for t in REF_TABLES} == before


@pytest.mark.parametrize("case", sorted(TOOLS))
def test_default_device_without_a_card_fails(case, tmp_path):
    """The default --device is "cuda": with the card hidden the tool raises
    before any work, prints no result and writes no table."""
    tool, args = TOOLS[case]
    out = tmp_path / "t.tbl"
    if case != "stress":
        args = args + ["--out", str(out)]
    rc, line, err = run(tool, args, env={"CUDA_VISIBLE_DEVICES": ""})
    assert rc != 0 and line is None
    assert "torch.cuda.is_available() is False" in err
    assert not out.exists()
