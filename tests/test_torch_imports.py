"""The port owns its host pipeline: no module of ipx_tpu_torch, neither
chip_smoke.py nor the port's thirteen tools (tools/torch_*.py:
torch_profile, torch_spans, torch_copy_rates, torch_trisolve_proto, the
measuring tools torch_bench,
torch_device_batch_solve_bench, torch_device_batched_bench,
torch_pipeline_e2e_bench, torch_batched_finish_bench and
torch_scaling_table, and the sweep tools torch_stress_sweep,
torch_results_table and torch_lu_update_compare), and no example of the
port (examples/torch_*.py) imports ipx_tpu, jax, jaxlib or the reference's
bench.py, and a whole run of the port's paths on the CPU loads none of them
and uses the native library built from ipx_tpu_torch/native/ipxlu.cc into
ipx_tpu_torch/_build/. The workers of a mesh (parallel/mesh.py) load none
of them either."""
import ast
import glob
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = {"ipx_tpu", "jax", "jaxlib", "bench"}


def _absolute_import_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_module_of_the_port_imports_the_reference_or_jax():
    """Every import statement, at any depth, of every .py under
    ipx_tpu_torch/, of chip_smoke.py, of the port's tools and of its
    examples."""
    paths = sorted(glob.glob(os.path.join(REPO, "ipx_tpu_torch", "**",
                                          "*.py"), recursive=True))
    for new in ("entry.py", "capi.py", "mps.py", "ops/trisolve.py"):
        assert os.path.join(REPO, "ipx_tpu_torch", new) in paths, new
    tools = sorted(glob.glob(os.path.join(REPO, "tools", "torch_*.py")))
    examples = sorted(glob.glob(os.path.join(REPO, "examples",
                                             "torch_*.py")))
    assert len(tools) == 13 and len(examples) == 7
    paths += [os.path.join(REPO, "chip_smoke.py")] + tools + examples
    assert len(paths) > 50
    bad = {os.path.relpath(p, REPO): sorted(_absolute_import_roots(p)
                                            & BANNED)
           for p in paths}
    assert not {p: r for p, r in bad.items() if r}


RUN = r'''
import importlib, os, pkgutil, sys, tempfile
sys.path.insert(0, "tests")
import numpy as np
import torch
import ipx_tpu_torch
for info in pkgutil.walk_packages(ipx_tpu_torch.__path__, "ipx_tpu_torch."):
    importlib.import_module(info.name)
from ipx_tpu_torch import LpSolver, Parameters, testgen
from ipx_tpu_torch.basis import lu
from ipx_tpu_torch.parallel import batch
from lp_fixtures import afiro

p = Parameters(display=0, device="torch_cpu")
s = LpSolver(p)
assert afiro().load_into(s) == 0 and s.solve() == 1000
info = s.get_info()
assert info.status_crossover == 1 and info.kktiter1 > 0
path = os.path.join(tempfile.mkdtemp(), "afiro.npz")
assert s.save_checkpoint(path) == 0
s2 = LpSolver(p)
assert afiro().load_into(s2) == 0 and s2.load_checkpoint(path) == 0
assert s2.solve() == 1000
assert abs(s2.get_info().objval - info.objval) <= 1e-9 * abs(info.objval)

data = testgen.transportation(10, 15, 0.3, seed=3)
b = data["rhs"][None, :] * np.array([[1.0], [1.02]])
sv = batch.BatchedScenarioSolver(data, b, parameters=p, phase2_polish=True)
assert [r[0] for r in sv.solve()] == [1000, 1000]
assert sv.polish is not None and sv.polish.total_cr_iters > 0

s3 = LpSolver(Parameters(display=0, device="torch_cpu", shards=2))
assert testgen.load_into_solver(testgen.transportation(20, 30, 0.2, 4),
                                s3) == 0
assert s3.solve() == 1000 and s3.model._sharded_cr[1].solves > 0

from ipx_tpu_torch import capi, entry, mps
from ipx_tpu_torch.ops import trisolve
step, (S,) = entry.entry(device="torch_cpu")
assert bool(torch.isfinite(step(S)["X"]).all())
T = trisolve.level_schedule(np.tril(np.ones((5, 5))) + 4 * np.eye(5), True,
                            device="cpu")
X = trisolve.level_solve(T, torch.ones((5, 3), dtype=torch.float64))
assert X.shape == (5, 3) and T.nlev == 5
h = capi.ipx_new()
capi.ipx_set_parameters(h, p)
a = afiro().arrays()
assert capi.ipx_load_model(h, a["num_var"], a["obj"], a["lb"], a["ub"],
                           a["num_constr"], a["Ap"], a["Ai"], a["Ax"],
                           a["rhs"], a["constr_type"]) == 0
assert capi.ipx_solve(h) == 1000
path = os.path.join(tempfile.mkdtemp(), "lp.mps")
with open(path, "w") as f:
    f.write("NAME T\nROWS\n N C\n L R\nCOLUMNS\n    X C 1.0 R 1.0\n"
            "RHS\n    B R 4.0\nENDATA\n")
assert mps.read_mps(path).num_var == 1

print("LOADED", sorted(m for m in sys.modules
                       if m.split(".")[0] in ("ipx_tpu", "jax", "jaxlib")))
print("LIB", lu._lib._name)
'''


def test_port_run_loads_no_reference_module():
    """In a fresh process: every module of the port imported, then afiro
    through crossover and a checkpoint round trip, a small batched stage
    with the polish, a shards=2 solve, entry()'s step, a level-scheduled
    sweep, afiro through the C API and an MPS file read, all on torch_cpu
    where there is a device. No module of
    ipx_tpu or jax is loaded, and the native library in use lies under
    ipx_tpu_torch/_build/."""
    out = subprocess.run([sys.executable, "-c", RUN], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines()
                 if line.startswith(("LOADED", "LIB")))
    assert lines["LOADED"] == "[]"
    assert lines["LIB"] == os.path.join(REPO, "ipx_tpu_torch", "_build",
                                        "libipxlu.so")


def test_both_native_libraries_in_one_process():
    """A process that imports both packages loads two distinct libipxlu.so
    files, each package its own, and each solves afiro to the same vertex."""
    import ipx_tpu
    import ipx_tpu_torch
    from ipx_tpu.basis import lu as ref_lu
    from ipx_tpu_torch.basis import lu as port_lu

    from lp_fixtures import afiro
    objvals = []
    for pkg in (ipx_tpu, ipx_tpu_torch):
        s = pkg.LpSolver(pkg.Parameters(display=0, device="cpu"))
        assert afiro().load_into(s) == 0 and s.solve() == 1000
        objvals.append(s.get_info().objval)
    ref_path, port_path = ref_lu._load_lib()._name, port_lu._load_lib()._name
    assert ref_path != port_path
    assert port_path == os.path.join(REPO, "ipx_tpu_torch", "_build",
                                     "libipxlu.so")
    assert os.path.dirname(ref_path) == os.path.join(REPO, "ipx_tpu",
                                                     "native")
    assert objvals[1] == pytest.approx(objvals[0], rel=1e-12)


MESH_RUN = r'''
import os, sys
import numpy as np
import scipy.sparse as sp
from ipx_tpu_torch.parallel import mesh as pm
from ipx_tpu_torch.parallel import sharding
from ipx_tpu_torch import entry

m = pm.make_row_mesh(2, "torch_cpu", timeout=60)
A = (sp.random(20, 30, density=0.3, format="csc", random_state=1)
     + sp.eye(20, 30)).tocsc()
y, it = sharding.sharded_cr_solve(
    sharding.ShardedNormalMatrix(A, 2, mesh=m), np.ones(30), np.ones(20),
    np.asarray((A.multiply(A)).sum(axis=1)).ravel() + 1.0, np.ones(20),
    1e-8, 200)
assert it > 0
s = entry._make_batched_solver(batch=8, device="torch_cpu")
out = m.reshape((2,), ("batch",)).step(s.lp, s._starting_point(), 50)
assert out["X"].shape[1] == 8
maps = [open(f"/proc/{p.pid}/maps").read() for p in m._ranks.procs]
print("WORKER", [sorted({line.split()[-1] for line in t.splitlines()
                         if "jaxlib" in line or "/ipx_tpu/" in line})
                 for t in maps])
m.close()
print("LOADED", sorted(k for k in sys.modules
                       if k.split(".")[0] in ("ipx_tpu", "jax", "jaxlib")))
'''


def test_mesh_workers_load_no_reference_module():
    """In a fresh process: a 2-rank mesh on the CPU runs a row-blocked CR
    solve and a batched step. Neither the process, which imported the
    workers' entry module (ipx_tpu_torch.parallel.mesh), nor a worker has
    loaded jax, jaxlib or ipx_tpu: no module of theirs in the process, no
    file of jaxlib or of ipx_tpu mapped into a worker."""
    out = subprocess.run([sys.executable, "-c", MESH_RUN], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines()
                 if line.startswith(("LOADED", "WORKER")))
    assert lines["LOADED"] == "[]"
    assert lines["WORKER"] == "[[]]"
