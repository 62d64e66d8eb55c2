"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
references load nothing of the program: each in a fresh process, top-level
module names compared whole (the port's name begins with the JAX
package's). The harness's case imports every entry that a traffic mix
names, the references' case every module under lpbench/reference/."""
import json
import os
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "ipx_tpu"}

HARNESS = r"""
import glob, importlib, json, os, sys
sys.path.insert(0, {root!r})
from lpbench import run, tracing, yardstick
from lpbench.entries import batched_phase1
bench = run.load_benchmark()
cell = run.cell_of(bench, "transport20k.b256")
config = json.load(open({tiny!r}))
entry = batched_phase1.Entry(config, dict(cell["traffic"], lanes=4,
                                          pool=2), 5, "torch_cpu")
entry.warm_up()
for m in bench["per_layer"]:
    importlib.import_module("lpbench.metrics." + m["name"])
# every entry that some traffic mix names
for path in sorted(glob.glob(os.path.join({root!r}, "lpbench", "traffic",
                                          "*.json"))):
    with open(path) as f:
        importlib.import_module("lpbench.entries." + json.load(f)["entry"])
print(json.dumps(sorted({{k.split(".")[0] for k in sys.modules}})))
"""

REFERENCE = r"""
import importlib, json, pkgutil, sys
sys.path.insert(0, {root!r})
import lpbench.reference
# every module of the plain references, those of later entries too
for info in pkgutil.walk_packages(lpbench.reference.__path__,
                                  "lpbench.reference."):
    importlib.import_module(info.name)
from lpbench.reference import judge, stage
from lpbench.generators import transportation
from lpbench import yardstick
data = transportation.make(30, 45, 0.3, 1)
A, b, c, lb, ub = yardstick.stage_lp(
    data, transportation.scenarios(data, 30, 4, seed=1, request=0))
ref = stage.Phase1(A, b, c, lb, ub, feasibility_tol=1e-4,
                   optimality_tol=1e-4, maxiter=3)
own, at = ref.run(2)
judge.judge(ref, own, at)
print(json.dumps(sorted({{k.split(".")[0] for k in sys.modules}})))
"""


def loaded(code: str) -> set:
    tiny = os.path.join(ROOT, "lpbench", "tests", "data", "tiny.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c",
                          code.format(root=ROOT, tiny=tiny)],
                         capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    names = loaded(HARNESS)
    assert "ipx_tpu_torch" in names and "lpbench" in names
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    names = loaded(REFERENCE)
    assert "torch" in names
    assert not names & (FORBIDDEN | {"ipx_tpu_torch"})
