"""A configuration, a traffic mix and a per-layer metric are added as new
files and new entries of BENCHMARK.json alone, in a temporary copy of the
benchmark: a run of the new cell reports the new metric, and no file that
was there changes."""
import filecmp
import json
import os
import shutil
import subprocess
import sys

from conftest import ROOT
from _tiny import SEED, TINY

METRIC = '''"""throwaway_trips: the CR trips of the window's requests, summed."""


def read(record):
    return float(sum(r["trips"] for r in record["requests"])) or None
'''

RUN = r"""
import json, sys
sys.path.insert(0, ".")
from lpbench import run
cell = run.cell_of(run.load_benchmark(), "tiny.b4")
result, lines = run.run_cell(cell, {seed}, 0.3, True, "torch_cpu")
print(json.dumps(result))
"""


def test_a_cell_and_a_metric_added_as_files(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "lpbench"), tmp_path / "lpbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = tmp_path / "before"
    shutil.copytree(tmp_path / "lpbench", before)
    lp = tmp_path / "lpbench"
    shutil.copy(TINY, lp / "configs" / "tiny.json")
    (lp / "traffic" / "b4.json").write_text(json.dumps(dict(
        entry="batched_phase1", lanes=4, loop="closed", pool=2, pool_seed=3,
        why="four lanes")))
    (lp / "metrics" / "throwaway_trips.py").write_text(METRIC)
    with open(tmp_path / "BENCHMARK.json") as f:
        bench = json.load(f)
    bench["configs"].append(dict(name="tiny", source="a test",
                                 file="lpbench/configs/tiny.json",
                                 reduced=[], why="a test"))
    bench["workloads"].append(dict(name="tiny.b4", config="tiny",
                                   traffic="b4", chips=1, why="a test"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("tiny.b4")
    bench["per_layer"].append(dict(
        name="throwaway_trips", unit="trips", better="lower",
        source="program_counter", layer="stage", moves="scen_per_s",
        workloads=["tiny.b4"]))
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", RUN.format(seed=SEED)],
                         capture_output=True, text=True, cwd=tmp_path,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["metrics"]["throwaway_trips"]["value"] > 0
    assert result["metrics"]["throwaway_trips"]["unit"] == "trips"
    # every file that was there is as it was
    cmp = filecmp.dircmp(before, tmp_path / "lpbench",
                         ignore=["__pycache__"])

    def changed(c):
        return c.diff_files + c.left_only + [
            f for sub in c.subdirs.values() for f in changed(sub)]
    assert changed(cmp) == []
