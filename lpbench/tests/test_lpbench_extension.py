"""Cells, entries and per-layer metrics are added as new files and new
entries of BENCHMARK.json alone, in a temporary copy of the benchmark, and
no file that was there changes: a cell of the entry the benchmark has, with
a metric that reads what its requests already carry; and a cell of a new
entry, with its traffic, limits, card record and a metric that reads what
only the new entry's requests carry, under the benchmark's own schema and
reader tests."""
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
cell = run.cell_of(run.load_benchmark(), "{cell}")
result, lines = run.run_cell(cell, {seed}, 0.3, True, "torch_cpu")
print(json.dumps(result))
"""

ENTRY = '''"""throwaway: entries/batched_phase1.py, each request's info
with the lanes that the stage marked done."""
import numpy as np

from lpbench.entries import batched_phase1


class Entry(batched_phase1.Entry):
    def serve(self, i):
        out, info = super().serve(i)
        done = int(np.count_nonzero(out["done"]))
        return out, dict(info, lanes_done=done)
'''

DONE = '''"""throwaway_done: the mean over requests of the lanes marked
done."""
from ._common import mean


def read(record):
    return mean(record, "lanes_done")
'''

RECORD = '''"""The card record of the entry `throwaway`."""


def card_record():
    return dict(sizes=dict(m=75, n=390, nnz=780, B=4), lanes=4,
                requests=[dict(construct_s=0.1, steps=9, trips=300,
                               lanes_done=3, finite=True),
                          dict(construct_s=0.1, steps=9, trips=300,
                               lanes_done=4, finite=True)],
                launches={"batched_cr_step": 3000},
                window_peak_bytes=2 ** 20, trace=None)


def expected():
    return dict(throwaway_done=3.5)
'''

TESTS = ["lpbench/tests/test_lpbench_schema.py",
         "lpbench/tests/test_lpbench_rehearsal.py",
         "-k", "schema or reads_a_card_record or find_nothing"]


def copy_of(tmp_path):
    """(a copy of BENCHMARK.json and lpbench/ in tmp_path, a second copy of
    lpbench/ to compare with, the copy's BENCHMARK.json loaded)."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "lpbench"), tmp_path / "lpbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = tmp_path / "before"
    shutil.copytree(tmp_path / "lpbench", before)
    shutil.copy(TINY, tmp_path / "lpbench" / "configs" / "tiny.json")
    with open(tmp_path / "BENCHMARK.json") as f:
        return tmp_path / "lpbench", before, json.load(f)


def run_in(tmp_path, args, timeout=300):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable] + args, capture_output=True,
                          text=True, cwd=tmp_path, env=env, timeout=timeout)


def run_cell(tmp_path, cell):
    out = run_in(tmp_path, ["-c", RUN.format(cell=cell, seed=SEED)])
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def changed(before, after):
    """The files of `before` that differ in `after` or are gone from it."""
    def walk(c):
        return c.diff_files + c.left_only + [
            f for sub in c.subdirs.values() for f in walk(sub)]
    return walk(filecmp.dircmp(before, after, ignore=["__pycache__"]))


def test_a_cell_and_a_metric_added_as_files(tmp_path):
    lp, before, bench = copy_of(tmp_path)
    (lp / "traffic" / "b4.json").write_text(json.dumps(dict(
        entry="batched_phase1", lanes=4, loop="closed", pool=2, pool_seed=3,
        why="four lanes")))
    (lp / "metrics" / "throwaway_trips.py").write_text(METRIC)
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
    result = run_cell(tmp_path, "tiny.b4")
    assert result["correct"] is True
    assert result["metrics"]["throwaway_trips"]["value"] > 0
    assert result["metrics"]["throwaway_trips"]["unit"] == "trips"
    assert changed(before, lp) == []


def test_a_cell_of_a_new_entry_added_as_files(tmp_path):
    lp, before, bench = copy_of(tmp_path)
    (lp / "entries" / "throwaway.py").write_text(ENTRY)
    (lp / "traffic" / "t4.json").write_text(json.dumps(dict(
        entry="throwaway", lanes=4, loop="closed", pool=2, pool_seed=3,
        why="four lanes through a new entry")))
    shutil.copy(lp / "limits" / "batched_phase1.json",
                lp / "limits" / "throwaway.json")
    (lp / "tests" / "records" / "throwaway.py").write_text(RECORD)
    (lp / "metrics" / "throwaway_done.py").write_text(DONE)
    with open(TINY) as f:
        tiny = json.load(f)
    # new entries only: no list of BENCHMARK.json that was there grows
    bench["configs"].append(dict(name="tiny", source=tiny["source"],
                                 file="lpbench/configs/tiny.json",
                                 reduced=[], why="a test"))
    bench["workloads"].append(dict(name="tiny.t4", config="tiny",
                                   traffic="t4", chips=1, why="a test"))
    bench["per_layer"].append(dict(
        name="throwaway_done", unit="lanes", better="higher",
        source="program_counter", layer="stage", moves="scen_per_s",
        workloads=["tiny.t4"]))
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    result = run_cell(tmp_path, "tiny.t4")
    assert result["correct"] is True
    assert 0 < result["metrics"]["throwaway_done"]["value"] <= 4
    assert result["metrics"]["throwaway_done"]["unit"] == "lanes"
    out = run_in(tmp_path, ["-m", "pytest", "-v", "-p", "no:cacheprovider"]
                 + TESTS)
    assert out.returncode == 0, out.stdout[-3000:]
    for entry in ("batched_phase1", "throwaway"):
        for test in ("reads_a_card_record", "find_nothing_return_none"):
            assert f"{test}[{entry}] PASSED" in out.stdout, (entry, test)
    assert changed(before, lp) == []
    # without its card record the new entry's metric fails the reader test,
    # naming the file to add
    os.remove(lp / "tests" / "records" / "throwaway.py")
    out = run_in(tmp_path, ["-m", "pytest", "-q", "-p", "no:cacheprovider",
                            "lpbench/tests/test_lpbench_rehearsal.py", "-k",
                            "reads_a_card_record"])
    assert out.returncode != 0
    assert "add lpbench/tests/records/throwaway.py" in out.stdout
