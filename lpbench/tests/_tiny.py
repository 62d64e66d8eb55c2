"""The CPU rehearsal's cell: a tiny transportation LP that no workload of
BENCHMARK.json names, run on "torch_cpu" with the plain versions."""
import json
import os

from conftest import ROOT

TINY = os.path.join(ROOT, "lpbench", "tests", "data", "tiny.json")
SEED = 2 ** 31 + 17       # larger than 32 signed bits hold


def tiny_cell(lanes: int = 4):
    from lpbench import run
    cell = run.cell_of(run.load_benchmark(), "transport20k.b256")
    with open(TINY) as f:
        config = json.load(f)
    return dict(cell, name="tiny", config=config,
                traffic=dict(cell["traffic"], lanes=lanes, pool=3))
