"""A rehearsal of a whole run on the CPU, at a size that no cell has: the
harness's functions end to end on "torch_cpu", untraced and traced; the
readers of the per-layer metrics, each on a traced record of the card's
kind from the entry its cells run (lpbench/tests/records/<entry>.py); and
run.py itself without a card."""
import importlib.util
import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT
from _tiny import SEED, tiny_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("trace", [False, True])
def test_a_run_on_the_cpu(trace):
    from lpbench import run
    cell = tiny_cell()
    result, lines = run.run_cell(cell, SEED, 0.5, trace, "torch_cpu")
    keys = list(result)
    assert keys[:5] == KEYS and keys[-1] == "check"
    assert ("breakdown" in result) == trace
    assert result["correct"] is True, lines
    assert result["attempted"] >= 1 and result["failed"] == 0
    units = {m["name"]: m["unit"] for m in bench()["end_to_end"]
             + bench()["per_layer"]}
    for name, m in result["metrics"].items():
        assert m["unit"] == units[name]
        assert isinstance(m["value"], float) and m["value"] > 0
    if trace:
        # on the CPU the device's metrics have nothing to read
        assert set(result["metrics"]) == {"construct_s", "ipm_steps",
                                          "cr_trips"}
        assert result["device"]["window_s"] > 0
    else:
        assert set(result["metrics"]) == {"scen_per_s", "setup_s"}
    assert set(result["check"]) == set(cell["limits"])
    for name, c in result["check"].items():
        assert c["value"] <= c["limit"], name
    judged = lines[-len(cell["limits"]):]
    assert [line.split()[1] for line in judged] == list(cell["limits"])
    assert all(line.endswith(" ok") for line in judged)


def metrics_by_entry() -> dict:
    """{entry: the per-layer metrics whose cells run it}: each metric's
    cells (its `workloads`, else every cell), each through its traffic file
    (lpbench/traffic/<traffic>.json) to the entry that file names."""
    b = bench()
    cells = {w["name"]: w for w in b["workloads"]}
    out = {}
    for m in b["per_layer"]:
        for cell in m.get("workloads", list(cells)):
            with open(os.path.join(ROOT, "lpbench", "traffic",
                                   f"{cells[cell]['traffic']}.json")) as f:
                names = out.setdefault(json.load(f)["entry"], [])
            if m["name"] not in names:
                names.append(m["name"])
    return out


def record_of(entry: str):
    """lpbench/tests/records/<entry>.py: a traced record of the entry as the
    card gives it (card_record()) and what each reader reads on it
    (expected())."""
    rel = f"lpbench/tests/records/{entry}.py"
    path = os.path.join(ROOT, *rel.split("/"))
    if not os.path.exists(path):
        pytest.fail(f"the cells of entry {entry!r} have per-layer metrics "
                    f"but no card record: add {rel}, with card_record() and "
                    f"expected() as lpbench/tests/records/batched_phase1.py "
                    f"has them")
    spec = importlib.util.spec_from_file_location(f"card_record_{entry}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read(names, record) -> dict:
    return {name: importlib.import_module(f"lpbench.metrics.{name}").read(
        record) for name in names}


@pytest.mark.parametrize("entry", sorted(metrics_by_entry()))
def test_every_reader_reads_a_card_record(entry):
    names = metrics_by_entry()[entry]
    record = record_of(entry)
    got = read(names, record.card_record())
    for name in names:
        assert isinstance(got[name], float), name
    for name, want in record.expected().items():
        assert name in got, name
        assert got[name] == want, name


@pytest.mark.parametrize("entry", sorted(metrics_by_entry()))
def test_readers_that_find_nothing_return_none(entry):
    rec = dict(record_of(entry).card_record(), trace=None,
               window_peak_bytes=None, launches={}, requests=[])
    for name, value in read(metrics_by_entry()[entry], rec).items():
        assert value is None, name


def test_run_py_needs_a_card(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "lpbench/run.py", "--workload", "transport20k.b256",
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert out.returncode != 0
    assert "correct" not in out.stdout


def test_run_py_needs_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, a run ends non-zero and prints no result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "lpbench"), tmp_path / "lpbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.argv[1:] = ['--workload', 'transport20k.b256', "
         "'--seed', '3', '--seconds', '1'];"
         "sys.path.insert(0, '.'); from lpbench import run;"
         "cell = run.cell_of(run.load_benchmark(), 'transport20k.b256');"
         "run.run_cell(cell, 3, 1.0, False, 'torch_cpu')"],
        capture_output=True, text=True, cwd=tmp_path, env=env, timeout=120)
    assert out.returncode != 0
    assert "ipx_tpu_torch" in out.stderr
    assert "correct" not in out.stdout


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    """The port's name begins with the JAX package's: only whole top-level
    names count."""
    import types
    from lpbench import run
    for name in list(sys.modules):
        if name.split(".")[0] in run.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    for name in ("ipx_tpu_torch", "ipx_tpu_torch.kernels", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "ipx_tpu.sparse",
                        types.ModuleType("ipx_tpu.sparse"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    assert run.forbidden_modules() == ["ipx_tpu", "jaxlib"]
