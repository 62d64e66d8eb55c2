"""BENCHMARK.json against the contract's rules of form: names and units of
the allowed characters, the files it names there, each per-layer metric
moving one end-to-end metric that every cell it lists reports."""
import json
import os
import re

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_command():
    b = bench()
    assert list(b) == ["command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"]
    assert b["command"] == ["python3", "lpbench/run.py"]
    assert b["paths"] == ["lpbench"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536


def test_names_and_units():
    b = bench()
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in b[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            for key in ("why", "layer", "source"):
                if key in e:
                    assert TEXT.match(e[key]), (e["name"], key)
            if "unit" in e:
                assert UNIT.match(e["unit"]), (e["name"], e["unit"])
                assert e["better"] in ("lower", "higher")
    for group in ("configs", "workloads"):
        assert len({e["name"] for e in b[group]}) == len(b[group])
    metrics = [e["name"] for e in b["end_to_end"] + b["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for w in b["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    for c in b["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])


def test_entries_have_just_their_keys():
    b = bench()
    assert all(set(c) == {"name", "source", "file", "reduced", "why"}
               for c in b["configs"])
    assert all(set(w) == {"name", "config", "traffic", "chips", "why"}
               for w in b["workloads"])
    e2e = {"name", "unit", "better", "bound", "source"}
    assert all(set(m) - {"workloads"} == e2e for m in b["end_to_end"])
    pl = {"name", "unit", "better", "source", "layer", "moves"}
    assert all(set(m) - {"workloads"} == pl for m in b["per_layer"])
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_metric_moves_one_that_its_cells_report():
    b = bench()
    cells = [w["name"] for w in b["workloads"]]
    e2e = {m["name"]: m.get("workloads", cells) for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["per_layer"]:
        assert isinstance(m["moves"], str) and m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells and cell in e2e[m["moves"]], (m["name"],
                                                                cell)
    for cell in cells:
        mine = [n for n, ws in e2e.items() if cell in ws]
        assert "setup_s" in mine and len(mine) >= 2
        assert any(cell in m.get("workloads", cells) for m in b["per_layer"])
    layers = {}
    for m in b["per_layer"]:
        assert m["moves"] == "scen_per_s"
        layers.setdefault(m["layer"], []).append(m["name"])


def test_files_are_where_the_names_say():
    b = bench()
    used = {w["config"] for w in b["workloads"]}
    files = [c["file"] for c in b["configs"]]
    assert len(set(files)) == len(files)
    for c in b["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("lpbench/")
        with open(os.path.join(ROOT, c["file"])) as f:
            config = json.load(f)
        assert config["reduced"] == c["reduced"]
        assert config["source"] == c["source"]
    for w in b["workloads"]:
        with open(os.path.join(ROOT, "lpbench", "traffic",
                               f"{w['traffic']}.json")) as f:
            traffic = json.load(f)
        assert os.path.exists(os.path.join(
            ROOT, "lpbench", "entries", f"{traffic['entry']}.py"))
        assert os.path.exists(os.path.join(
            ROOT, "lpbench", "limits", f"{traffic['entry']}.json"))
    for m in b["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, "lpbench", "metrics",
                                           f"{m['name']}.py"))


@pytest.mark.parametrize("path", ["lpbench/run.py", "lpbench/readings.py"])
def test_the_command_stays_inside_the_checkout(path):
    text = open(os.path.join(ROOT, path)).read()
    assert "/root" not in text and "/tmp" not in text
