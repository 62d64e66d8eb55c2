"""A rehearsal of a whole run on the CPU, at a size that no cell has: the
harness's functions end to end on "torch_cpu", untraced and traced; the
readers of the per-layer metrics on a traced record of the card's kind;
and run.py itself without a card."""
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


def card_record():
    """A traced record as the card gives it, at the 20k cell's sizes."""
    k6 = "void ipxt::normal_batched_kernel<float, 4>(long, long, ...)"
    k6d = "void ipxt::normal_batched_kernel<double, 2>(long, long, ...)"
    ca = "void ipxt::bcr_elem_kernel<float, 2>(ipxt::BcrArgs<float>)"
    pb = "void ipxt::bcr_elem_kernel<double, 4>(ipxt::BcrArgs<double>)"
    other = "void ipxt::bcr_lane_kernel<float, 3>(ipxt::BcrArgs<float>)"
    blk = "void ipxt::block_normal_batched_kernel<float, 4>(long, ...)"
    return dict(
        sizes=dict(m=20000, n=96002, nnz=192004, B=256), lanes=256,
        requests=[dict(construct_s=0.4, steps=12, trips=6792, finite=True),
                  dict(construct_s=0.5, steps=12, trips=6792, finite=True)],
        launches={"normal_apply_batched": 14272, "batched_cr_step": 56336},
        window_peak_bytes=6 * 2 ** 30,
        trace=dict(kernels=[(k6, 9648, 9648 * 130e-6),
                            (k6d, 4624, 4624 * 260e-6),
                            (ca, 9648, 9648 * 77e-6),
                            (pb, 4624, 4624 * 128e-6),
                            (other, 9648, 9648 * 6.4e-6),
                            (blk, 10, 1.0)],
                   busy_s=7.0, window_s=8.0, device_ops=[], idle_gaps=[]))


def test_every_reader_reads_a_card_record():
    import importlib
    from lpbench import yardstick
    rec = card_record()
    got = {}
    for m in bench()["per_layer"]:
        got[m["name"]] = importlib.import_module(
            f"lpbench.metrics.{m['name']}").read(rec)
        assert isinstance(got[m["name"]], float), m["name"]
    assert got["construct_s"] == pytest.approx(0.45)
    assert got["ipm_steps"] == 12 and got["cr_trips"] == 6792
    assert got["launches_per_trip"] == pytest.approx(70608 / 13584)
    assert got["idle_share"] == pytest.approx(12.5)
    assert got["peak_mem_gib"] == 6.0
    # K6: the fused launches alone (not the sharded block form), each
    # launch's least time over its device time
    b32 = yardstick.bound_s(yardstick.k6_bytes(20000, 96002, 192004, 256,
                                               "f32"))
    b64 = yardstick.bound_s(yardstick.k6_bytes(20000, 96002, 192004, 256,
                                               "f64"))
    assert got["k6_roofline"] == pytest.approx(
        100 * (9648 * b32 + 4624 * b64) / (9648 * 130e-6 + 4624 * 260e-6))
    ca = yardstick.bound_s(yardstick.k7_bytes(20000, 256, "f32")["kPassCA"])
    pb = yardstick.bound_s(yardstick.k7_bytes(20000, 256, "f64")["kPassB"])
    assert got["k7_roofline"] == pytest.approx(
        100 * (9648 * ca + 4624 * pb) / (9648 * 77e-6 + 4624 * 128e-6))


def test_readers_that_find_nothing_return_none():
    import importlib
    rec = dict(card_record(), trace=None, window_peak_bytes=None,
               launches={}, requests=[])
    for m in bench()["per_layer"]:
        assert importlib.import_module(
            f"lpbench.metrics.{m['name']}").read(rec) is None, m["name"]


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
