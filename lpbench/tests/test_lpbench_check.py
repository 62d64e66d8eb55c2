"""The check that decides `correct` fails where it has to: the control (the
plain reference one precision below the configuration's, put in the
program's place) and each fault that the cell can have, planted under a
whole run of the harness. At a size a test run holds; on the card the same
readings come at the cells' own sizes from lpbench/readings.py (PERF.md).
"""
import numpy as np
import pytest
import torch

from _tiny import SEED, tiny_cell


def judged(cell, got_of, device="torch_cpu"):
    """The check's verdict on the answer got_of(entry) gives for pool
    batch 0 of the tiny cell."""
    from lpbench import run
    from lpbench.entries.batched_phase1 import Entry
    entry = Entry(cell["config"], cell["traffic"], SEED, device)
    readings = entry.check_draw(0, got_of(entry))
    return run.judge_readings(readings, cell["limits"])[0], readings


@pytest.mark.parametrize("device", ["torch_cpu",
                                    pytest.param("cuda",
                                                 marks=pytest.mark.cuda)])
def test_the_control_fails(device, request):
    if device == "cuda":
        request.getfixturevalue("card")
    cell = tiny_cell()
    sound, _ = judged(cell, lambda e: e.solve_draw(0)[0], device)
    assert sound
    ok, readings = judged(
        cell, lambda e: e.reference(0, dtype=torch.float32).run()[0], device)
    assert not ok
    # the float32 state breaks the residuals' exact recurrences
    assert readings["bound_res"] > cell["limits"]["bound_res"] or \
        readings["dual_res"] > cell["limits"]["dual_res"]


def unchanged(*args, **kw):
    """K9 that returns the state unchanged."""


def half_left_out(solve):
    def broken(self, *args, **kw):
        out = solve(self, *args, **kw)
        B = out["X"].shape[1]
        for k in ("X", "XL", "XU", "Y", "ZL", "ZU"):
            out[k][:, B // 2:] = out[k][:, :B // 2].mean(axis=1,
                                                         keepdims=True)
        return out
    return broken


def altered(solve):
    def broken(self, *args, **kw):
        out = solve(self, *args, **kw)
        i = int(np.argmax(np.abs(out["X"][:, 0])))
        out["X"][i, 0] *= 1.0 + 1e-6
        return out
    return broken


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered",
                                   "frozen_dual"])
def test_a_run_with_a_fault_is_not_correct(fault, monkeypatch):
    from lpbench import readings, run
    from ipx_tpu_torch.parallel.batch import BatchedPhase1Solver as S
    if fault == "unchanged":
        monkeypatch.setattr(S, "ipm_update", staticmethod(unchanged))
    elif fault == "frozen_dual":
        # K9 writing the primal part alone: only mu_ratio, the number
        # taken against the reference's run, can see it
        monkeypatch.setattr(S, "ipm_update",
                            staticmethod(readings.frozen_dual(S.ipm_update)))
    else:
        wrap = half_left_out if fault == "half" else altered
        monkeypatch.setattr(S, "solve", wrap(S.solve))
    result, lines = run.run_cell(tiny_cell(), SEED, 0.3, False, "torch_cpu")
    assert result["correct"] is False
    failed = [line.split()[1] for line in lines if line.endswith("FAILED")]
    assert failed
    if fault == "frozen_dual":
        assert failed == ["mu_ratio"], lines


def test_the_faults_of_readings_py_fail():
    """The faults that readings.py plants on the card, judged here."""
    from lpbench import readings, run
    from lpbench.entries.batched_phase1 import Entry
    from lpbench.reference.judge import judge
    from lpbench.reference.stage import host
    cell = tiny_cell()
    entry = Entry(cell["config"], cell["traffic"], SEED, "torch_cpu")
    ref = entry.reference(0)
    own, _ = ref.run()
    assert run.judge_readings(judge(ref, own, own), cell["limits"])[0]
    for name, got in readings.faults(own, host(ref.start())).items():
        ok, r = run.judge_readings(judge(ref, got, own), cell["limits"])
        assert not ok, (name, r)
