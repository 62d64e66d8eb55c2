"""The port's single-LP solve against the benchmark's plain reference of a
vertex (lpbench/reference/lp.py), on seeded instances on "torch_cpu": the
program's basic solution passes the certificate, its objective is the
reference IPM's within 1e-8, the control and each fault of
lpbench/readings_lp.py fail a limit of lpbench/limits/lp_solve.json, and
the benchmark's frozen staircase generator is the program's."""
import json
import os

import numpy as np
import pytest

from ipx_tpu_torch import testgen
from lpbench import readings_lp, run
from lpbench.entries.lp_solve import Entry, answer
from lpbench.generators import staircase
from lpbench.reference import lp as reference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2 ** 31 + 17
# (generator, its arguments, normal_blocks): a tiny transportation LP
# ('<' and '>' rows) and a tiny staircase ('=' rows, 6 periods of 30 rows)
CONFIGS = {
    "transportation": ("transportation", dict(num_sources=30, num_sinks=45,
                                              density=0.3, seed=1), None),
    "staircase": ("staircase", dict(num_periods=6, vars_per_period=60,
                                    seed=1), 30)}


def limits():
    with open(os.path.join(ROOT, "lpbench", "limits", "lp_solve.json")) as f:
        return json.load(f)


def entry(name):
    gen, args, blocks = CONFIGS[name]
    with open(os.path.join(ROOT, "lpbench", "traffic", "single.json")) as f:
        traffic = json.load(f)
    return Entry(dict(generator=gen, args=args, sizes={},
                      normal_blocks=blocks), traffic, SEED, "torch_cpu")


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def solved(request):
    """(entry, [(solver, answer, reference solve)] for each pool member)."""
    e = entry(request.param)
    members = []
    for j in range(e.pass_len):
        s = e.solver(j)
        members.append((s, answer(s), e.reference(j)))
    return e, members


def test_the_program_passes_the_certificate(solved):
    e, members = solved
    for j, (s, out, ref) in enumerate(members):
        readings = e.judge(j, out, ref)
        ok, lines = run.judge_readings(readings, limits())
        assert ok, lines
        assert readings["off_vertex"] == 0
        assert readings["obj_rel"] <= 1e-8
        assert abs(readings["obj"] - s.get_info().objval) \
            <= 1e-12 * (1 + abs(readings["obj"]))


def test_the_control_and_each_fault_fail(solved):
    e, members = solved
    for j, (s, out, ref) in enumerate(members):
        other = members[(j + 1) % len(members)][1]
        wrong = dict(faults(e, out, readings_lp.interior(s, out), other),
                     control=readings_lp.control(out))
        for name, got in wrong.items():
            ok, lines = run.judge_readings(e.judge(j, got, ref), limits())
            assert not ok, (j, name, lines)


def faults(e, out, interior, other):
    lb, ub = (np.asarray(e.data[k], dtype=np.float64) for k in ("lb", "ub"))
    return readings_lp.faults(out, lb, ub, interior, other)


def test_a_basic_past_its_bound_fails_bound_viol(solved):
    """The fault that moves a basic x 1e-6 (1 + |bound|) past its nearest
    finite bound reads that distance on bound_viol, over its limit."""
    e, members = solved
    limit = limits()["bound_viol"]
    for j, (s, out, ref) in enumerate(members):
        got = faults(e, out, out, out)["basic_past_bound"]
        r = e.judge(j, got, ref)
        assert r["bound_viol"] >= 1e-6 > limit, (j, r["bound_viol"])


def test_the_sound_answer_reads_zero_off_a_vertex(solved):
    """The corrected basic solution sits on its bounds exactly: every
    number but the residuals and obj_rel reads 0."""
    e, members = solved
    for j, (_, out, ref) in enumerate(members):
        r = e.judge(j, out, ref)
        assert r["bound_viol"] == r["compl"] == r["off_vertex"] == 0


def test_the_blocked_reference_is_the_whole_one():
    d = staircase.make(6, 60, seed=1)
    c = np.asarray(d["obj"])
    whole = reference.solve(reference.Lp(d, c), None)
    blocked = reference.solve(reference.Lp(d, c), 30)
    assert abs(whole["obj"] - blocked["obj"]) <= 1e-9 * abs(whole["obj"])
    for r in (whole, blocked):
        assert max(r["gap"], r["primal_inf"], r["dual_inf"]) <= reference.TOL


def test_blocks_that_do_not_fit_are_refused():
    d = staircase.make(6, 60, seed=1)
    K = reference.standard_form(reference.Lp(d, d["obj"]))[0]
    with pytest.raises(ValueError, match="block tridiagonal"):
        reference.Normal(K, 10, "cpu")
    with pytest.raises(ValueError, match="whole number"):
        reference.Normal(K, 40, "cpu")


@pytest.mark.parametrize("args", [(6, 60, 4, 1), (3, 20, 2, 5),
                                  (120, 1500, 4, 1)])
def test_the_staircase_generator_is_the_programs(args):
    got, want = staircase.make(*args), testgen.staircase(*args)
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k
    if args[0] == 120:
        assert (got["num_constr"], got["num_var"], len(got["Ax"])) \
            == (90000, 180000, 450629)


def test_the_probe_prints_a_line_a_solve(monkeypatch, capsys):
    """lpbench/probe_lp.py at a tiny staircase: one line a solve of the
    member, its counters equal to Info's, the CPU accounting beside them."""
    from lpbench import probe_lp
    gen, args, blocks = CONFIGS["staircase"]
    with open(os.path.join(ROOT, "lpbench", "traffic", "single.json")) as f:
        traffic = json.load(f)
    config = dict(generator=gen, args=args, sizes={}, normal_blocks=blocks)
    monkeypatch.setattr(run, "cell_of",
                        lambda bench, name: dict(config=config,
                                                 traffic=traffic))
    assert probe_lp.main(["--workload", "tiny", "--solves", "2",
                          "--member", "1", "--device", "torch_cpu"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [(x["solve"], x["member"]) for x in lines] == [(0, 1), (1, 1)]
    for x in lines:
        counts, info = x["trace"]["counts"], x["info"]
        assert info["status"] == 1000
        assert (counts["kkt1_trips"], counts["kkt2_trips"],
                counts["basis_updates"]) == (info["kktiter1"],
                                             info["kktiter2"],
                                             info["updates_ipm"])
        assert set(x["process"]) == {"user", "system", "vcsw", "ivcsw"}
        assert set(x["machine"]) == {"busy", "idle", "steal"}
