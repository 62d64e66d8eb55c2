"""chip_smoke.py's two checks that a run's readings decide, held here on
walls and profiler captures of the kind the card gave: phase 4's thread
guard (thread_guard, on each setting's median wall) and phase 10's count of
CUDA kernels a call (count_failures, over several captures). Neither
touches a card or imports torch."""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402


def runs(default, omp4, cpu):
    """Phase 4's walls: six "cuda" walls a setting, three "cpu" walls of the
    default setting (three under OMP_NUM_THREADS=4 beside them)."""
    return {"default": {"cuda": default, "cpu": cpu},
            "omp4": {"cuda": omp4, "cpu": cpu}}


def spread(lo, hi, k):
    return [lo + (hi - lo) * i / (k - 1) for i in range(k)]


# (walls, the bounds the guard must fail on)
GUARD_CASES = {
    # one fast OMP_NUM_THREADS=4 wall 13-15% under the next of its setting,
    # the medians within 2.3-3.5%: the best walls read 1.155x and 1.158x
    "one fast wall, 1.155x on the best": (runs(
        [1.460, 1.512, 1.530, 1.548, 1.561, 1.590],
        [1.264, 1.482, 1.490, 1.515, 1.540, 1.575],
        [1.330, 1.352, 1.371]), []),
    "one fast wall, 1.158x on the best": (runs(
        [1.427, 1.458, 1.470, 1.492, 1.505, 1.540],
        [1.232, 1.423, 1.430, 1.445, 1.470, 1.520],
        [1.301, 1.318, 1.344]), []),
    # the BLAS pools spinning against the native regions: the card path
    # 8.391-8.645 s, 1.685-1.839 s under OMP_NUM_THREADS=4, the host path
    # 4.671-4.846 s
    "pools contended": (runs(spread(8.391, 8.645, 6),
                             spread(1.685, 1.839, 6),
                             spread(4.671, 4.846, 3)),
                        [chip_smoke.OVER_OMP4, chip_smoke.OVER_CPU]),
    # the pools one thread per CPU under both settings (OPENBLAS_NUM_THREADS
    # = 8), on an H100's host of 8 CPUs
    "pools 8 wide in every solve": (runs(
        [9.123, 8.826, 8.614, 8.534, 8.565, 8.435],
        [6.158, 6.013, 6.449, 6.015, 6.308, 6.250],
        [5.150, 5.090, 4.889]), [chip_smoke.OVER_OMP4, chip_smoke.OVER_CPU]),
    # the card path above 1.5x the host path on the median, not above
    # 1.15x its time under OMP_NUM_THREADS=4
    "card slower than the host": (runs(
        [1.95, 2.01, 2.04, 2.06, 2.08, 2.30],
        [1.90, 1.96, 1.99, 2.02, 2.05, 2.11],
        [1.28, 1.31, 1.35]), [chip_smoke.OVER_CPU]),
    # one slow default wall and one fast host wall decide nothing
    "one slow card wall, one fast host wall": (runs(
        [1.40, 1.42, 1.44, 1.45, 1.47, 2.90],
        [1.38, 1.41, 1.43, 1.44, 1.46, 1.49],
        [0.70, 1.30, 1.33]), []),
}


@pytest.mark.parametrize("case", list(GUARD_CASES))
def test_thread_guard(case):
    walls, bounds = GUARD_CASES[case]
    failures = chip_smoke.thread_guard(walls)
    assert len(failures) == len(bounds), failures
    for msg, bound in zip(failures, bounds):
        assert f"above {bound}x" in msg


def test_thread_guard_prints_both_statistics():
    """The single fast wall that set the best-of ratio above 1.15x is in
    the printed ratios, beside the medians that decide."""
    walls = GUARD_CASES["one fast wall, 1.155x on the best"][0]
    r = chip_smoke.guard_ratios(walls)
    assert r["best"]["omp4"] == pytest.approx(1.460 / 1.264)
    assert r["best"]["omp4"] > chip_smoke.OVER_OMP4
    assert 1.023 <= r["median"]["omp4"] <= 1.035
    for k in walls:
        walls[k].update(team=8, blas=1, first=[1.7, 1.6, 1.65], cpus=8,
                        steal=0.0, iters={(24, 902, 217)})
    line = chip_smoke.guard_line(walls)
    assert f"best cuda at OMP_NUM_THREADS=4 {1.460 / 1.264:.3f}" in line
    assert f"median cuda at OMP_NUM_THREADS=4 {r['median']['omp4']:.3f}" \
        in line


@pytest.mark.parametrize("p", range(len(chip_smoke.PAIRS)))
def test_phase4_pairs(p):
    """The six processes start in turns (default, 4, 4, default, default,
    4), two at a time, and each pair's "cuda" walls are interleaved a b b a
    a b b a after a first solve of each, so that both settings share the
    host's load alike."""
    starts = [k for pair in chip_smoke.PAIRS for k in pair]
    assert starts == ["default", "omp4", "omp4", "default", "default",
                      "omp4"]
    cuda = [i for key, i in chip_smoke.SOLVES if key == "cuda"]
    assert cuda == [0, 1, 1, 0, 0, 1, 1, 0]
    assert chip_smoke.SOLVES[:2] == (("first", 0), ("first", 1))
    assert sorted(chip_smoke.SOLVES[-2:]) == [("cpu", 0), ("cpu", 1)]
    per = {k: sum(cuda.count(i) for pair in chip_smoke.PAIRS
                  for i, s in enumerate(pair) if s == k)
           for k in chip_smoke.SETTINGS}
    assert per == {"default": 12, "omp4": 12}
    assert set(chip_smoke.PAIRS[p]) == set(chip_smoke.SETTINGS)


# a worker that answers as WALLS does without solving: the wall is the
# count of its solves so far, the objval is afiro's, and it dies on "die"
FAKE_WORKER = r"""
import json, os, sys
print(json.dumps({"ready": True}), flush=True)
for n, line in enumerate(sys.stdin):
    if line.strip() == "die":
        sys.exit("the worker died")
    print(json.dumps({"st": 1000, "wall": float(n), "objval": -464.75,
                      "steal": 2, "iters": [n, 0, 0]}),
          flush=True)
print(json.dumps({"team": int(os.environ.get("OMP_NUM_THREADS", 8)),
                  "blas": 1, "cpus": 8}), flush=True)
"""


def test_phase4_runs_collects_each_worker(monkeypatch):
    monkeypatch.setattr(chip_smoke, "WALLS", FAKE_WORKER)
    monkeypatch.setattr(chip_smoke, "PAUSE", 0.0)
    monkeypatch.delenv("OMP_NUM_THREADS", raising=False)
    runs = chip_smoke.phase4_runs(-464.75)
    for k, team in (("default", 8), ("omp4", 4)):
        r = runs[k]
        assert (r["team"], r["blas"], r["cpus"]) == (team, 1, 8)
        assert r["first"] == [0.0] * 3
        assert sorted(r["cuda"]) == sorted([1.0, 2.0, 3.0, 4.0] * 3)
        assert r["cpu"] == [5.0] * 3
        assert r["iters"] == {(n, 0, 0) for n in (1, 2, 3, 4)}
        assert r["steal"] == pytest.approx(
            12 * 2 / os.sysconf("SC_CLK_TCK"))


@pytest.mark.parametrize("answer", ["die", "wrong objval"])
def test_phase4_runs_fails_on_a_worker(monkeypatch, answer):
    """A worker that dies, or a solve off the host's objval, stops the
    phase, and no worker is left running."""
    started = []

    class Worker(chip_smoke.Phase4Worker):
        def __init__(self, env, what):
            super().__init__(env, what)
            started.append(self.proc)

        def solve(self, device):
            return super().solve("die" if answer == "die" else device)

    monkeypatch.setattr(chip_smoke, "WALLS", FAKE_WORKER)
    monkeypatch.setattr(chip_smoke, "PAUSE", 0.0)
    monkeypatch.setattr(chip_smoke, "Phase4Worker", Worker)
    host = -464.75 if answer == "die" else -400.0
    with pytest.raises(SystemExit):
        chip_smoke.phase4_runs(host)
    assert len(started) == 2
    assert all(p.poll() is not None for p in started)


# (case, captures, expected count, passes)
COUNT_CASES = [
    ("sweep B=1024", [1, 0, 1, 1, 1], 1, True),
    ("sweep B=1024", [1, 2, 1, 1, 1], 1, False),
    ("sweep B=1024", [0, 0, 0, 0, 0], 1, False),
    ("K2 three", [3, 3, 0, 3, 3], 3, True),
    ("K2 three", [3, 2, 3, 3, 3], 3, False),
    ("per level B=1024", [37, 37, 37, 37, 37], 37, True),
    ("per level B=1024", [37, 1, 37, 37, 37], 37, False),
]


@pytest.mark.parametrize("case,captures,want,passes", COUNT_CASES)
def test_count_failures(case, captures, want, passes):
    expected = chip_smoke.one_launch_expected(want)
    expected[case] = want
    got = {k: [v] * len(captures) for k, v in expected.items()}
    got[case] = captures
    failures = chip_smoke.count_failures(got, expected)
    assert (failures == []) == passes, failures
    assert all(f.startswith(case) for f in failures)


def test_count_expects_every_case():
    """A case that the fresh process did not report fails, and the per-level
    form is expected at its levels, the one-launch forms at one."""
    expected = chip_smoke.one_launch_expected(24)
    assert expected == {"sweep B=1": 1, "sweep B=256": 1, "sweep B=1024": 1,
                        "K2 with its dot": 1, "K2 three": 3,
                        "per level B=1024": 24}
    got = {k: [v] * 5 for k, v in expected.items() if k != "K2 three"}
    assert chip_smoke.count_failures(got, expected) == [
        "K2 three: no capture recorded its kernels (captures [])"]
