"""Where the time of an ipx_tpu_torch solve goes, on one NVIDIA card.

Usage, from the repository root on a machine with the card:

    python tools/torch_profile.py [--what e2e,native,kernels,busy,...]
                                  [--turns 2] [--seed 0]

OpenMP reads its environment once, at start-up, so a thread setting is
compared by running the script once per setting, for example

    for e in OMP_PROC_BIND=spread OMP_NUM_THREADS=4 OMP_NUM_THREADS=1 \\
             OMP_WAIT_POLICY=passive; do
        env $e python tools/torch_profile.py --what e2e; done

Every part solves transportation(8000, 12000, 0.001, seed=1), the instance
of chip_smoke.py phase 4, and prints one line per measurement, each ending
with the card's nvidia-smi name and power limit:

  e2e      the port (device="cuda") and the host path (device="cpu") in
           turns, `--turns` solves each: wall time, Info's phase times and
           the iteration counts, with the OpenMP settings in force, and for
           "cuda" the launches of K3's cooperative solve (one an inner CR
           solve), the K2 applies it ran inside and K2's launches alone;
  native   milliseconds per call of the native vector kernels of
           ipx_tpu_torch/native (ipxlu.cc) inside one port solve and one host
           solve, and the 25 functions with the most time of their own and
           in all, from cProfile;
  threads  e2e in a fresh process per thread setting, in turns: the
           default (LpSolver.solve runs numpy's and scipy's OpenBLAS pools
           on one thread, native/threads.py; OpenMP's own team), the pools
           left at one per CPU (OPENBLAS_NUM_THREADS set to the CPUs), and
           OpenMP teams of 4 and 2 with the pools at one thread
           (OMP_NUM_THREADS, OPENBLAS_NUM_THREADS=1), then OMP_NUM_THREADS
           1 and 4 alone (the pools at as many);
  precision  the "cuda" solve with Parameters.precision "mixed" and "f64"
           in turns (the mixed and the f64 device CR of phase 1);
  walls    chip_smoke.py phase 4's walls and thread guard as chip_smoke
           runs them, `--turns` times: the walls, the ratios of the median
           and of the best walls, and the guard's failures;
  binding  chip_smoke.py phase 4's walls and thread guard `--turns`
           times each, in turns, with the workers' OpenMP binding as they
           inherit it from chip_smoke (OMP_PROC_BIND=spread, set by the
           port on import) and with OMP_PROC_BIND=false;
  guard    chip_smoke.py phase 4's walls and thread guard with the
           OpenBLAS pools one thread per CPU in every solve
           (OPENBLAS_NUM_THREADS set to the CPUs, which the package leaves
           as it is): the fault the guard exists for; the walls, the
           ratios of the median and of the best walls, and the guard's
           failures;
  counts   chip_smoke.py phase 10's count of CUDA kernels a call in
           `--runs` fresh processes of each form, in turns: one profiler
           capture a case closed right after the call, chip_smoke.CAPTURES
           such captures, and chip_smoke.CAPTURES captures open
           chip_smoke.MARGIN s on either side (chip_smoke's form): the
           captures that lost the call's kernels and the wrong counts, by
           case, the runs the check fails, and the host cost of a K5 call
           in each process before and after its captures;
  kernels  K1-K4 (K4 through the phase-2 CR's NntPlan) and their plain
           versions at the shapes of the presolved LP: host wall time per
           call and device time per call from torch.profiler, and the
           device's busy share over the calls;
  busy     device time over wall time of one port solve, from
           torch.profiler, with the ten kernels and copies that took most;
  batched  K5-K13 and their plain versions at the shapes of that LP as a
           batch of 256 scenarios (chip_smoke.py phase 5): host wall time
           and device time per call;
  stage    the batched phase 1 of chip_smoke.py phase 6
           (BatchedPhase1Solver(device="cuda"), B = 256, handoff "auto"):
           wall time, device busy share and the ten largest device items,
           each named by its kernel (K1-K13) where it is one (K6's fused
           launch as "K6 fused"), and K7's passes by name (kStart, kPassCA,
           kCheck, ...) with their launches and mean device time;
  k6       K6's two forms (the fused launch and the two K5 launches) in
           turns, f32 and f64, B = 256, on operands of m = 20 000 rows whose
           n columns hold L nonzeros each (nnz about 192 000, as the LP's
           A), L = 2, 3, 4, 5, 6, 8: device and event time of each form, the
           ratio by which K6's plan chooses (kernels.K6_FUSED_RATIO);
  k5       K5's forms in turns: its row body with one nonzero at a time
           and with two gathers issued together (csrc/spmm.cu row_gather),
           and its tiled form (csr_spmm_tile_kernel), f32 and f64, on A U
           and A' V of the batched path's LP at B = 4, 8, 32, 64 and 256
           and on A' V of the k6 part's operands (rows of L nonzeros in A')
           at B = 256: device and event time of each beside the bound, the
           forms kernels.k5_form and k5_unroll take (the evidence for
           K5_SEG_BYTES as k5_form's threshold and for K5_UNROLL_BELOW),
           and the library's product on the LP at B = 256;
  k13      K13's one cooperative launch and its seven launches in turns at
           the batch's shapes, bit for bit: device and event time;
  k17      K17 on splu's L and U of the final host basis (chip_smoke.py
           phase 10) at B = 1, 256 and 1024: the per-level form's device
           time by level, then full solves of the per-level form and the
           one-launch sweep in turns, device and event time and CUDA
           kernels a solve, bit for bit; the sweep at other tiles (lanes
           a tile) at B = 256 and 1024, beside the bound and
           torch.triangular_solve (`--forms levels` for the first alone);
  k2       the stand-alone K2 in three launches and in one cooperative
           launch in turns, f32 and f64, bit for bit: device and event
           time, CUDA kernels a call;
  scenarios  chip_smoke.py phase 7: the batched phase 1 of its 4
           scenarios alone (BatchedPhase1Solver, device="cuda", handoff
           "auto"; B = 4 lanes, below one warp) with its steps and CR
           trips, then BatchedScenarioSolver end to end on them: wall
           times and K7's launches;
  polish   one full shared-basis polish (SharedBasisBatchedPolish,
           device="cuda", 40 steps at most, as BatchedScenarioSolver runs
           it) of 4 scenarios from their batched phase-1 handoff: steps,
           shared-basis CR iterations, wall time, the host CR's share,
           device time and busy share, and the largest device items;
  sharded  K4 over 4 column blocks of phase 2's N, K14v and K14-K16 and
           their plain versions at the shapes of chip_smoke.py phase 9 (4
           row blocks of the presolved LP, B = 256 for K14 and K16): host
           wall time and device time per call; K15's cooperative launch
           and its host-issued passes on 20 trips (its launches and the
           applies inside it), K16's fused apply and its three-stage form,
           alone and in 10-trip solves, in turns: device time per call and
           per trip; then LpSolver(shards=4) with device "cuda" and
           "auto": wall time, phase times, K15's launches against the
           sharded CR solves and the K14v and K1 applies inside them, and
           for "cuda" the device busy share and the largest device items;
  entry    one step of ipx_tpu_torch.entry.entry() on the card (K5-K13 at
           m = 32, n = 48, B = 8) and the same step through the plain
           versions: host wall time and device time per call, from copies
           of one state; then the wall time of dryrun_multichip(4).

The first line says what the process sees of its host: the CPUs of its
affinity mask, the cgroup's quota, the OpenMP runtimes mapped, torch's
threads and the OpenBLAS pools' sizes. It imports torch and ipx_tpu_torch
only, and no jax.
"""
import argparse
import cProfile
import os
import pstats
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from ipx_tpu_torch import (LpSolver, Parameters, backend,  # noqa: E402
                           kernels, testgen)
from ipx_tpu_torch.native import threads  # noqa: E402
from ipx_tpu_torch.kkt.splitted_normal import (  # noqa: E402
    SplittedNormalMatrix)
from ipx_tpu_torch.sparse import normal_diag  # noqa: E402
from ipx_tpu_torch.ops import device_cr, device_cr2, spmv  # noqa: E402
from ipx_tpu_torch.parallel import batch  # noqa: E402

from chip_smoke import (batch_ms, cuda_ms, device_ms,  # noqa: E402
                        k7_passes, scenarios)

INSTANCE = (8000, 12000, 0.001, 1)
OMP_VARS = ("OMP_NUM_THREADS", "OMP_WAIT_POLICY", "OMP_PROC_BIND",
            "OPENBLAS_NUM_THREADS")
NATIVE = ("AI_mul", "AIt_mul", "newton_recover", "step_boundary")
PHASES = ("time_ipm1", "time_ipm2", "time_cr1", "time_cr2", "time_cr2_NNt",
          "time_maxvol", "time_crossover")


def card_name() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def solve(data, device, profiler=None, **params):
    """One solve through ipx_tpu_torch.LpSolver; returns (solver, status,
    wall seconds). `profiler` is a context manager entered around solve()."""
    s = LpSolver(Parameters(display=0, debug=1, device=device, **params))
    if testgen.load_into_solver(data, s) != 0:
        raise RuntimeError("load_model failed")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if profiler is None:
        st = s.solve()
    else:
        with profiler:
            st = s.solve()
    torch.cuda.synchronize()
    return s, st, time.perf_counter() - t0


def host_line() -> str:
    """What the process can see of its host: the CPUs of its affinity mask,
    os.cpu_count(), the cgroup's CPU quota, the OpenMP runtimes mapped into
    it and the OpenMP settings."""
    quota = "-"
    for path in ("/sys/fs/cgroup/cpu.max",
                 "/sys/fs/cgroup/cpu/cpu.cfs_quota_us"):
        if os.path.exists(path):
            with open(path) as f:
                quota = f.read().strip()
            break
    with open("/proc/self/maps") as f:
        gomp = sorted({line.split()[-1] for line in f if "gomp" in line})
    env = " ".join(f"{k}={os.environ.get(k, '-')}" for k in OMP_VARS)
    return (f"host affinity {len(os.sched_getaffinity(0))} cpus, cpu_count "
            f"{os.cpu_count()}, cgroup cpu quota {quota!r}, libgomp {gomp}, "
            f"{env}, torch_threads {torch.get_num_threads()}, "
            f"{blas_line()}")


def blas_line() -> str:
    """The OpenBLAS pools' sizes now, and in a solve (native/threads.py)."""
    k = threads.blas_threads(os.environ)
    return (f"openblas pools {[get() for get, _ in threads.blas_pools()]} "
            f"threads, {'as they are' if k is None else k} in a solve")


def thread_cpu() -> dict:
    """CPU seconds (user + system) of each thread of this process."""
    tick = os.sysconf("SC_CLK_TCK")
    out = {}
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        out[tid] = (int(fields[11]) + int(fields[12])) / tick
    return out


def part_e2e(data, args, card):
    env = " ".join(f"{k}={os.environ.get(k, '-')}" for k in OMP_VARS)
    for _ in range(args.turns):
        for device in ("cuda", "cpu"):
            c0, th0 = os.times(), thread_cpu()
            kernels.reset_launches()
            s, st, wall = solve(data, device)
            c1, th1 = os.times(), thread_cpu()
            cpu = (c1.user - c0.user) + (c1.system - c0.system)
            busy = sorted((th1[k] - th0.get(k, 0.0) for k in th1),
                          reverse=True)
            cpu = (f"{cpu:.3f} s over {len(th1)} threads, the busiest "
                   f"{' '.join(f'{b:.2f}' for b in busy[:10])} s")
            i = s.get_info()
            times = " ".join(f"{f[5:]} {getattr(i, f):.3f}" for f in PHASES)
            print(f"e2e {env} torch_threads {torch.get_num_threads()} "
                  f"{blas_line()} | "
                  f"device={device:4s} status {st} wall {wall:.3f} s, "
                  f"process cpu {cpu} | objval {i.objval!r} | "
                  f"{times} | IPM {i.iter} CR {i.kktiter1}+{i.kktiter2} | "
                  f"{card}", flush=True)
            if device == "cuda":
                print(f"e2e   launches: K3 cooperative "
                      f"{kernels.LAUNCHES['cr_step']} (one an inner CR "
                      f"solve), K2 applies inside it "
                      f"{kernels.INSIDE['normal_apply']}, K2 alone "
                      f"{kernels.LAUNCHES['normal_apply']}, K4 "
                      f"{kernels.LAUNCHES['nnt']} | {card}", flush=True)


def part_native(data, args, card):
    """Per path, from cProfile: the native vector kernels' time per call,
    then the functions with the most time of their own and those with the
    most time in all (the device path's set-up among them)."""
    for device in ("cuda", "cpu"):
        prof = cProfile.Profile()
        _, st, wall = solve(data, device, profiler=prof)
        stats = pstats.Stats(prof).stats
        per = {}
        for (_, _, name), (_, ncalls, tottime, _, _) in stats.items():
            if name in NATIVE:
                calls, t = per.get(name, (0, 0.0))
                per[name] = (calls + ncalls, t + tottime)
        calls = " ".join(f"{k} {t / c * 1e3:.3f} ms x{c}"
                         for k, (c, t) in sorted(per.items()))
        print(f"native device={device:4s} status {st} wall {wall:.3f} s "
              f"(under cProfile), {blas_line()} | {calls} | "
              f"{card}", flush=True)
        for title, col in (("own", 2), ("all", 3)):
            top = sorted(stats.items(), key=lambda kv: -kv[1][col])[:25]
            print(f"  device={device} most time, {title}: " + "; ".join(
                f"{name} ({os.path.basename(path)}:{line}) "
                f"{v[col] * 1e3:.1f} ms x{v[1]}"
                for (path, line, name), v in top), flush=True)


def part_precision(data, args, card):
    """The "cuda" solve with Parameters.precision "mixed" (the mixed device
    CR of phase 1) and "f64" (the f64 device CR) in turns, beside one host
    solve's objval."""
    host, _, _ = solve(data, "cpu")
    want = host.get_info().objval
    for _ in range(args.turns):
        for precision in ("mixed", "f64"):
            s, st, wall = solve(data, "cuda", precision=precision)
            i = s.get_info()
            times = " ".join(f"{f[5:]} {getattr(i, f):.3f}" for f in PHASES)
            print(f"precision {precision:5s} device=cuda status {st} wall "
                  f"{wall:.3f} s | objval {i.objval!r} (host {want!r}, rel "
                  f"{abs(i.objval - want) / abs(want):.1e}) | {times} | IPM "
                  f"{i.iter} CR {i.kktiter1}+{i.kktiter2} | {blas_line()} | "
                  f"{card}", flush=True)


def part_threads(data, args, card):
    """e2e (one solve a path) in a fresh process per thread setting, the
    settings in turns, forth and back; OpenMP and OpenBLAS read theirs when
    they load."""
    cpus = str(len(os.sched_getaffinity(0)))
    settings = ({}, {"OPENBLAS_NUM_THREADS": cpus},
                {"OPENBLAS_NUM_THREADS": "1", "OMP_NUM_THREADS": "4"},
                {"OPENBLAS_NUM_THREADS": "1", "OMP_NUM_THREADS": "2"},
                {"OMP_NUM_THREADS": "1"}, {"OMP_NUM_THREADS": "4"})
    env = {k: v for k, v in os.environ.items()
           if k not in threads.USER_VARS}
    for setting in settings + settings[::-1]:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--what", "e2e",
             "--turns", "1"], cwd=REPO, env=dict(env, **setting),
            capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            raise RuntimeError(f"{setting}: {out.stderr[-2000:]}")
        print(out.stdout, end="", flush=True)


def guard_runs(data, card, what, env, turns):
    """chip_smoke.py phase 4's walls (chip_smoke.phase4_runs) `turns`
    times with `env` set on top of this process's environment: each time
    the walls, both statistics' ratios and the thread guard's failures."""
    from chip_smoke import guard_line, phase4_runs, thread_guard
    host, st, _ = solve(data, "cpu")
    if st != 1000:
        raise RuntimeError(f"the host solve ended at {st}")
    with mock.patch.dict(os.environ, env):
        for _ in range(turns):
            runs = phase4_runs(host.get_info().objval)
            failures = "; ".join(thread_guard(runs))
            print(f"{what} {env} | {guard_line(runs)} | the guard "
                  f"{'fails: ' + failures if failures else 'passes'} | "
                  f"{card}", flush=True)


def part_walls(data, args, card):
    """chip_smoke.py phase 4's walls and thread guard as chip_smoke runs
    them, `--turns` times: the spread of the guard's statistics on a
    fault-free tree."""
    guard_runs(data, card, "walls", {}, args.turns)


def part_binding(data, args, card):
    """chip_smoke.py phase 4's walls and thread guard `--turns` times
    each, in turns, with the workers' OpenMP binding as chip_smoke's
    workers inherit it (OMP_PROC_BIND=spread, which the port sets on
    import; a libgomp may then bind a process's main thread, and every
    thread it starts later, to one CPU) and with OMP_PROC_BIND=false."""
    settings = ({}, {"OMP_PROC_BIND": "false"})
    for i in range(args.turns):
        for env in settings[::-1] if i % 2 else settings:
            guard_runs(data, card, "binding", env, 1)


def part_guard(data, args, card):
    """chip_smoke.py phase 4's walls and thread guard with the OpenBLAS
    pools one thread per CPU in every solve: OPENBLAS_NUM_THREADS set to
    the CPUs, which native/threads.py leaves as the user sized it. That is
    the fault the guard exists for, made outside the package."""
    guard_runs(data, card, "guard", {"OPENBLAS_NUM_THREADS": str(len(
        os.sched_getaffinity(0)))}, 1)


def part_counts(data, args, card):
    """chip_smoke.py phase 10's count of CUDA kernels a call (ONE_LAUNCH)
    in `--runs` fresh processes of each form, in turns: one capture a case
    closed right after the call (the count as it was decided on one
    capture), chip_smoke.CAPTURES such captures a case, and
    chip_smoke.CAPTURES captures each open chip_smoke.MARGIN seconds on
    either side of the call (chip_smoke's form). For each form: the
    captures that recorded no kernel, and those that recorded another
    count than the expected one, by case; the runs that
    chip_smoke.count_failures fails; and the K5 host probe of the runs
    (median microseconds a call, before and after the captures)."""
    from chip_smoke import (CAPTURES, MARGIN, count_failures,
                            one_launch_counts, one_launch_expected)
    forms = ((1, 0.0), (CAPTURES, 0.0), (CAPTURES, MARGIN))
    tally = {f: dict(lost={}, wrong={}, failed=0, runs=0, host={})
             for f in forms}
    for _ in range(args.runs):
        for f in forms:
            out = one_launch_counts(*f)
            want = one_launch_expected(out["nlev"])
            t = tally[f]
            t["runs"] += 1
            t["failed"] += bool(count_failures(out["captures"], want))
            for case, got in out["captures"].items():
                lost = sum(1 for k in got if k == 0)
                wrong = [k for k in got if k not in (0, want[case])]
                t["lost"][case] = t["lost"].get(case, 0) + lost
                t["wrong"].setdefault(case, []).extend(wrong)
            for when, probe in out["k5_host"].items():
                t["host"].setdefault(when, []).append(probe["us"])
    for (c, margin), t in tally.items():
        host = {k: f"{np.median(v):.2f}" for k, v in t["host"].items()}
        print(f"counts {c} capture(s) a case, {margin} s open on each side, "
              f"{t['runs']} fresh processes, nlev {out['nlev']}: captures "
              f"with no kernel {t['lost']}; wrong counts {t['wrong']}; runs "
              f"the check fails {t['failed']}; K5 host us a call (median) "
              f"{host} | {card}", flush=True)


# the port's kernel of each CUDA function of csrc/, by name prefix
KERNEL_OF = (("csr_spmv", "K1/K2"), ("reduce_sum", "K2"),
             ("cr_step", "K3 host-issued"), ("cr_solve", "K3 cooperative"),
             ("csr_spmm", "K5/K6"), ("normal_batched", "K6 fused"),
             ("lane_sum", "K6"),
             ("bcr_", "K7"), ("step_", "K8"), ("muaff", "K8"),
             ("ipm_update", "K9"), ("prologue_", "K10"), ("mu_", "K10"),
             ("newton_rhs", "K11"), ("normal_rhs", "K11"),
             ("newton_dx", "K12"), ("recover_", "K12"), ("start_", "K13"),
             ("block_sum", "K14"), ("scr_", "K15"), ("sbcr_", "K16"),
             ("split_", "K14v/K4"), ("nnt_", "K4"))


def kernel_label(key: str) -> str:
    """'K10 prologue_reduce_kernel...' for a CUDA function of the port, the
    profiler's key as it is otherwise."""
    name = key.removeprefix("void ").removeprefix("ipxt::").removeprefix(
        "(anonymous namespace)::")
    for prefix, label in KERNEL_OF:
        if name.startswith(prefix):
            return f"{label} {name}"
    return key


def _device_us(prof):
    """Self device time (us) of the profiler's CUDA events, and the events."""
    events = [e for e in prof.key_averages()
              if e.device_type.name == "CUDA"]
    return sum(e.self_device_time_total for e in events), events


def part_kernels(data, args, card):
    dev = backend.cuda_device()
    host, _, _ = solve(data, "cpu", stop_at_switch=1)
    md = host.basis.model
    m, n = md.num_rows, md.num_cols
    rng = np.random.default_rng(args.seed)

    def t(x, dtype):
        return torch.from_numpy(np.asarray(x, dtype=np.float64)).to(
            dtype).to(dev)

    n64 = spmv.NormalMatrixDevice(md.A, dev, torch.float64)
    n32 = spmv.NormalMatrixDevice(md.A, dev, torch.float32)
    x64, v64 = t(rng.standard_normal(n), torch.float64), \
        t(rng.standard_normal(m), torch.float64)
    W32 = t(10.0 ** rng.uniform(-2, 2, n + m), torch.float32)
    v32 = t(rng.standard_normal(m), torch.float32)
    Wh = 10.0 ** rng.uniform(-2, 2, n + m)
    diag = normal_diag(md.A, Wh)
    rs = 1.0 / np.sqrt(Wh[n:])
    rhs = rng.standard_normal(m)
    tol = 1e-8 * float(np.max(np.abs(rs * rhs)))

    class PlainMixedCR(device_cr.MixedPrecisionDeviceCR):
        inner_solve = staticmethod(device_cr.cr_solve_plain)

    mk = device_cr.MixedPrecisionDeviceCR(md, Wh, diag, rs, device=dev)
    mp = PlainMixedCR(md, Wh, diag, rs, device=dev)
    sn = SplittedNormalMatrix(md)
    sn.prepare(host.basis, host.iterate.scaling_factors())
    dsc = device_cr2.DeviceSplittedCR(md, dev)
    dsc.prepare(sn)
    w = t(rng.standard_normal(m), torch.float64)
    cases = [
        ("K1 A u f64", lambda: kernels.csr_spmv(n64.op_A, x64),
         lambda: spmv.csr_spmv_plain(n64.op_A, x64), 100),
        ("K1 A'v f64", lambda: kernels.csr_spmv(n64.op_At, v64),
         lambda: spmv.csr_spmv_plain(n64.op_At, v64), 100),
        ("K2 f32", lambda: spmv.normal_apply(n32, W32, v32),
         lambda: spmv.normal_apply_plain(n32, W32, v32), 100),
        ("K4 f64 (plan)", lambda: dsc._plan(w),
         lambda: device_cr2.nnt_plain(dsc._Nt, dsc._N, w), 100),
        ("K3 mixed CR solve", lambda: mk.solve(rhs, tol, -1),
         lambda: mp.solve(rhs, tol, -1), 5)]
    profile_cases(cases, card)


def profile_cases(cases, card):
    """Host wall time and profiler device time per call of each (name,
    kernel, plain, reps) case."""
    from torch.profiler import ProfilerActivity, profile
    for name, kern, plain, reps in cases:
        for label, fn in (("kernel", kern), ("plain", plain)):
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) / reps
            dev_us, events = _device_us(prof)
            dev_us /= reps
            top = ", ".join(
                f"{e.key[:40]} {e.count // reps}x"
                f"{e.self_device_time_total / e.count:.1f}us"
                for e in sorted(events, key=lambda e:
                                -e.self_device_time_total)[:3])
            print(f"kernels {name:18s} {label:6s} host wall/call "
                  f"{wall * 1e3:.4f} ms, device/call {dev_us / 1e3:.4f} ms, "
                  f"busy {dev_us / 1e6 / wall:.1%} | {top} | {card}",
                  flush=True)


def profile_forms(name, forms, order, reps, trips, card):
    """Two forms of one computation, profiled in turns (a, b, b, a): host
    wall time and device time per call, device time per trip, and the
    time a call of `reps` issued back to back (chip_smoke.batch_ms)."""
    from torch.profiler import ProfilerActivity, profile
    a, b = order
    for label in (a, b, b, a):
        fn = forms[label]
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / reps
        dev_us = _device_us(prof)[0] / reps
        print(f"sharded {name:13s} {label:11s} host wall/call "
              f"{wall * 1e3:.4f} ms, device/call {dev_us / 1e3:.4f} ms, "
              f"device/trip {dev_us / trips:.2f} us, back to back "
              f"{batch_ms(fn, reps):.4f} ms/call | {card}", flush=True)


def part_busy(data, args, card):
    from torch.profiler import ProfilerActivity, profile
    backend.cuda_device()
    prof = profile(activities=[ProfilerActivity.CUDA])
    _, st, wall = solve(data, "cuda", profiler=prof)
    dev_us, events = _device_us(prof)
    print(f"busy device=cuda status {st} wall {wall:.3f} s, device "
          f"{dev_us / 1e6:.4f} s = {dev_us / 1e6 / wall:.2%} of wall | "
          f"{card}", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"busy   {e.key[:60]:60s} count {e.count:6d} total "
              f"{e.self_device_time_total / 1e3:8.3f} ms, mean "
              f"{e.self_device_time_total / e.count:6.2f} us", flush=True)


def _batch(data, B=256):
    return batch.BatchedScenarioSolver(data, scenarios(data, B)).blp


def part_batched(data, args, card):
    dev = backend.cuda_device()
    blp = _batch(data)
    m, n = blp.A.shape
    B = blp.batch
    rng = np.random.default_rng(args.seed)

    def t(x, dtype=torch.float64):
        return torch.from_numpy(np.asarray(x, dtype=np.float64)).to(
            dtype).to(dev)

    f32 = torch.float32
    n64 = spmv.NormalMatrixDevice(blp.A, dev)
    n32 = spmv.NormalMatrixDevice(blp.A, dev, f32)
    U64, V32 = t(rng.standard_normal((n, B))), t(rng.standard_normal((m, B)),
                                                   f32)
    W32 = t(10.0 ** rng.uniform(-2, 2, (n + m, B)), f32)
    Wc = 10.0 ** rng.uniform(-1, 1, (n + m, B))
    A2 = blp.A.copy()
    A2.data **= 2
    rs = 1.0 / np.sqrt(Wc[n:])
    rhs = rng.standard_normal((m, B))
    tol = np.max(np.abs(rs * rhs), axis=0) * 10.0 ** rng.uniform(-4, -3, B)
    cr = (n32, t(Wc, f32), t(1.0 / (A2 @ Wc[:n] + Wc[n:]), f32), t(rs, f32),
          t(rhs, f32), t(tol, f32), 500)
    finl = torch.from_numpy(np.isfinite(blp.lb)).to(dev)
    finu = torch.from_numpy(np.isfinite(blp.ub)).to(dev)
    st = {}
    for name, fin in (("XL", finl), ("XU", finu), ("ZL", finl),
                      ("ZU", finu)):
        x = t(rng.uniform(1e-3, 10.0, (n + m, B)))
        x[~fin] = float("inf") if name.startswith("X") else 0.0
        st[name] = x
        st["D" + name] = t(rng.standard_normal((n + m, B)) * 5.0)
    sargs = [st[k] for k in ("XL", "XU", "ZL", "ZU", "DXL", "DXU", "DZL",
                             "DZU")] + [finl, finu]
    upd = (t(rng.standard_normal((n + m, B))), st["XL"], st["XU"],
           t(rng.standard_normal((m, B))), st["ZL"], st["ZU"],
           t(rng.standard_normal((n + m, B))), st["DXL"], st["DXU"],
           t(rng.standard_normal((m, B))), st["DZL"], st["DZU"],
           t(rng.uniform(0.1, 1.0, B)), t(rng.uniform(0.1, 1.0, B)),
           torch.from_numpy(rng.random(B) < 0.25).to(dev), finl, finu)
    cases = [
        ("K5 A U f64", lambda: kernels.csr_spmm(n64.op_A, U64),
         lambda: spmv.csr_spmm_plain(n64.op_A, U64), 50),
        ("K5 A'V f32", lambda: kernels.csr_spmm(n32.op_At, V32),
         lambda: spmv.csr_spmm_plain(n32.op_At, V32), 50),
        ("K6 f32", lambda: spmv.normal_apply_batched(n32, W32, V32),
         lambda: spmv.normal_apply_batched_plain(n32, W32, V32), 50),
        ("K7 f32 CR solve", lambda: batch.batched_cr(*cr),
         lambda: batch.batched_cr_plain(*cr), 3),
        ("K8 maxp/maxd f64", lambda: batch.step_batch(*sargs),
         lambda: batch.step_batch_plain(*sargs), 20),
        ("K9 update f64", lambda: batch.ipm_update(*upd),
         lambda: batch.ipm_update_plain(*upd), 20)]
    profile_cases(cases, card)
    del cases, cr, sargs, upd, U64, V32, W32, n32
    profile_cases(step_cases(blp, n64, st, finl, finu, t, rng), card)


def step_cases(blp, n64, st, finl, finu, t, rng):
    """K10-K13 and their plain versions on an iterate-like float64 state
    (the XL, XU, ZL, ZU of `st`) at the batch's shapes."""
    m, n = blp.A.shape
    B = blp.batch
    lb, ub = t(blp.lb), t(blp.ub)
    X, Y = t(rng.standard_normal((n + m, B))), t(rng.standard_normal((m, B)))
    bT, cT = t(np.ascontiguousarray(blp.b.T)), t(np.ascontiguousarray(
        blp.c.T))
    done = torch.zeros(B, dtype=torch.bool, device=X.device)
    num_fin = int(finl.sum() + finu.sum())
    pro = (kernels.csr_spmm(n64.op_A, X[:n]),
           kernels.csr_spmm(n64.op_At, Y), X, st["XL"], st["XU"], Y,
           st["ZL"], st["ZU"], done, bT, cT, lb, ub, finl, finu, 1e-6, 1e-6,
           1e-8, 0.3, num_fin)
    P = batch.ipm_prologue(*pro)
    rhs = (n64.op_A, P.RC, P.RL, P.RU, st["XL"], st["XU"], st["ZL"],
           st["ZU"], P.W, P.RB, finl, finu, t(rng.uniform(0.0, 1.0, B)),
           P.mu, st["DXL"], st["DZL"], st["DXU"], st["DZU"])
    SL, SU, RHS1, _ = batch.newton_rhs(*rhs)
    rec = (n64.op_A, kernels.csr_spmm(n64.op_At, Y), Y, RHS1, P.W, P.RB,
           P.RC, P.RL, P.RU, SL, SU, st["XL"], st["XU"], st["ZL"],
           st["ZU"], finl, finu)
    X0 = torch.clamp(torch.zeros_like(X), lb[:, None], ub[:, None])
    ATY = kernels.csr_spmm(n64.op_At, Y)
    sp = (X0, ATY, Y, ATY, Y, cT, lb, ub, finl, finu)
    return [
        ("K10 prologue f64", lambda: batch.ipm_prologue(*pro),
         lambda: batch.ipm_prologue_plain(*pro), 20),
        ("K11 corrector f64", lambda: batch.newton_rhs(*rhs),
         lambda: batch.newton_rhs_plain(*rhs), 20),
        ("K12 recover f64", lambda: batch.newton_recover(*rec),
         lambda: batch.newton_recover_plain(*rec), 20),
        ("K13 start f64", lambda: batch.starting_point(*sp),
         lambda: batch.starting_point_plain(*sp), 10)]


def part_stage(data, args, card):
    from torch.profiler import ProfilerActivity, profile
    backend.cuda_device()
    blp = _batch(data)
    ph1 = batch.BatchedPhase1Solver(blp, feasibility_tol=1e-4,
                                    optimality_tol=1e-4, device="cuda")
    ph1._starting_point()           # warm-up
    torch.cuda.synchronize()
    walls = {}
    for label, prof in (("wall", None),
                        ("profiled", profile(
                            activities=[ProfilerActivity.CUDA]))):
        t0 = time.perf_counter()
        if prof is None:
            out = ph1.solve(handoff="auto")
        else:
            with prof:
                out = ph1.solve(handoff="auto")
        torch.cuda.synchronize()
        wall = walls[label] = time.perf_counter() - t0
        print(f"stage {label} B={blp.batch} steps {int(out['iters'].max())} "
              f"CR trips {int(out['cr'])} wall {wall:.3f} s | {card}",
              flush=True)
    top_items("stage", prof, wall, card)
    # the profiler slows the host's launches, so the busy share of the
    # stage as it runs is the device time over the unprofiled wall
    print(f"stage device {_device_us(prof)[0] / 1e6:.4f} s = "
          f"{_device_us(prof)[0] / 1e6 / walls['wall']:.2%} of the unprofiled"
          f" wall {walls['wall']:.3f} s | {card}", flush=True)
    for (dn, name), (n, us) in sorted(k7_passes(prof).items()):
        print(f"stage   K7 {dn:6s} {name:8s} count {n:7d} mean {us:8.2f} us"
              f" | {card}", flush=True)


def _columns_of(m, L, nnz, seed):
    """A CSC matrix of m rows whose nnz // L columns hold L nonzeros each,
    at L rows m // L apart from a random first one, values uniform in
    [0.5, 1.5]."""
    import scipy.sparse as sp
    rng = np.random.default_rng(seed)
    n = nnz // L
    rows = (rng.integers(0, m, n)[:, None] + np.arange(L) * (m // L)) % m
    rows.sort(axis=1)
    return sp.csc_matrix((rng.uniform(0.5, 1.5, n * L), rows.ravel(),
                          np.arange(0, n * L + 1, L)), shape=(m, n))


def part_k6(data, args, card):
    """K6's forms against the column length L of A, in turns."""
    dev = backend.cuda_device()
    m, B, nnz = 20000, 256, 192004
    rng = np.random.default_rng(args.seed)
    for L in (2, 3, 4, 5, 6, 8):
        A = _columns_of(m, L, nnz, seed=L)
        for dtype in (torch.float32, torch.float64):
            nmd = spmv.NormalMatrixDevice(A, dev, dtype)
            n = nmd.n
            t = lambda x: torch.from_numpy(x).to(dtype).to(dev)  # noqa
            W, V = t(10.0 ** rng.uniform(-2, 2, (n + m, B))), t(
                rng.standard_normal((m, B)))
            plan = kernels.normal_plan_of(nmd.op_At, nmd.op_A)
            e = lambda *s: torch.empty(s, dtype=dtype, device=dev)  # noqa
            out, U = e(m, B), e(n, B)
            p = e(*plan.partials_shape(W, V, out))
            forms = {f: (lambda f=f: plan(W, V, out=out, U=U, partials=p,
                                          fused=f == "fused"))
                     for f in ("fused", "two-launch")}
            ev = {f: [] for f in forms}
            for f in ("fused", "two-launch", "two-launch", "fused"):
                ev[f].append(cuda_ms(forms[f]))
            dv = {f: device_ms(forms[f], reps=20) for f in forms}
            print(f"k6 L={L} {str(dtype)[6:]} m={m} n={n} B={B} sum len^2 / "
                  f"nnz {nmd.op_At.sq_rows / A.nnz:.2f} (plan: "
                  f"{'fused' if plan.fused else 'two-launch'}) | " + "; ".join(
                      f"{f} device {dv[f]:.5f} ms, event "
                      f"{'/'.join(f'{x:.4f}' for x in ev[f])} ms"
                      for f in forms)
                  + f" | fused / two-launch device "
                  f"{dv['fused'] / dv['two-launch']:.3f} | {card}",
                  flush=True)
            del nmd, W, V, out, U, p, forms
            torch.cuda.empty_cache()


def _k5_forms(op, X, Y):
    """K5's forms on `op` (csrc/spmm.cu): the row body at unroll 1 and 2
    and the tiled form."""
    forms = {f"row{u}": (lambda u=u: kernels._spmm(op, X, Y, form="row",
                                                   unroll=u))
             for u in (1, 2)}
    forms["tile"] = lambda: kernels._spmm(op, X, Y, form="tile")
    return forms


def part_k5(data, args, card):
    """K5's forms in turns (row1, row2, tile, tile, row2, row1): the row
    body at unroll 1 and 2 and the tiled form, f64 and f32, on A U and A' V
    of the batched path's LP at B = 4, 8, 32, 64 and 256 and, at
    B = 256, on A' V of operands whose columns hold L nonzeros (rows of L
    in A'): device and event time of each beside the bound and the forms
    kernels.k5_form and k5_unroll take, and at B = 256 on the LP the
    library's sparse_csr_tensor @ U."""
    from chip_smoke import FN, bound, library_csr, nbytes, op_bytes
    dev = backend.cuda_device()
    A_lp = _batch(data).A
    m, nnz = A_lp.shape[0], 192004
    rng = np.random.default_rng(args.seed)
    cases = [("LP", A_lp, B) for B in (4, 8, 32, 64, 256)] + [
        (f"L={L}", _columns_of(m, L, nnz, seed=L), 256)
        for L in (2, 3, 4, 5, 6, 8)]
    for label, A, B in cases:
        for dtype in (torch.float64, torch.float32):
            nmd = spmv.NormalMatrixDevice(A, dev, dtype)
            ops = (("A U", nmd.op_A), ("A'V", nmd.op_At))
            for opname, op in ops if label == "LP" else ops[1:]:
                X = torch.from_numpy(rng.standard_normal((op.cols, B))).to(
                    dtype).to(dev)
                Y = torch.empty((op.rows, B), dtype=dtype, device=dev)
                forms = _k5_forms(op, X, Y)
                order = list(forms) + list(forms)[::-1]
                ev = {k: [] for k in forms}
                for k in order:
                    ev[k].append(cuda_ms(forms[k]))
                dv = {k: [] for k in forms}
                for k in order:
                    dv[k].append(device_ms(forms[k], reps=20))
                b = bound(op_bytes(op) + nbytes(X, Y),
                          2 * op.vals.numel() * B, FN[str(dtype)[6:]])
                lib = ""
                if label == "LP" and B == 256:
                    A_lib = library_csr(op)
                    lib = (f" | library {cuda_ms(lambda: A_lib @ X):.4f} "
                           f"ms event, {device_ms(lambda: A_lib @ X):.5f} "
                           f"ms device")
                    del A_lib
                print(f"k5 {label} {opname} {str(dtype)[6:]} B={B} mean row "
                      f"{op.vals.numel() / op.rows:.2f} (k5_form "
                      f"{kernels.k5_form(B, X.element_size(), False)}, "
                      f"k5_unroll "
                      f"{kernels.k5_unroll(op)}) | " + "; ".join(
                          f"{k} device "
                          f"{'/'.join(f'{x:.5f}' for x in dv[k])} ms, event "
                          f"{'/'.join(f'{x:.4f}' for x in ev[k])} ms"
                          for k in forms)
                      + f" | bound {b['bound_ms']:.5f} ms ({b['bound_by']})"
                      + lib + f" | {card}", flush=True)
            del nmd
            torch.cuda.empty_cache()


def part_k13(data, args, card):
    """K13's one cooperative launch and its seven launches in turns (one,
    seven, seven, one) at the batch's shapes (n + m = 116 002, B = 256)
    from a clamped zero point and seeded CR solutions: device and event
    time of each beside the bound, outputs and lane scalars bit for bit."""
    from chip_smoke import bound, nbytes
    dev = backend.cuda_device()
    blp = _batch(data)
    m, n = blp.A.shape
    B = blp.batch
    rng = np.random.default_rng(args.seed)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa
    n64 = spmv.NormalMatrixDevice(blp.A, dev)
    lb, ub = t(blp.lb), t(blp.ub)
    finl, finu = t(np.isfinite(blp.lb)), t(np.isfinite(blp.ub))
    DY, Y = t(rng.standard_normal((m, B))), t(rng.standard_normal((m, B)))
    X0 = torch.clamp(torch.zeros((n + m, B), dtype=torch.float64,
                                 device=dev), lb[:, None], ub[:, None])
    sp = (X0, kernels.csr_spmm(n64.op_At, DY), DY,
          kernels.csr_spmm(n64.op_At, Y), Y, t(blp.c.T), lb, ub, finl, finu)
    forms = {"one": lambda: kernels.starting_point(*sp, batch.RHO),
             "seven": lambda: kernels.starting_point(*sp, batch.RHO,
                                                     cooperative=False)}
    got = {k: f() for k, f in forms.items()}
    same = all(torch.equal(a, b) for a, b in zip(got["one"], got["seven"]))
    b = bound(nbytes(*sp, *got["one"]), 20 * (n + m) * B, "f64")
    del got
    ev, dv = {k: [] for k in forms}, {k: [] for k in forms}
    for k in ("one", "seven", "seven", "one"):
        ev[k].append(cuda_ms(forms[k], reps=10))
    for k in ("one", "seven", "seven", "one"):
        dv[k].append(device_ms(forms[k], reps=10))
    print(f"k13 f64 n+m={n + m} B={B} bit for bit {same} | " + "; ".join(
        f"{k} device {'/'.join(f'{x:.4f}' for x in dv[k])} ms, event "
        f"{'/'.join(f'{x:.4f}' for x in ev[k])} ms" for k in forms)
        + f" | bound {b['bound_ms']:.4f} ms ({b['bound_by']}) | {card}",
        flush=True)


def _kernel_events(prof):
    """The CUDA kernels of a torch.profiler window in launch order, as
    (name, device us), copies and fills left out."""
    return [(e.name, e.self_device_time_total) for e in prof.events()
            if e.device_type.name == "CUDA" and "Memcpy" not in e.name
            and "Memset" not in e.name]


def _profiled(fn, reps):
    """fn() `reps` times under torch.profiler after a warm-up: (device ms a
    call, CUDA kernels a call, the kernels of the window in order)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = _kernel_events(prof)
    return (sum(us for _, us in events) / reps / 1e3, len(events) / reps,
            events)


def _turns(forms, order, reps):
    """Forms timed in turns (a, b, b, a): {form: [(device ms, kernels a
    call, event ms)]} and the kernels of each form's last window."""
    a, b = order
    out, windows = {k: [] for k in forms}, {}
    for k in (a, b, b, a):
        dms, kern, windows[k] = _profiled(forms[k], reps)
        out[k].append((dms, kern, cuda_ms(forms[k], reps=reps, warm=1)))
    return out, windows


def _turns_text(out):
    return "; ".join(
        f"{k} device {'/'.join(f'{d:.4f}' for d, _, _ in v)} ms, event "
        f"{'/'.join(f'{e:.4f}' for _, _, e in v)} ms, "
        f"{v[0][1]:g} kernels a call" for k, v in out.items())


# the sweep's tiles (lanes a tile) timed at B = 256 and 1024 beside the
# rule's (kernels.k17_tile)
K17_TILES = (1, 2, 4, 8, 16, 32)


def part_k17(data, args, card):
    """K17 on splu's L and U of the final host basis of the 20k LP (the
    factors of chip_smoke.py phase 10), full solves (the L sweep, then the
    U sweep) at B = 1, 256 and 1024: the per-level form's device time by
    level, and its full solve against the one-launch sweep's, in turns
    (per level, sweep, sweep, per level), device and event time with the
    CUDA kernels a solve, X bit for bit; the sweep at other tiles (lanes a
    tile) at B = 256 and 1024; the bound and
    torch.triangular_solve's time. `--forms levels` times the per-level
    form alone."""
    from chip_smoke import bound, library_csr, library_solve, nbytes
    from ipx_tpu_torch.ops import trisolve
    dev = backend.cuda_device()
    ref, st, _ = solve(data, "cpu")
    if st != 1000:
        raise RuntimeError(f"the host solve ended in status {st}")
    L, U = trisolve.basis_factors(ref.basis)
    m = L.shape[0]
    sL = trisolve.level_schedule(L, True, dev)
    sU = trisolve.level_schedule(U, False, dev)
    print(f"k17 m={m} nnz(L)={L.nnz} nnz(U)={U.nnz}, levels L {sL.nlev} "
          f"rows {np.diff(sL.level_ptr).tolist()}, U {sU.nlev} rows "
          f"{np.diff(sU.level_ptr).tolist()} | {card}", flush=True)
    L_lib, U_lib = (library_csr(spmv.CsrOperand(T.indptr, T.indices, T.data,
                                                m, dev, torch.float64))
                    for T in (L, U))
    sched_bytes = sum(nbytes(s.rows, s.entry_ptr, s.cols, s.vals,
                             s.inv_diag) for s in (sL, sU))
    e_off = sL.cols.numel() + sU.cols.numel()
    rng = np.random.default_rng(args.seed)
    forms_on = args.forms.split(",")
    if not {"levels", "sweep"} & set(forms_on):
        return
    for B in (1, 256, 1024):
        V = torch.from_numpy(rng.standard_normal((m, B))).to(dev)
        reps = 50 if B == 1 else 20
        b = bound(sched_bytes + 2 * 2 * m * B * 8, 2 * (e_off + 2 * m) * B,
                  "f64")

        def full(V=V, **kw):
            return kernels.level_solve(sU, kernels.level_solve(sL, V, **kw),
                                       **kw)
        forms = {"levels": lambda: full(per_level=True), "sweep": full}
        forms = {k: f for k, f in forms.items() if k in forms_on}
        # the per-level form's levels, L's then U's, from its own window
        _, kern, events = _profiled(forms.get("levels", full), reps)
        if "levels" in forms:
            nl = sL.nlev + sU.nlev
            per = np.zeros(nl)
            for i, (_, us) in enumerate(events):
                per[i % nl] += us / reps
            print(f"k17 B={B} per-level form, device us by level, L: "
                  + " ".join(f"{x:.2f}" for x in per[:sL.nlev]) + "; U: "
                  + " ".join(f"{x:.2f}" for x in per[sL.nlev:])
                  + f"; sum {per.sum():.2f} us | {card}", flush=True)
        if len(forms) == 2:
            same = torch.equal(forms["levels"](), forms["sweep"]())
            out, _ = _turns(forms, ("levels", "sweep"), reps)
        else:
            same = "-"
            (k, f), = forms.items()
            dms, kern, _ = _profiled(f, reps)
            out = {k: [(dms, kern, cuda_ms(f, reps=reps, warm=1))]}
        lms = cuda_ms(lambda: library_solve(L_lib, U_lib, V), reps=reps)
        print(f"k17 B={B} full solve, bit for bit {same} | "
              + _turns_text(out) + f" | bound {b['bound_ms']:.5f} ms "
              f"({b['bound_by']}) | torch.triangular_solve {lms:.4f} ms "
              f"event | {card}", flush=True)
        if B > 1 and "sweep" in forms:
            times = []
            for lanes in K17_TILES:
                dms, _, _ = _profiled(lambda: full(lanes=lanes), reps)
                times.append(f"{lanes} {dms:.4f}")
            print(f"k17 B={B} sweep device ms by lanes a tile (rule "
                  f"{kernels.k17_tile(B)}): "
                  + ", ".join(times) + f" | {card}", flush=True)
        del V
        torch.cuda.empty_cache()


def part_k2(data, args, card):
    """The stand-alone K2 (Cv and v.Cv) at the presolved LP's shapes, f32
    and f64: its three launches (two K1 and reduce_sum) against its one
    cooperative launch in turns (three, one, one, three), device and event
    time with the CUDA kernels a call, out and the dot bit for bit; the
    bound."""
    from chip_smoke import bound, nbytes, op_bytes
    if not {"three", "one"} & set(args.forms.split(",")):
        return
    dev = backend.cuda_device()
    host, _, _ = solve(data, "cpu", stop_at_switch=1)
    md = host.basis.model
    m, n = md.num_rows, md.num_cols
    rng = np.random.default_rng(args.seed)
    Wh, vh = 10.0 ** rng.uniform(-2, 2, n + m), rng.standard_normal(m)
    for dtype in (torch.float32, torch.float64):
        nmd = spmv.NormalMatrixDevice(md.A, dev, dtype)
        W = torch.from_numpy(Wh).to(dtype).to(dev)
        v = torch.from_numpy(vh).to(dtype).to(dev)
        At, A = nmd.op_At, nmd.op_A

        def apply(one):
            dot = torch.empty(1, dtype=dtype, device=dev)
            out = kernels.normal_apply(At, A, W, v, dot=dot, one_launch=one)
            return out, dot
        forms = {"three": lambda: apply(False), "one": lambda: apply(True)}
        forms = {k: f for k, f in forms.items()
                 if k in args.forms.split(",")}
        (o3, d3), (o1, d1) = apply(False), apply(True)
        same = torch.equal(o3, o1) and torch.equal(d3, d1)
        if len(forms) == 2:
            out, _ = _turns(forms, ("three", "one"), 100)
        else:
            (k, f), = forms.items()
            dms, kern, _ = _profiled(f, 100)
            out = {k: [(dms, kern, cuda_ms(f, reps=100, warm=1))]}
        size = torch.finfo(dtype).bits // 8
        b = bound(op_bytes(A) + op_bytes(At) + nbytes(W, v, o1) + size,
                  4 * A.vals.numel() + n + 4 * m, FN[dtype])
        print(f"k2 {FN[dtype]} m={m} n={n} bit for bit {same} | "
              + _turns_text(out) + f" | bound "
              f"{b['bound_ms']:.5f} ms ({b['bound_by']}) | {card}",
              flush=True)


FN = {torch.float32: "f32", torch.float64: "f64"}


def top_items(part, prof, wall, card, k=10):
    """The device busy share of a profiled window and its k largest
    device items."""
    dev_us, events = _device_us(prof)
    print(f"{part} device {dev_us / 1e6:.4f} s = {dev_us / 1e6 / wall:.2%} "
          f"of the profiled wall | {card}", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:k]:
        print(f"{part}   {kernel_label(e.key)[:64]:64s} count {e.count:7d} "
              f"total {e.self_device_time_total / 1e3:9.3f} ms, mean "
              f"{e.self_device_time_total / e.count:8.2f} us", flush=True)


def part_scenarios(data, args, card):
    backend.cuda_device()
    sv = batch.BatchedScenarioSolver(
        data, scenarios(data, 256)[:4],
        parameters=Parameters(display=0, device="cuda"))
    ph1 = batch.BatchedPhase1Solver(
        sv.blp, feasibility_tol=sv.phase1_tol, optimality_tol=sv.phase1_tol,
        maxiter=sv.phase1_maxiter, device="cuda")
    ph1._starting_point()           # warm-up
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = ph1.solve(handoff="auto")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"scenarios phase 1 B=4 steps {int(out['iters'].max())} CR trips "
          f"{int(out['cr'])} wall {wall:.3f} s, K7 launches "
          f"{kernels.LAUNCHES['batched_cr_step']} | {card}", flush=True)
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = sv.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"scenarios end to end B=4 wall {wall:.3f} s, statuses "
          f"{[st for st, _, _ in res]}, K7 launches "
          f"{kernels.LAUNCHES['batched_cr_step']} | {card}", flush=True)


def part_polish(data, args, card):
    from torch.profiler import ProfilerActivity, profile
    from ipx_tpu_torch.parallel import batch2
    backend.cuda_device()
    sv = batch.BatchedScenarioSolver(
        data, scenarios(data, 4),
        parameters=Parameters(display=0, device="cuda"))
    state = batch.BatchedPhase1Solver(
        sv.blp, feasibility_tol=sv.phase1_tol, optimality_tol=sv.phase1_tol,
        device="cuda").solve(handoff="auto")
    # the mean-scenario basis, as BatchedScenarioSolver._polish builds it
    p = sv._params()
    p.dualize, p.scale, p.crossover, p.display = 0, 0, 0, 0
    s = sv._load(p)
    if s.solve() != 1000 or s.basis.factorize() != 0:
        raise RuntimeError("the mean-scenario solve or its basis failed")
    pol = batch2.SharedBasisBatchedPolish(sv.blp, s.basis, maxiter=40,
                                          device="cuda")
    cr_solve, cr_wall = pol._ph1._cr_solve, [0.0]

    def timed_cr(*a):
        t0 = time.perf_counter()
        out = cr_solve(*a)
        cr_wall[0] += time.perf_counter() - t0
        return out

    pol._ph1._cr_solve = timed_cr
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = pol.run(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(f"polish B=4 m={sv.m} n={sv.n}: {len(pol.step_cr)} steps, "
          f"{pol.total_cr_iters} shared-basis CR iterations (per step "
          f"{pol.step_cr}), {int(out['done'].sum())} lanes done, corrected "
          f"solves {pol.corrected_solves}, basis updates "
          f"{pol.basis_updates}, failures {pol.correction_failures}/"
          f"{pol.refresh_failures}; wall {wall:.3f} s, host CR "
          f"{cr_wall[0]:.3f} s ({cr_wall[0] / wall:.1%}); final mu "
          f"{' '.join(f'{v:.3e}' for v in out['mu'])} | {card}", flush=True)
    top_items("polish", prof, wall, card)


def part_sharded(data, args, card):
    from torch.profiler import ProfilerActivity, profile
    from ipx_tpu_torch.parallel import sharding
    dev = backend.cuda_device()
    host, _, _ = solve(data, "cpu", stop_at_switch=1)
    A = host.basis.model.A
    m, n = A.shape
    B, P = 256, 4
    rng = np.random.default_rng(args.seed)

    def t(x):
        return torch.from_numpy(np.asarray(x, dtype=np.float64)).to(dev)

    snm = sharding.ShardedNormalMatrix(A, P, dev)
    sn = SplittedNormalMatrix(host.basis.model)
    sn.prepare(host.basis, host.iterate.scaling_factors())
    nnt = sharding.ShardedSplittedNNt(*sn.N.shape, P, dev)
    nnt.set_operand(sn.N)
    w = t(rng.standard_normal(m))
    v = t(rng.standard_normal(m))
    parts, scale = t(rng.standard_normal((P, n, B))), t(
        rng.uniform(0.5, 2.0, (n, B)))
    parts1, scale1 = t(rng.standard_normal((P, n))), t(
        rng.uniform(0.5, 2.0, n))
    A2 = A.copy()
    A2.data **= 2
    W = 10.0 ** rng.uniform(-2, 2, n + m)
    cr = (snm, t(W[:n]), t(W[n:]), t(1.0 / (A2 @ W[:n] + W[n:])),
          t(1.0 / np.sqrt(W[n:])), t(rng.standard_normal(m)), 0.0, 20)
    Wb = rng.uniform(0.5, 2.0, (n + m, B))
    bcr = (snm, t(Wb[:n]), t(Wb[n:]), t(1.0 / (A2 @ Wb[:n] + Wb[n:])),
           t(rng.standard_normal((m, B))), 0.0, 10)
    op = snm.op_At_split
    ops = (snm.op_At_split, snm.op_At, snm.op_A)
    cases = [
        ("K4 P=4 (plan)", lambda: sharding.block_nnt(nnt, w),
         lambda: sharding.block_nnt_plain(nnt.blocks, w), 100),
        ("K14v (4, n)", lambda: kernels.block_spmv_sum(op, v, scale1),
         lambda: spmv.split_spmv_plain(op, v, scale1), 100),
        ("K14 (4, n, 256)", lambda: sharding.block_sum(parts, scale),
         lambda: sharding.block_sum_plain(parts, scale), 20),
        ("K14 (4, n)", lambda: sharding.block_sum(parts1, scale1),
         lambda: sharding.block_sum_plain(parts1, scale1), 100),
        ("K15 20 trips", lambda: sharding.sharded_cr(*cr),
         lambda: sharding.sharded_cr_plain(*cr), 5),
        ("K16 10 trips", lambda: sharding.sharded_batched_cr(*bcr),
         lambda: sharding.sharded_batched_cr_plain(*bcr), 3)]
    profile_cases(cases, card)
    del cases, parts, scale
    # K15's two forms: the cooperative launch and the host-issued passes
    k15 = {c: (lambda c=c: kernels.ShardedCrStep(
        snm.op_At_split, snm.op_A, *cr[1:6], True).solve(
            20, 0.0, cooperative=c == "cooperative"))
        for c in ("cooperative", "host-issued")}
    kernels.reset_launches()
    _, it, _, _ = k15["cooperative"]()
    print(f"sharded K15 cooperative: 20 trips in {it}; one solve launched "
          f"{ {k: v for k, v in kernels.LAUNCHES.items() if v} }, applies "
          f"inside it {kernels.INSIDE['block_spmv_sum']} K14v and "
          f"{kernels.INSIDE['csr_spmv']} K1 | {card}", flush=True)
    profile_forms("K15 20 trips", k15, ("cooperative", "host-issued"), 5,
                  20, card)
    # K16's apply and its 10-trip solve, the fused apply against the
    # three-stage one
    plan = kernels.block_plan_of(*ops)
    Ws, Wl, V = bcr[1], bcr[2], bcr[4]
    e = lambda *s: torch.empty(s, dtype=torch.float64, device=dev)  # noqa
    out, pc = e(m, B), e(sum(plan.partials_rows(B, plan.width(Ws, Wl, V,
                                                              V))), B)
    pu = (e(P, n, B), e(n, B))
    apply = {"fused": lambda: plan(Ws, Wl, V, out=out, partials=pc,
                                   fused=True),
             "three-stage": lambda: plan(Ws, Wl, V, out=out, partials=pc,
                                         parts=pu[0], U=pu[1], fused=False)}
    print(f"sharded K16 plan: {'fused' if plan.fused else 'three-stage'} "
          f"(sum len^2 / nnz {snm.op_At_split.sq_rows / A.nnz:.2f}) | "
          f"{card}", flush=True)
    profile_forms("K16 apply", apply, ("fused", "three-stage"), 20, 1, card)
    del pu, apply
    torch.cuda.empty_cache()
    k16 = {f: (lambda f=f: kernels.ShardedBatchedCrStep(
        *ops, *bcr[1:5], fused=f == "fused").solve(10, 0.0))
        for f in ("fused", "three-stage")}
    profile_forms("K16 10 trips", k16, ("fused", "three-stage"), 3, 10,
                  card)
    del cr, bcr, nnt, k15, k16
    for device in ("cuda", "auto"):
        prof = (profile(activities=[ProfilerActivity.CUDA])
                if device == "cuda" else None)
        kernels.reset_launches()
        s, st, wall = solve(data, device, profiler=prof, shards=P)
        i = s.get_info()
        cr = s.model._sharded_cr[1]
        L, IN = kernels.LAUNCHES, kernels.INSIDE
        times = " ".join(f"{f[5:]} {getattr(i, f):.3f}" for f in PHASES)
        print(f"sharded shards={P} device={device:4s} status {st} wall "
              f"{wall:.3f} s{' (profiled)' if prof else ''} | {times} | IPM "
              f"{i.iter} CR {i.kktiter1}+{i.kktiter2} | K15 "
              f"{L['sharded_cr_step']} launches for {cr.solves} sharded CR "
              f"solves ({cr.iterations} trips); applies inside K15: K14v "
              f"{IN['block_spmv_sum']}, K1 {IN['csr_spmv']}; launched alone: "
              f"K14v {L['block_spmv_sum']}, K1 {L['csr_spmv']} | {card}",
              flush=True)
        if prof is not None:
            top_items("sharded", prof, wall, card)


def part_entry(data, args, card):
    from ipx_tpu_torch import entry
    step, (S,) = entry.entry()
    solver = step.__self__
    plain = batch.PlainBatchedPhase1Solver(solver.lp, maxiter=50,
                                           device="cuda",
                                           cr_dtype=solver.cr_dtype)

    def fresh():
        return {k: v.clone() if torch.is_tensor(v) else v
                for k, v in S.items()}

    profile_cases([("entry step", lambda: step(fresh()),
                    lambda: plain._ipm_step(fresh()), 20)], card)
    t0 = time.perf_counter()
    entry.dryrun_multichip(4)
    torch.cuda.synchronize()
    print(f"entry dryrun_multichip(4) on one card: wall "
          f"{time.perf_counter() - t0:.3f} s | {card}", flush=True)


PARTS = {"e2e": part_e2e, "native": part_native, "threads": part_threads,
         "precision": part_precision, "walls": part_walls,
         "binding": part_binding, "guard": part_guard,
         "counts": part_counts,
         "kernels": part_kernels,
         "busy": part_busy, "batched": part_batched, "stage": part_stage,
         "scenarios": part_scenarios, "polish": part_polish,
         "sharded": part_sharded, "entry": part_entry, "k6": part_k6,
         "k5": part_k5, "k13": part_k13, "k17": part_k17, "k2": part_k2}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--what",
                    default="e2e,native,kernels,busy,batched,stage,polish",
                    help="comma-separated parts: " + ", ".join(PARTS))
    ap.add_argument("--turns", type=int, default=2,
                    help="solves per path in the e2e part")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the vectors in the kernels part")
    ap.add_argument("--forms", default="levels,sweep,three,one",
                    help="the forms the k17 part (levels, sweep) and the "
                         "k2 part (three, one) time")
    ap.add_argument("--runs", type=int, default=20,
                    help="fresh processes of each form in the counts part")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card: torch.cuda.is_available() is False")
    parts = args.what.split(",")
    unknown = set(parts) - set(PARTS)
    if unknown:
        sys.exit(f"unknown parts {sorted(unknown)}; expected {list(PARTS)}")
    card = card_name()
    backend.cuda_device()           # build the kernels before any timing
    print(host_line(), flush=True)
    data = testgen.transportation(*INSTANCE[:3], seed=INSTANCE[3])
    for part in parts:
        PARTS[part](data, args, card)


if __name__ == "__main__":
    main()
