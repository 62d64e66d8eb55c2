"""Where the time of an ipx_tpu_torch solve goes, on one NVIDIA card.

Usage, from the repository root on a machine with the card:

    python tools/torch_profile.py [--what e2e,native,kernels,busy]
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
           the iteration counts, with the OpenMP settings in force;
  native   milliseconds per call of the native vector kernels of
           ipx_tpu/native (ipxlu.cc) inside one port solve and one host
           solve, from cProfile;
  kernels  K1-K4 and their plain versions at the shapes of the presolved
           LP: host wall time per call and device time per call from
           torch.profiler, and the device's busy share over the calls;
  busy     device time over wall time of one port solve, from
           torch.profiler, with the ten kernels and copies that took most;
  batched  K5-K13 and their plain versions at the shapes of that LP as a
           batch of 256 scenarios (chip_smoke.py phase 5): host wall time
           and device time per call;
  stage    the batched phase 1 of chip_smoke.py phase 6
           (BatchedPhase1Solver(device="cuda"), B = 256, handoff "auto"):
           wall time, device busy share and the ten largest device items,
           each named by its kernel (K1-K13) where it is one;
  polish   one full shared-basis polish (SharedBasisBatchedPolish,
           device="cuda", 40 steps at most, as BatchedScenarioSolver runs
           it) of 4 scenarios from their batched phase-1 handoff: steps,
           shared-basis CR iterations, wall time, the host CR's share,
           device time and busy share, and the largest device items.

It imports torch and ipx_tpu_torch only, and no jax.
"""
import argparse
import cProfile
import os
import pstats
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from ipx_tpu_torch import LpSolver, Parameters, backend, kernels  # noqa: E402
from ipx_tpu_torch.host import (SplittedNormalMatrix,  # noqa: E402
                                normal_diag, testgen)
from ipx_tpu_torch.ops import device_cr, device_cr2, spmv  # noqa: E402
from ipx_tpu_torch.parallel import batch  # noqa: E402

from chip_smoke import scenarios  # noqa: E402

INSTANCE = (8000, 12000, 0.001, 1)
OMP_VARS = ("OMP_NUM_THREADS", "OMP_WAIT_POLICY", "OMP_PROC_BIND")
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


def part_e2e(data, args, card):
    env = " ".join(f"{k}={os.environ.get(k, '-')}" for k in OMP_VARS)
    for _ in range(args.turns):
        for device in ("cuda", "cpu"):
            s, st, wall = solve(data, device)
            i = s.get_info()
            times = " ".join(f"{f[5:]} {getattr(i, f):.3f}" for f in PHASES)
            print(f"e2e {env} torch_threads {torch.get_num_threads()} | "
                  f"device={device:4s} status {st} wall {wall:.3f} s | "
                  f"{times} | IPM {i.iter} CR {i.kktiter1}+{i.kktiter2} | "
                  f"{card}", flush=True)


def part_native(data, args, card):
    for device in ("cuda", "cpu"):
        prof = cProfile.Profile()
        _, st, wall = solve(data, device, profiler=prof)
        per = {}
        for (_, _, name), (_, ncalls, tottime, _, _) in \
                pstats.Stats(prof).stats.items():
            if name in NATIVE:
                calls, t = per.get(name, (0, 0.0))
                per[name] = (calls + ncalls, t + tottime)
        calls = " ".join(f"{k} {t / c * 1e3:.3f} ms x{c}"
                         for k, (c, t) in sorted(per.items()))
        print(f"native device={device:4s} status {st} wall {wall:.3f} s "
              f"(under cProfile) | {calls} | {card}", flush=True)


# the port's kernel of each CUDA function of csrc/, by name prefix
KERNEL_OF = (("csr_spmv", "K1/K2/K4"), ("reduce_sum", "K2"),
             ("cr_step", "K3"), ("csr_spmm", "K5/K6"), ("lane_sum", "K6"),
             ("bcr_", "K7"), ("step_", "K8"), ("muaff", "K8"),
             ("ipm_update", "K9"), ("prologue_", "K10"), ("mu_", "K10"),
             ("newton_rhs", "K11"), ("normal_rhs", "K11"),
             ("newton_dx", "K12"), ("recover_", "K12"), ("start_", "K13"))


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
        ("K4 f64", lambda: kernels.nnt(dsc._Nt, dsc._N, w),
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
        wall = time.perf_counter() - t0
        print(f"stage {label} B={blp.batch} steps {int(out['iters'].max())} "
              f"CR trips {int(out['cr'])} wall {wall:.3f} s | {card}",
              flush=True)
    top_items("stage", prof, wall, card)


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


PARTS = {"e2e": part_e2e, "native": part_native, "kernels": part_kernels,
         "busy": part_busy, "batched": part_batched, "stage": part_stage,
         "polish": part_polish}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--what",
                    default="e2e,native,kernels,busy,batched,stage,polish",
                    help="comma-separated parts: " + ", ".join(PARTS))
    ap.add_argument("--turns", type=int, default=2,
                    help="solves per path in the e2e part")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the vectors in the kernels part")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card: torch.cuda.is_available() is False")
    parts = args.what.split(",")
    unknown = set(parts) - set(PARTS)
    if unknown:
        sys.exit(f"unknown parts {sorted(unknown)}; expected {list(PARTS)}")
    card = card_name()
    backend.cuda_device()           # build the kernels before any timing
    data = testgen.transportation(*INSTANCE[:3], seed=INSTANCE[3])
    for part in parts:
        PARTS[part](data, args, card)


if __name__ == "__main__":
    main()
