#!/usr/bin/env python3
"""Smoke test of ipx_tpu_torch on one NVIDIA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device, nvcc and g++. It imports torch and ipx_tpu_torch
only: no jax, and no module of ipx_tpu except through ipx_tpu_torch.

  0. the card (nvidia-smi name and power limit) and the versions;
  1. builds the CUDA kernels (nvcc) and the native host library (g++);
  2. holds each kernel against its plain PyTorch version on the card, at
     the shapes of the 20k-row transportation LP after presolve, and times
     both (median of CUDA-event timings after warm-up);
  3. solves afiro through ipx_tpu_torch.LpSolver(device="cuda");
  4. solves transportation(8000, 12000, 0.001, seed=1) through
     ipx_tpu_torch.LpSolver(device="cuda") with every launch counter set to
     0 just before, and through LpSolver(device="cpu"), the host path that
     launches none of the kernels, and compares;
  5. holds the batched kernels K5-K9 against their plain versions at the
     shapes of that LP as a batch of B = 256 scenarios (m = 20 000,
     n + m = 116 002), in float64 and float32, and K10-K13, the rest of the
     batched IPM step, in float64, and times both;
  6. runs BatchedPhase1Solver(device="cuda") over those 256 scenarios to
     the handoff (tolerance 1e-4), with the counters set to 0 just before,
     and checks a small stage against the same solver with the plain
     versions on the card;
  7. solves the first 4 scenarios end to end through
     BatchedScenarioSolver(parameters=Parameters(device="cuda")), the
     batched phase 1 and the port's LpSolver finishes, with the counters
     set to 0 just before, against cold LpSolver(device="cpu") solves;
  8. runs the shared-basis polish (parallel/batch2.py) on 4 lanes of the
     phase-6 handoff state for POLISH_STEPS steps through the kernels, with
     the counters set to 0 just before, and through the plain versions on
     the card with the kernel run's shared-basis CR solutions; then
     BatchedScenarioSolver(phase2_polish=True) end to end on a small LP.
    The plain run replays the kernel run's host CR solutions.

It stops with a non-zero exit at the first failure. The line before the
last is a JSON object with one entry per kernel, whose launch counts are
those of phase 7; the last line is {"ok": true, "device": {...}}.
"""
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

T_START = time.perf_counter()
AFIRO = -464.7531428566996
RTOL = {"float64": 1e-12, "float32": 1e-5}
REPS = 20


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def cuda_ms(fn, reps=REPS, warm=3):
    """Median milliseconds of fn() on the card, from CUDA events."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs(a, b):
    return float((a.double() - b.double()).abs().max())


def rel_err(got, want):
    want = want.double()
    return max_abs(got, want) / max(float(want.abs().max()), 1e-300)


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")

    # -- phase 0: the card ----------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"phase 0: {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}", flush=True)

    # -- phase 1: builds ------------------------------------------------------
    from ipx_tpu_torch import LpSolver, Parameters, backend, build, kernels
    from ipx_tpu_torch.host import (SplittedNormalMatrix, build_native,
                                    normal_diag, testgen as tg)
    from ipx_tpu_torch.ops import device_cr, device_cr2, spmv
    from ipx_tpu_torch.parallel import batch

    t0 = time.perf_counter()
    build.build(force=True)
    dev = backend.cuda_device()
    t_nvcc = time.perf_counter() - t0
    t0 = time.perf_counter()
    build_native()
    t_gxx = time.perf_counter() - t0
    print(f"phase 1: CUDA kernels built by nvcc for sm_90a in {t_nvcc:.2f} s;"
          f" native host library by g++ in {t_gxx:.2f} s", flush=True)

    # -- phase 2: kernels against their plain versions -------------------------
    data = tg.transportation(8000, 12000, 0.001, seed=1)
    host = LpSolver(Parameters(display=0, device="cpu", stop_at_switch=1))
    check(tg.load_into_solver(data, host) == 0, "load_model failed")
    host.solve()
    check(host.basis is not None, "no basis at the phase switch")
    md = host.basis.model
    m, n = md.num_rows, md.num_cols
    print(f"phase 2: presolved model m={m} n={n} nnz(A)={md.A.nnz}; "
          f"{card}", flush=True)
    rng = np.random.default_rng(0)
    rows = {}

    def report(name, case, err, tol, ms, plain_ms):
        print(f"  {name:15s} {case:30s} rel_err {err:.3e} (tol {tol:.0e}) "
              f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms | {card}",
              flush=True)
        check(err <= tol, f"{name} {case}: relative error {err:.3e} > "
              f"{tol:.0e}")

    def t(x, dtype):
        return torch.from_numpy(np.asarray(x, dtype=np.float64)).to(
            dtype).to(dev)

    # K1 on A and A', f64 and f32
    for dtype in (torch.float64, torch.float32):
        dn = str(dtype).split(".")[1]
        nmd = spmv.NormalMatrixDevice(md.A, dev, dtype)
        for opname, op, x in (("A u", nmd.op_A, t(rng.standard_normal(n),
                                                    dtype)),
                              ("A' v", nmd.op_At, t(rng.standard_normal(m),
                                                     dtype))):
            y = kernels.csr_spmv(op, x)
            y_p = spmv.csr_spmv_plain(op, x)
            torch.cuda.synchronize()
            err = rel_err(y, y_p)
            ms = cuda_ms(lambda: kernels.csr_spmv(op, x))
            pms = cuda_ms(lambda: spmv.csr_spmv_plain(op, x))
            report("K1 csr_spmv", f"{opname} {dn} (vec {op.vec})", err,
                   RTOL[dn], ms, pms)
            if opname == "A u" and dtype == torch.float64:
                rows["csr_spmv"] = dict(
                    case="A u, f64", max_abs_err=max_abs(y, y_p), ms=ms,
                    plain_ms=pms)

        # K2 (Cv, v.Cv)
        W = t(10.0 ** rng.uniform(-2, 2, n + m), dtype)
        v = t(rng.standard_normal(m), dtype)
        Cv, vCv = spmv.normal_apply(nmd, W, v)
        Cv_p, vCv_p = spmv.normal_apply_plain(nmd, W, v)
        torch.cuda.synchronize()
        err = max(rel_err(Cv, Cv_p),
                  abs(float(vCv) - float(vCv_p)) / abs(float(vCv_p)))
        ms = cuda_ms(lambda: spmv.normal_apply(nmd, W, v))
        pms = cuda_ms(lambda: spmv.normal_apply_plain(nmd, W, v))
        report("K2 normal_apply", f"(Cv, v.Cv) {dn}", err, RTOL[dn], ms, pms)
        if dtype == torch.float32:
            rows["normal_apply"] = dict(
                case="(Cv, v.Cv), f32", max_abs_err=max_abs(Cv, Cv_p),
                ms=ms, plain_ms=pms)

    # K3: whole CR solves against the plain-torch CR on the card
    Wh = 10.0 ** rng.uniform(-2, 2, n + m)
    diag = normal_diag(md.A, Wh)
    resscale = 1.0 / np.sqrt(Wh[n:])
    rhs = rng.standard_normal(m)
    tol = 1e-8 * float(np.max(np.abs(resscale * rhs)))

    def scaled_res(y):
        res = rhs - (md.A @ (Wh[:n] * (y @ md.A_csr)) + Wh[n:] * y)
        return float(np.max(np.abs(resscale * res)))

    class PlainNormalCR(device_cr.DeviceNormalCR):
        inner_solve = staticmethod(device_cr.cr_solve_plain)

    class PlainMixedCR(device_cr.MixedPrecisionDeviceCR):
        inner_solve = staticmethod(device_cr.cr_solve_plain)

    for label, kern, plain, mixed in (
            ("DeviceNormalCR f64",
             device_cr.DeviceNormalCR(md, Wh, diag, resscale, dev),
             PlainNormalCR(md, Wh, diag, resscale, dev), False),
            ("MixedPrecisionDeviceCR",
             device_cr.MixedPrecisionDeviceCR(md, Wh, diag, resscale,
                                              device=dev),
             PlainMixedCR(md, Wh, diag, resscale, device=dev), True)):
        y, it, err, _, _ = kern.solve(rhs, tol, -1)
        y_p, it_p, err_p, _, _ = plain.solve(rhs, tol, -1)
        torch.cuda.synchronize()
        r, r_p = scaled_res(y), scaled_res(y_p)
        print(f"  K3 cr_step       {label}: iters {it} (plain {it_p}), errflag"
              f" {err} (plain {err_p}), scaled residual {r:.2e} (plain "
              f"{r_p:.2e}, tol {tol:.2e})", flush=True)
        check(err == err_p == 0, f"{label}: errflag {err} / plain {err_p}")
        check(r <= tol and r_p <= tol, f"{label}: residual above tol")
        if mixed:
            check(abs(it - it_p) <= 0.1 * it_p,
                  f"{label}: iterations {it} vs plain {it_p} beyond 10%")
        else:
            check(abs(it - it_p) <= 2,
                  f"{label}: iterations {it} vs plain {it_p} beyond 2")
        yt, ypt = torch.from_numpy(y), torch.from_numpy(y_p)
        ms = cuda_ms(lambda: kern.solve(rhs, tol, -1), warm=1)
        pms = cuda_ms(lambda: plain.solve(rhs, tol, -1), warm=1)
        if mixed:   # f32 rounding moves the refinement passes
            print(f"  K3 cr_step       {label + ' solve':30s} rel_err "
                  f"{rel_err(yt, ypt):.3e} kernel {ms:.4f} ms  plain "
                  f"{pms:.4f} ms | {card}", flush=True)
        else:
            report("K3 cr_step", f"{label} solve", rel_err(yt, ypt), 1e-8,
                   ms, pms)
        if mixed:
            rows["cr_step"] = dict(case="MixedPrecisionDeviceCR solve",
                                   max_abs_err=max_abs(yt, ypt), ms=ms,
                                   plain_ms=pms)

    # K4 on a prepared SplittedNormalMatrix
    sn = SplittedNormalMatrix(md)
    sn.prepare(host.basis, host.iterate.scaling_factors())
    dsc = device_cr2.DeviceSplittedCR(md, dev)
    dsc.prepare(sn)
    w = t(rng.standard_normal(m), torch.float64)
    z = kernels.nnt(dsc._Nt, dsc._N, w)
    z_p = device_cr2.nnt_plain(dsc._Nt, dsc._N, w)
    torch.cuda.synchronize()
    ms = cuda_ms(lambda: kernels.nnt(dsc._Nt, dsc._N, w))
    pms = cuda_ms(lambda: device_cr2.nnt_plain(dsc._Nt, dsc._N, w))
    report("K4 nnt", f"N (N' w) f64, nnz(N)={sn.N.nnz}", rel_err(z, z_p),
           1e-12, ms, pms)
    rows["nnt"] = dict(case="N (N' w), f64", max_abs_err=max_abs(z, z_p),
                       ms=ms, plain_ms=pms)
    del host

    # -- phase 3: afiro ----------------------------------------------------------
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    from lp_fixtures import afiro
    s = LpSolver(Parameters(display=0, debug=1, device="cuda"))
    check(afiro().load_into(s) == 0, "afiro load failed")
    st = s.solve()
    info = s.get_info()
    e_obj = abs(info.objval - AFIRO) / abs(AFIRO)
    e_pobj = abs(info.pobjval - AFIRO) / abs(AFIRO)
    print(f"phase 3: afiro status {st}, objval {info.objval!r} (rel err "
          f"{e_obj:.1e}), pobjval {info.pobjval!r} (rel err {e_pobj:.1e}), "
          f"IPM iters {info.iter}, CR iters {info.kktiter1}+"
          f"{info.kktiter2}", flush=True)
    check(st == 1000, f"afiro status {st}")
    check(e_obj <= 1e-9, "afiro vertex objective")
    check(e_pobj <= 1e-8, "afiro interior objective beyond the IPM tolerance")

    # -- phase 4: the main path ------------------------------------------------
    port = LpSolver(Parameters(display=0, debug=1, device="cuda"))
    check(tg.load_into_solver(data, port) == 0, "load_model failed")
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    st = port.solve()
    torch.cuda.synchronize()
    t_port = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    pi = port.get_info()

    # the reference: device="cpu" runs ipx_tpu's host pipeline and launches
    # none of the port's kernels
    ref = LpSolver(Parameters(display=0, device="cpu"))
    check(tg.load_into_solver(data, ref) == 0, "load_model failed")
    t0 = time.perf_counter()
    st_ref = ref.solve()
    t_ref = time.perf_counter() - t0
    check(kernels.LAUNCHES == launches, "the host path launched a kernel")
    ri = ref.get_info()
    e_obj = abs(pi.objval - ri.objval) / abs(ri.objval)
    def times(i):
        return (f"ipm1 {i.time_ipm1:.3f} s, ipm2 {i.time_ipm2:.3f} s, maxvol "
                f"{i.time_maxvol:.3f} s, cr1 {i.time_cr1:.3f} s, cr2 "
                f"{i.time_cr2:.3f} s (NNt {i.time_cr2_NNt:.3f} s, B "
                f"{i.time_cr2_B:.3f} s, Bt {i.time_cr2_Bt:.3f} s)")

    print(f"phase 4: transportation(8000, 12000, 0.001, 1) m={m} n={n}\n"
          f"  port  device=cuda: status {st}, objval {pi.objval!r}, wall "
          f"{t_port:.3f} s, IPM iters {pi.iter}, CR iters "
          f"{pi.kktiter1}+{pi.kktiter2}; {times(pi)}\n"
          f"  host  device=cpu:  status {st_ref}, objval {ri.objval!r}, wall "
          f"{t_ref:.3f} s, IPM iters {ri.iter}, CR iters "
          f"{ri.kktiter1}+{ri.kktiter2}; {times(ri)}\n"
          f"  objective rel diff {e_obj:.1e}; launches {launches}; {card}",
          flush=True)
    check(st == 1000 and st_ref == 1000, f"status {st} / host {st_ref}")
    check(e_obj <= 1e-8, f"objective differs by {e_obj:.1e}")
    check(pi.kktiter1 > 0 and pi.kktiter2 > 0, "a phase ran no device CR")
    check(pi.time_cr2_NNt > 0, "no device N N' time")
    for name in ("csr_spmv", "normal_apply", "cr_step", "nnt"):
        check(launches[name] > 0, f"kernel {name} was not launched in "
              "phase 4")
    check("jax" not in sys.modules, "jax was imported")

    del port, ref
    t_batched = time.perf_counter()
    batched_rows, launches = batched_phases(card, data, dev, rng)
    rows.update(batched_rows)
    print(f"phases 5-8 took {time.perf_counter() - t_batched:.1f} s; the "
          f"script {time.perf_counter() - T_START:.1f} s", flush=True)

    print(card, flush=True)
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=SOURCE[name],
             replaces=REPLACES[name], launches=launches[name], **rows[name])
        for name in SOURCE]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


SOURCE = {"csr_spmv": "ipx_tpu_torch/csrc/spmv.cu",
          "normal_apply": "ipx_tpu_torch/csrc/spmv.cu",
          "cr_step": "ipx_tpu_torch/csrc/cr.cu",
          "nnt": "ipx_tpu_torch/csrc/spmv.cu",
          "csr_spmm": "ipx_tpu_torch/csrc/spmm.cu",
          "normal_apply_batched": "ipx_tpu_torch/csrc/spmm.cu",
          "batched_cr_step": "ipx_tpu_torch/csrc/batch_cr.cu",
          "step_batch": "ipx_tpu_torch/csrc/ipm_step.cu",
          "ipm_update": "ipx_tpu_torch/csrc/ipm_step.cu",
          "ipm_prologue": "ipx_tpu_torch/csrc/ipm_prologue.cu",
          "newton_rhs": "ipx_tpu_torch/csrc/newton.cu",
          "newton_recover": "ipx_tpu_torch/csrc/newton.cu",
          "starting_point": "ipx_tpu_torch/csrc/start.cu"}
REPLACES = {"csr_spmv": "ipx_tpu/ops/spmv.py:93",
            "normal_apply": "ipx_tpu/ops/spmv.py:226",
            "cr_step": "ipx_tpu/ops/device_cr.py:85",
            "nnt": "ipx_tpu/ops/device_cr2.py:116",
            "csr_spmm": "ipx_tpu/ops/spmv.py:109",
            "normal_apply_batched": "ipx_tpu/ops/spmv.py:157",
            "batched_cr_step": "ipx_tpu/parallel/batch.py:209",
            "step_batch": "ipx_tpu/parallel/batch.py:604",
            "ipm_update": "ipx_tpu/parallel/batch.py:534",
            "ipm_prologue": "ipx_tpu/parallel/batch.py:411",
            "newton_rhs": "ipx_tpu/parallel/batch.py:465",
            "newton_recover": "ipx_tpu/parallel/batch.py:473",
            "starting_point": "ipx_tpu/parallel/batch.py:331"}
BATCHED = ("csr_spmm", "normal_apply_batched", "batched_cr_step",
           "step_batch", "ipm_update", "ipm_prologue", "newton_rhs",
           "newton_recover", "starting_point")
# the kernels of a polish step: its CR runs on the host
POLISH = ("csr_spmm", "step_batch", "ipm_update", "ipm_prologue",
          "newton_rhs", "newton_recover")
B_FULL = 256
POLISH_STEPS = 3


def scenarios(data, B):
    """The B scenarios of tools/device_batch_solve_bench.py: supplies (the
    first 8000 rows, '<') times U(1.0, 1.1), demands times U(0.9, 1.0),
    from default_rng(0)."""
    m, ns = data["num_constr"], 8000
    rng = np.random.default_rng(0)
    fac = np.empty((B, m))
    fac[:, :ns] = rng.uniform(1.0, 1.1, size=(B, ns))
    fac[:, ns:] = rng.uniform(0.9, 1.0, size=(B, m - ns))
    return data["rhs"][None, :] * fac


def batched_phases(card, data, dev, rng):
    """Phases 5-8; returns the kernel rows of K5-K13 and the launch counts
    of phase 7."""
    import torch
    from ipx_tpu_torch import LpSolver, Parameters, kernels
    from ipx_tpu_torch.host import testgen as tg
    from ipx_tpu_torch.ops import spmv
    from ipx_tpu_torch.parallel import batch

    rows = {}
    b_batch = scenarios(data, B_FULL)
    blp = batch.BatchedScenarioSolver(data, b_batch).blp
    m, n = blp.A.shape
    nm = n + m
    B = B_FULL

    def report(name, case, err, tol, ms, plain_ms):
        print(f"  {name:22s} {case:34s} err {err:.3e} (tol {tol:.0e}) "
              f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms | {card}",
              flush=True)
        check(err <= tol, f"{name} {case}: error {err:.3e} > {tol:.0e}")

    def t(x, dtype):
        return torch.from_numpy(np.asarray(x, dtype=np.float64)).to(
            dtype).to(dev)

    # -- phase 5: K5-K9 against their plain versions -----------------------------
    print(f"phase 5: batched kernels at m={m} n={n} nnz(A)={blp.A.nnz} "
          f"B={B}; {card}", flush=True)
    A2 = blp.A.copy()
    A2.data **= 2
    for dtype in (torch.float64, torch.float32):
        dn = str(dtype).split(".")[1]
        nmd = spmv.NormalMatrixDevice(blp.A, dev, dtype)
        for opname, op, X in (
                ("A U", nmd.op_A, t(rng.standard_normal((n, B)), dtype)),
                ("A' V", nmd.op_At, t(rng.standard_normal((m, B)), dtype))):
            Y = kernels.csr_spmm(op, X)
            Y_p = spmv.csr_spmm_plain(op, X)
            torch.cuda.synchronize()
            ms = cuda_ms(lambda: kernels.csr_spmm(op, X))
            pms = cuda_ms(lambda: spmv.csr_spmm_plain(op, X))
            report("K5 csr_spmm", f"{opname} {dn}", rel_err(Y, Y_p),
                   RTOL[dn], ms, pms)
            if opname == "A' V" and dtype == torch.float32:
                rows["csr_spmm"] = dict(case="A' V, f32, B=256",
                                        max_abs_err=max_abs(Y, Y_p), ms=ms,
                                        plain_ms=pms)
        W = t(10.0 ** rng.uniform(-2, 2, (nm, B)), dtype)
        V = t(rng.standard_normal((m, B)), dtype)
        out, dots = spmv.normal_apply_batched(nmd, W, V)
        out2, dots2 = spmv.normal_apply_batched(nmd, W, V)
        out_p, dots_p = spmv.normal_apply_batched_plain(nmd, W, V)
        torch.cuda.synchronize()
        check(torch.equal(out, out2) and torch.equal(dots, dots2),
              "K6 is not repeatable bit for bit")
        err = max(rel_err(out, out_p), float(
            ((dots.double() - dots_p.double()).abs()
             / dots_p.double().abs()).max()))
        ms = cuda_ms(lambda: spmv.normal_apply_batched(nmd, W, V))
        pms = cuda_ms(lambda: spmv.normal_apply_batched_plain(nmd, W, V))
        report("K6 normal_apply_batch", f"(CV, V.CV) {dn}", err, RTOL[dn],
               ms, pms)
        if dtype == torch.float32:
            rows["normal_apply_batched"] = dict(
                case="(CV, V.CV), f32, B=256",
                max_abs_err=max_abs(out, out_p), ms=ms, plain_ms=pms)

        # K7: whole batched CR solves, lanes with different tolerances
        Wc = 10.0 ** rng.uniform(-1, 1, (nm, B))
        diag = A2 @ Wc[:n] + Wc[n:]
        rs = 1.0 / np.sqrt(Wc[n:])
        rhs = rng.standard_normal((m, B))
        base = np.max(np.abs(rs * rhs), axis=0)
        rel_tol = (10.0 ** rng.uniform(-8, -6, B) if dtype == torch.float64
                   else 10.0 ** rng.uniform(-4, -3, B))
        args = (nmd, t(Wc, dtype), t(1.0 / diag, dtype), t(rs, dtype),
                t(rhs, dtype), t(base * rel_tol, dtype), 500)
        Yc, trips = batch.batched_cr(*args)
        Yc_p, trips_p = batch.batched_cr_plain(*args)
        torch.cuda.synchronize()
        res = rhs - (blp.A @ (Wc[:n] * (blp.A.T @ Yc.double().cpu().numpy()))
                     + Wc[n:] * Yc.double().cpu().numpy())
        met = bool(np.all(np.max(np.abs(rs * res), axis=0)
                          <= base * rel_tol * (1 + 1e-6)))
        ms = cuda_ms(lambda: batch.batched_cr(*args), reps=3, warm=1)
        pms = cuda_ms(lambda: batch.batched_cr_plain(*args), reps=3, warm=1)
        print(f"  K7 batched_cr_step     {dn}: trips {trips} (plain "
              f"{trips_p}), every lane meets its tolerance: {met}",
              flush=True)
        check(met, f"K7 {dn}: a lane misses its tolerance")
        if dtype == torch.float64:
            check(abs(trips - trips_p) <= 2, "K7 f64 trips beyond 2")
            report("K7 batched_cr_step", f"solve {dn} ({trips} trips)",
                   rel_err(Yc, Yc_p), 1e-8, ms, pms)
        else:
            check(abs(trips - trips_p) <= 0.1 * trips_p,
                  "K7 f32 trips beyond 10%")
            report("K7 batched_cr_step", f"solve {dn} ({trips} trips)",
                   rel_err(Yc, Yc_p), 1e-3, ms, pms)
            rows["batched_cr_step"] = dict(
                case=f"batched CR solve, f32, B=256, {trips} trips",
                max_abs_err=max_abs(Yc, Yc_p), ms=ms, plain_ms=pms)

        # K8 and K9 on an iterate-like state
        finl = torch.from_numpy(np.isfinite(blp.lb)).to(dev)
        finu = torch.from_numpy(np.isfinite(blp.ub)).to(dev)
        st = {}
        for name, fin in (("XL", finl), ("XU", finu), ("ZL", finl),
                          ("ZU", finu)):
            x = t(rng.uniform(1e-3, 10.0, (nm, B)), dtype)
            x[~fin] = float("inf") if name.startswith("X") else 0.0
            st[name] = x
            st["D" + name] = t(rng.standard_normal((nm, B)) * 5.0, dtype)
        order = ("XL", "XU", "ZL", "ZU", "DXL", "DXU", "DZL", "DZU")
        sargs = [st[k] for k in order] + [finl, finu]
        maxp, maxd = batch.step_batch(*sargs)
        maxp_p, maxd_p = batch.step_batch_plain(*sargs)
        mu = batch.muaff(*sargs, maxp, maxd, 12345)
        mu_p = batch.muaff_plain(*sargs, maxp, maxd, 12345)
        torch.cuda.synchronize()
        exact = torch.equal(maxp, maxp_p) and torch.equal(maxd, maxd_p)
        ms = cuda_ms(lambda: batch.step_batch(*sargs))
        pms = cuda_ms(lambda: batch.step_batch_plain(*sargs))
        report("K8 step_batch", f"(maxp, maxd) {dn}, exact {exact}",
               0.0 if exact else 1.0, 0.0, ms, pms)
        mms = cuda_ms(lambda: batch.muaff(*sargs, maxp, maxd, 12345))
        mpms = cuda_ms(lambda: batch.muaff_plain(*sargs, maxp, maxd, 12345))
        report("K8 step_batch", f"muaff {dn}", rel_err(mu, mu_p), RTOL[dn],
               mms, mpms)
        if dtype == torch.float64:
            rows["step_batch"] = dict(
                case="(maxp, maxd), f64, B=256",
                max_abs_err=max(max_abs(maxp, maxp_p),
                                max_abs(maxd, maxd_p)), ms=ms, plain_ms=pms)
        X, DX = t(rng.standard_normal((nm, B)), dtype), \
            t(rng.standard_normal((nm, B)), dtype)
        Yv, DY = t(rng.standard_normal((m, B)), dtype), \
            t(rng.standard_normal((m, B)), dtype)
        ap, ad = t(rng.uniform(0.1, 1.0, B), dtype), \
            t(rng.uniform(0.1, 1.0, B), dtype)
        done = torch.from_numpy(rng.random(B) < 0.25).to(dev)
        state = (X, st["XL"], st["XU"], Yv, st["ZL"], st["ZU"])
        dirs = (DX, st["DXL"], st["DXU"], DY, st["DZL"], st["DZU"], ap, ad,
                done, finl, finu)
        got = [x.clone() for x in state]
        want = [x.clone() for x in state]
        batch.ipm_update(*got, *dirs)
        batch.ipm_update_plain(*want, *dirs)
        torch.cuda.synchronize()
        exact = all(torch.equal(a, b) for a, b in zip(got, want))
        err = max(max_abs(a[torch.isfinite(b)], b[torch.isfinite(b)])
                  for a, b in zip(got, want))
        # timed in place, over and over on the same arrays
        ms = cuda_ms(lambda: batch.ipm_update(*got, *dirs))
        pms = cuda_ms(lambda: batch.ipm_update_plain(*want, *dirs))
        report("K9 ipm_update", f"6 arrays {dn}, exact {exact}",
               0.0 if exact else 1.0, 0.0, ms, pms)
        if dtype == torch.float64:
            rows["ipm_update"] = dict(case="in place, f64, B=256",
                                      max_abs_err=err, ms=ms, plain_ms=pms)
        del nmd, W, V, out, out2, out_p, st, sargs, state, dirs, got, want
        torch.cuda.empty_cache()
    rows.update(step_kernels(blp, dev, rng, report, t))
    torch.cuda.empty_cache()

    # -- phase 6: the batched phase 1 at full width -------------------------------
    ph1 = batch.BatchedPhase1Solver(blp, feasibility_tol=1e-4,
                                    optimality_tol=1e-4, device="cuda")
    check(ph1.cr_dtype == "f32", "cr_dtype auto is not f32 on the card")
    S0 = ph1._starting_point()      # also the warm-up of the kernels
    mu0 = ph1._mu_of(S0).cpu().numpy()
    del S0
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = ph1.solve(handoff="auto")
    torch.cuda.synchronize()
    t_stage = time.perf_counter() - t0
    stage_launches = dict(kernels.LAUNCHES)
    finl, finu = np.isfinite(blp.lb)[:, None], np.isfinite(blp.ub)[:, None]
    with np.errstate(invalid="ignore"):
        mu = (np.sum(np.where(finl, out["XL"] * out["ZL"], 0.0), axis=0)
              + np.sum(np.where(finu, out["XU"] * out["ZU"], 0.0), axis=0)
              ) / max(int(finl.sum() + finu.sum()), 1)
    steps = int(out["iters"].max())
    print(f"phase 6: BatchedPhase1Solver(device=\"cuda\", cr_dtype=f32) "
          f"B={B} m={m} n={n}: {steps} steps, {int(out['done'].sum())} "
          f"lanes converged, {int(out['cr'])} CR trips, wall "
          f"{t_stage:.3f} s; mu from median {np.median(mu0):.3e} / max "
          f"{mu0.max():.3e} to median {np.median(mu):.3e} / max "
          f"{mu.max():.3e}; launches "
          f"{ {k: stage_launches[k] for k in BATCHED} }; {card}",
          flush=True)
    for k in ("X", "Y", "ZL", "ZU", "pobj"):
        check(np.all(np.isfinite(out[k])), f"phase 6: {k} is not finite")
    check(np.all(mu < mu0), "phase 6: mu did not fall on every lane")
    for name in BATCHED:
        check(stage_launches[name] > 0, f"phase 6: {name} not launched")
    # 4 lanes of the handoff state for phase 8
    handoff = {k: np.ascontiguousarray(out[k][..., :4]) for k in (
        "X", "XL", "XU", "Y", "ZL", "ZU", "done", "iters")}
    del ph1, out

    # the whole stage, kernels against plain versions, on a small LP
    small = tg.transportation(60, 90, 0.05, seed=2)
    sb = small["rhs"][None, :] * np.random.default_rng(1).uniform(
        0.97, 1.03, (64, small["num_constr"]))
    sblp = batch.BatchedScenarioSolver(small, sb).blp
    t0 = time.perf_counter()
    got = batch.BatchedPhase1Solver(sblp, device="cuda", cr_dtype="f64"
                                    ).solve()
    t_k = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = batch.PlainBatchedPhase1Solver(sblp, device="cuda",
                                          cr_dtype="f64").solve()
    t_p = time.perf_counter() - t0
    dp = float(np.max(np.abs(got["pobj"] - want["pobj"])
                      / np.abs(want["pobj"])))
    print(f"  stage check transportation(60, 90, 0.05, 2) B=64 f64: steps "
          f"{int(got['iters'].max())} (plain {int(want['iters'].max())}), "
          f"per-lane steps equal {np.array_equal(got['iters'], want['iters'])}"
          f", CR trips {int(got['cr'])} (plain {int(want['cr'])}), pobj rel "
          f"diff {dp:.2e}, wall {t_k:.3f} s (plain {t_p:.3f} s)", flush=True)
    # every lane meets the IPM's tests in both runs, so pobj agrees within
    # twice the optimality tolerance; the step counts are reported, not
    # compared: the CR stops at a loose tolerance, and a rounding difference
    # that moves its last trip moves the trajectory
    check(np.all(got["done"]) and np.all(want["done"]),
          "stage check: a lane did not converge")
    check(dp <= 2e-8, f"stage check: pobj differs by {dp:.2e}")

    # -- phase 7: scenarios end to end -----------------------------------------------
    k4 = 4
    sv = batch.BatchedScenarioSolver(
        data, b_batch[:k4], parameters=Parameters(display=0, device="cuda"))
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    results = sv.solve()
    torch.cuda.synchronize()
    t_e2e = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    lines = []
    for k, (status, info, _) in enumerate(results):
        cold = LpSolver(Parameters(display=0, device="cpu"))
        check(tg.load_into_solver({**data, "rhs": b_batch[k]}, cold) == 0,
              "load_model failed")
        check(cold.solve() == 1000, f"scenario {k}: the host solve failed")
        want_obj = cold.get_info().objval
        e = abs(info.objval - want_obj) / abs(want_obj)
        lines.append(f"scenario {k}: status {status}, objval "
                     f"{info.objval!r} (host {want_obj!r}, rel {e:.1e}), IPM "
                     f"iters {info.iter}, CR {info.kktiter1}+{info.kktiter2}")
        check(status == 1000, f"scenario {k}: status {status}")
        check(e <= 1e-8, f"scenario {k}: objval differs by {e:.1e}")
    print(f"phase 7: BatchedScenarioSolver(Parameters(device=\"cuda\")) on "
          f"{k4} scenarios: wall {t_e2e:.3f} s (batched phase 1, mean-basis "
          f"solve, {k4} finishes); launches {launches}; {card}\n  "
          + "\n  ".join(lines), flush=True)
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched in phase 7")
    check("jax" not in sys.modules, "jax was imported")

    polish_phase(card, data, b_batch[:4], handoff, "cuda")
    return rows, launches


class plain_products:
    """Within it the plain K11 and K12 take K5's products (their plain
    product sums each row in another order), so that their outputs can be
    held against the kernels' bit for bit."""

    def __enter__(self):
        from ipx_tpu_torch import kernels
        from ipx_tpu_torch.ops import spmv
        self.saved = spmv.csr_spmm_plain
        spmv.csr_spmm_plain = kernels.csr_spmm

    def __exit__(self, *exc):
        from ipx_tpu_torch.ops import spmv
        spmv.csr_spmm_plain = self.saved


def step_kernels(blp, dev, rng, report, t):
    """Phase 5, K10-K13 in float64 at B = 256 on an iterate-like state over
    the LP's bounds; returns their kernel rows."""
    import torch
    from ipx_tpu_torch import kernels
    from ipx_tpu_torch.ops import spmv
    from ipx_tpu_torch.parallel import batch

    f64 = torch.float64
    m, n = blp.A.shape
    nm, B = n + m, B_FULL
    rows = {}
    lb, ub = t(blp.lb, f64), t(blp.ub, f64)
    finl, finu = torch.isfinite(lb), torch.isfinite(ub)
    s = dict(X=t(rng.standard_normal((nm, B)), f64),
             Y=t(rng.standard_normal((m, B)), f64),
             bT=t(np.ascontiguousarray(blp.b.T), f64),
             cT=t(np.ascontiguousarray(blp.c.T), f64))
    for name, fin in (("XL", finl), ("XU", finu), ("ZL", finl),
                      ("ZU", finu)):
        x = t(10.0 ** rng.uniform(-4, 1, (nm, B)), f64)
        x[~fin] = float("inf") if name.startswith("X") else 0.0
        s[name] = x
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    done[1::3] = True
    nmd = spmv.NormalMatrixDevice(blp.A, dev)
    num_fin = int(finl.sum() + finu.sum())
    args = (kernels.csr_spmm(nmd.op_A, s["X"][:n]),
            kernels.csr_spmm(nmd.op_At, s["Y"]), s["X"], s["XL"], s["XU"],
            s["Y"], s["ZL"], s["ZU"], done, s["bT"], s["cT"], lb, ub, finl,
            finu)
    # an optimality limit between two lanes' gaps, far from every lane's
    probe = batch.ipm_prologue_plain(*args, 1e30, 1e30, 0.0, 0.3, num_fin)
    gaps = np.sort(probe.gap.cpu().numpy())
    tests = (1e30, 1e30, float(np.sqrt(gaps[B // 2 - 1] * gaps[B // 2])),
             0.3, num_fin)
    got = batch.ipm_prologue(*args, *tests)
    again = batch.ipm_prologue(*args, *tests)
    want = batch.ipm_prologue_plain(*args, *tests)
    torch.cuda.synchronize()
    exact = all(torch.equal(getattr(got, k), getattr(want, k))
                for k in ("RB", "RC", "RL", "RU", "pres", "dres"))
    G = torch.where(finl[:, None], s["ZL"] / s["XL"], 0.0) \
        + torch.where(finu[:, None], s["ZU"] / s["XU"], 0.0)
    W, rs = batch.kkt_weights_plain(G, got.regval, n)
    exact &= torch.equal(got.W, W) and torch.equal(got.resscale, rs)
    exact &= all(torch.equal(a, b) for a, b in zip(got, again))
    clear = (want.gap - tests[2]).abs() > 1e-12 * tests[2]
    exact &= torch.equal(got.done[clear], want.done[clear])
    fl, fu = finl[:, None], finu[:, None]
    zero = torch.zeros_like(s["X"])
    scale = dict(
        pobj=(s["cT"] * s["X"]).abs().sum(0),
        dobj=(s["bT"] * s["Y"]).abs().sum(0)
        + torch.where(fl, lb[:, None] * s["ZL"], zero).abs().sum(0)
        + torch.where(fu, ub[:, None] * s["ZU"], zero).abs().sum(0),
        mu=(torch.where(fl, s["XL"] * s["ZL"], zero).abs().sum(0)
            + torch.where(fu, s["XU"] * s["ZU"], zero).abs().sum(0))
        / num_fin)
    del zero, G, W, rs, again
    sums = max(float(((getattr(got, k) - getattr(want, k)).abs()
                      / scale[k]).max()) for k in scale)
    err = max(max_abs(getattr(got, k), getattr(want, k)) for k in scale)
    ms = cuda_ms(lambda: batch.ipm_prologue(*args, *tests))
    pms = cuda_ms(lambda: batch.ipm_prologue_plain(*args, *tests))
    report("K10 ipm_prologue", f"f64, exact {exact}, sums", sums, 1e-13, ms,
           pms)
    check(exact, "K10: an elementwise output, a max or done differs, or "
          "two runs differ")
    rows["ipm_prologue"] = dict(case="f64, B=256; max_abs_err of pobj, dobj"
                                ", mu (the rest bit for bit)",
                                max_abs_err=err, ms=ms, plain_ms=pms)

    # K11 (corrector form) and K12 on the prologue's outputs
    sig = t(rng.uniform(0.0, 1.0, B), f64)
    dirs = tuple(t(rng.standard_normal((nm, B)), f64) for _ in range(4))
    rhs_in = (nmd.op_A, got.RC, got.RL, got.RU, s["XL"], s["XU"], s["ZL"],
              s["ZU"], got.W, got.RB, finl, finu, sig, got.mu, *dirs)
    r_got = batch.newton_rhs(*rhs_in)
    with plain_products():
        r_want = batch.newton_rhs_plain(*rhs_in)
    torch.cuda.synchronize()
    exact = all(torch.equal(a, b) for a, b in zip(r_got, r_want))
    ms = cuda_ms(lambda: batch.newton_rhs(*rhs_in))
    pms = cuda_ms(lambda: batch.newton_rhs_plain(*rhs_in))
    report("K11 newton_rhs", f"corrector f64, exact {exact}",
           0.0 if exact else 1.0, 0.0, ms, pms)
    rows["newton_rhs"] = dict(
        case="corrector, f64, B=256, K5 products shared",
        max_abs_err=max(max_abs(a, b) for a, b in zip(r_got, r_want)),
        ms=ms, plain_ms=pms)
    SL, SU, RHS1, _ = r_got
    del dirs, r_want
    DY = t(rng.standard_normal((m, B)), f64)
    rec_in = (nmd.op_A, kernels.csr_spmm(nmd.op_At, DY), DY, RHS1, got.W,
              got.RB, got.RC, got.RL, got.RU, SL, SU, s["XL"], s["XU"],
              s["ZL"], s["ZU"], finl, finu)
    d_got = batch.newton_recover(*rec_in)
    with plain_products():
        d_want = batch.newton_recover_plain(*rec_in)
    torch.cuda.synchronize()
    exact = all(torch.equal(a, b) for a, b in zip(d_got, d_want))
    ms = cuda_ms(lambda: batch.newton_recover(*rec_in))
    pms = cuda_ms(lambda: batch.newton_recover_plain(*rec_in))
    report("K12 newton_recover", f"f64, exact {exact}",
           0.0 if exact else 1.0, 0.0, ms, pms)
    rows["newton_recover"] = dict(
        case="f64, B=256, K5 products shared",
        max_abs_err=max(max_abs(a, b) for a, b in zip(d_got, d_want)),
        ms=ms, plain_ms=pms)
    del rec_in, d_got, d_want, r_got, rhs_in, got, want, probe, args

    # K13 from the clamped zero point and two seeded CR solutions
    X0 = torch.clamp(torch.zeros((nm, B), dtype=f64, device=dev),
                     lb[:, None], ub[:, None])
    DY, Y = t(rng.standard_normal((m, B)), f64), \
        t(rng.standard_normal((m, B)), f64)
    ATY = kernels.csr_spmm(nmd.op_At, Y)
    cT = s["cT"].clone()
    cT[:, 3] = torch.cat([ATY, Y])[:, 3] + 1e-3 * cT[:, 3]   # a fix-up lane
    del s
    sp_in = (X0, kernels.csr_spmm(nmd.op_At, DY), DY, ATY, Y, cT, lb, ub,
             finl, finu)
    *k_got, lane = kernels.starting_point(*sp_in, batch.RHO)
    k_lane = batch.starting_point_plain(*sp_in, lane=lane)
    torch.cuda.synchronize()
    exact = all(torch.equal(a, b) for a, b in zip(k_got, k_lane))
    L = dict(zip(kernels.START_ROWS, lane))
    check(bool(L["fixup"][3] != 0), "K13: the fix-up lane was not fixed")
    del k_lane
    k_want = batch.starting_point_plain(*sp_in)
    err = 0.0
    for a, b in zip(k_got, k_want):
        fin = torch.isfinite(b)
        exact &= torch.equal(fin, torch.isfinite(a))
        err = max(err, rel_err(a[fin], b[fin]))
    abs_err = max(max_abs(a[torch.isfinite(b)], b[torch.isfinite(b)])
                  for a, b in zip(k_got, k_want))
    del k_got, k_want
    ms = cuda_ms(lambda: batch.starting_point(*sp_in))
    pms = cuda_ms(lambda: batch.starting_point_plain(*sp_in))
    report("K13 starting_point", f"f64, exact given scalars {exact}", err,
           1e-12, ms, pms)
    check(exact, "K13: an output differs given the kernel's scalars")
    rows["starting_point"] = dict(case="f64, B=256, against the plain sums",
                                  max_abs_err=abs_err, ms=ms, plain_ms=pms)
    return rows


def polish_phase(card, data, b4, handoff, device):
    """Phase 8: POLISH_STEPS steps of SharedBasisBatchedPolish from the
    handoff state of the 4 scenarios b4, through the kernels and through
    the plain versions on `device`, from twin bases; then
    BatchedScenarioSolver(phase2_polish=True) end to end on a small LP.
    The plain run replays the kernel run's host CR solutions."""
    import torch
    from ipx_tpu_torch import LpSolver, Parameters, kernels
    from ipx_tpu_torch.host import testgen as tg
    from ipx_tpu_torch.parallel import batch, batch2

    sv = batch.BatchedScenarioSolver(
        data, b4, parameters=Parameters(display=0, device=device))
    # the mean-scenario basis, as BatchedScenarioSolver._polish builds it
    p = sv._params()
    p.dualize, p.scale, p.crossover, p.display = 0, 0, 0, 0
    t0 = time.perf_counter()
    s = sv._load(p)
    check(s.solve() == 1000 and s.basis is not None,
          "phase 8: the mean-scenario solve failed")
    t_mean = time.perf_counter() - t0
    check(s.basis.factorization_is_fresh or s.basis.factorize() == 0,
          "phase 8: the mean basis does not factorize")
    # The plain run takes the kernel run's shared-basis CR solutions in
    # turn: the CR is the same host code in both runs, and it stops at a
    # loose tolerance after hundreds of iterations, so on its own the plain
    # run's rounding moves maxvolume's exchanges and the CR's last trip, and
    # with them the direction (first-step mu 1.55e-5 apart at this size).
    solutions = []
    runs = {}
    for name, cls in (("kernels", batch.BatchedPhase1Solver),
                      ("plain", batch.PlainBatchedPhase1Solver)):
        pol = batch2.SharedBasisBatchedPolish(
            sv.blp, s.basis, maxiter=POLISH_STEPS, device=device,
            solver_cls=cls)
        if name == "kernels":
            def record(*a, cr_solve=pol._ph1._cr_solve):
                Y, iters = cr_solve(*a)
                solutions.append((Y.clone(), iters))
                return Y, iters
            pol._ph1._cr_solve = record
        else:
            replay = iter(solutions)
            pol._ph1._cr_solve = lambda *a: next(replay)
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = pol.run(handoff)
        torch.cuda.synchronize()
        runs[name] = (pol, out, time.perf_counter() - t0,
                      dict(kernels.LAUNCHES))
    lines = []
    for name, (pol, out, wall, launched) in runs.items():
        mus = np.array(pol.mu_history)
        lines.append(
            f"{name:7s}: {len(pol.step_cr)} steps, shared-basis CR "
            f"iterations per step "
            f"{pol.step_cr if name == 'kernels' else 'replayed'}, wall "
            f"{wall:.3f} s, "
            f"corrected solves {pol.corrected_solves}, basis updates "
            f"{pol.basis_updates}; mu per step (lanes) "
            + "; ".join(" ".join(f"{v:.6e}" for v in row) for row in mus))
        check(np.all(np.isfinite(mus)), f"phase 8 {name}: mu not finite")
        # every lane is active at the start; a later step may raise an
        # active lane's mu (the inexact shared-basis CR), in ipx_tpu's
        # polish too, so the first step and the whole run are checked
        check(np.all(mus[1] < mus[0]) and np.all(mus[-1] < mus[0]),
              f"phase 8 {name}: mu did not fall on every lane")
        check(pol.correction_failures == pol.refresh_failures == 0,
              f"phase 8 {name}: a correction or refresh failed")
    k_launch = runs["kernels"][3]
    for name in POLISH:
        check(k_launch[name] > 0, f"phase 8: {name} not launched")
    check(not any(runs["plain"][3].values()),
          "phase 8: the plain run launched a kernel")
    mk, mp = runs["kernels"][0].mu_history[1], runs["plain"][0].mu_history[1]
    e_mu = float(np.max(np.abs(mk - mp) / np.abs(mp)))
    e_all = float(np.max(np.abs(np.array(runs["kernels"][0].mu_history)
                                - np.array(runs["plain"][0].mu_history))
                         / np.array(runs["plain"][0].mu_history)))
    print(f"phase 8: SharedBasisBatchedPolish(device=\"{device}\") on 4 "
          f"lanes of the phase-6 handoff, m={sv.m} n={sv.n}: mean-scenario "
          f"solve {t_mean:.3f} s; mu rel diff kernels/plain (the plain run "
          f"replays the kernel run's CR solutions) first step {e_mu:.2e} "
          f"(tol 1e-8), all steps {e_all:.2e}; launches "
          f"{ {k: k_launch[k] for k in POLISH} }; {card}\n  "
          + "\n  ".join(lines), flush=True)
    check(e_mu <= 1e-8, f"phase 8: first-step mu differs by {e_mu:.2e}")

    small = tg.transportation(60, 90, 0.05, seed=2)
    sb = small["rhs"][None, :] * np.random.default_rng(1).uniform(
        0.97, 1.03, (4, small["num_constr"]))
    sv = batch.BatchedScenarioSolver(
        small, sb, parameters=Parameters(display=0, device=device),
        phase2_polish=True)
    kernels.reset_launches()
    t0 = time.perf_counter()
    results = sv.solve()
    torch.cuda.synchronize()
    t_e2e = time.perf_counter() - t0
    launched = dict(kernels.LAUNCHES)
    lines = []
    for k, (status, info, _) in enumerate(results):
        cold = LpSolver(Parameters(display=0, device="cpu"))
        check(tg.load_into_solver({**small, "rhs": sb[k]}, cold) == 0,
              "load_model failed")
        check(cold.solve() == 1000, f"phase 8 scenario {k}: host failed")
        want = cold.get_info().objval
        e = abs(info.objval - want) / max(1.0, abs(want))
        lines.append(f"scenario {k}: status {status}, objval {info.objval!r}"
                     f" (host {want!r}, rel {e:.1e})")
        check(status == 1000, f"phase 8 scenario {k}: status {status}")
        check(e <= 1e-8, f"phase 8 scenario {k}: objval differs by {e:.1e}")
    pol = sv.polish
    check(pol is not None, "phase 8: the polish did not run")
    print(f"  BatchedScenarioSolver(phase2_polish=True, device=\"{device}\")"
          f" transportation(60, 90, 0.05, 2) B=4: wall {t_e2e:.3f} s, polish "
          f"{len(pol.step_cr)} steps, {pol.total_cr_iters} shared-basis CR "
          f"iterations; launches {launched}\n  " + "\n  ".join(lines),
          flush=True)
    for name in POLISH:
        check(launched[name] > 0, f"phase 8 e2e: {name} not launched")


if __name__ == "__main__":
    main()
