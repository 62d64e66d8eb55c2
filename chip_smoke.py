#!/usr/bin/env python3
"""Smoke test of ipx_tpu_torch on one NVIDIA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device, nvcc and g++. It imports torch and ipx_tpu_torch
only: no jax, and no module of ipx_tpu.

  0. the card (nvidia-smi name and power limit) and the versions;
  1. builds the CUDA kernels (nvcc) and the port's native host library
     (g++, ipx_tpu_torch/native/ipxlu.cc);
  2. holds each kernel against its plain PyTorch version on the card, at
     the shapes of the 20k-row transportation LP after presolve, and times
     both (median of CUDA-event timings after warm-up), with one PyTorch
     sparse product beside K1 and K4 as a yardstick; K1 through the plan
     cached on its operand, in event and device time beside the library's,
     and on A u at the plan's lanes per row and at the operand's, in turns;
     K4 through
     the NntPlan the phase-2 CR builds, in its cooperative and its
     two-launch form in turns, with event and device (torch.profiler) time,
     both forms bit for bit against each other and from run to run; K3's
     first inner solve of each device CR (f32 mixed, f64) in its
     cooperative launch and its host-issued passes, in turns, in event and
     device time, lhs, trips and error code bit for bit; the stand-alone
     K2 (Cv and v.Cv) in its one cooperative launch and its three
     launches, bit for bit and timed in turns, f32 and f64;
  3. solves afiro through ipx_tpu_torch.LpSolver(device="cuda");
  4. solves transportation(8000, 12000, 0.001, seed=1) through
     ipx_tpu_torch.LpSolver(device="cuda") with every launch counter set to
     0 just before, and through LpSolver(device="cpu"), the host path that
     launches none of the kernels, and compares; K3's launches there must
     equal the inner CR solves, and K2's applies, which run inside them,
     1 + trips + rechecks of each, with no K2 launch of its own; then an
     f64-precision "cuda" solve, and the walls of six fresh processes,
     three under the caller's thread setting and three under
     OMP_NUM_THREADS=4, in turns (default, 4, 4, default, default, 4) and
     two at a time: each pair is started together and runs a first "cuda"
     solve each, left out of the guard, then "cuda" solves interleaved
     a b b a a b b a and one "cpu" solve each, every wall beside the
     OpenMP team and the OpenBLAS pools' size in a solve
     (native/threads.py); it fails (thread_guard) if the median of the
     default setting's twelve "cuda" walls is above 1.15x their median
     under OMP_NUM_THREADS=4 or above 1.5x the median "cpu" wall, and
     prints the best walls' ratios beside the medians';
  5. holds the batched kernels K5-K9 against their plain versions at the
     shapes of that LP as a batch of B = 256 scenarios (m = 20 000,
     n + m = 116 002), in float64 and float32, and K10-K13, the rest of the
     batched IPM step, in float64, and times both (K5 beside a PyTorch
     sparse product and its bound; its forms in turns, bit for bit, at
     B = 256 and, in f64, B = 4: the row body with one nonzero at a time
     and with two gathers issued together and the tiled form, beside the
     forms kernels.k5_form and k5_unroll take); K6 through its plan in its
     fused launch and its two K5 launches, in turns, out and partials bit
     for bit, event and device time beside the bound, with the plan's
     choice; K13's one cooperative launch against its seven launches,
     outputs and lane scalars bit for bit, timed in turns, with the CUDA
     kernels of a call (torch.profiler, in a fresh process); the byte
     bounds of K7's elementwise passes kPassCA and kPassB, f32 and f64;
  6. runs BatchedPhase1Solver(device="cuda") over those 256 scenarios to
     the handoff (tolerance 1e-4), with the counters set to 0 just before,
     then again, and fails unless both runs take the same steps and CR
     trips; the second run's K5 launches by operand and form (all the
     tiled form); profiles the first STAGE_STEPS steps of that stage for K7's
     passes by name (launches and mean device time beside each pass's
     byte bound, the elementwise passes' too), and checks a small stage
     against the same solver with the plain versions on the card;
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
  9. the sharded solves (parallel/sharding.py, 4 row blocks on the card):
     K4 over 4 column blocks of phase 2's N (one launch an apply) beside
     cuSPARSE on the whole N; K14v, the vector apply's first pass, beside
     the composition it replaced (P K1 launches and K14) and A' v by
     cuSPARSE, with the launches of one vector apply (K14v and one K1);
     K1's block products in one launch against the P per-block launches,
     bit for bit, and one vector apply both ways, in turns, in event and
     device time; K14-K16 against their
     plain versions at the phase-2 LP (B = 256 for K16), trip by trip;
     K15's cooperative launch and its host-issued passes on 20 trips, and
     K16's fused apply and its three-stage form (2P + 1 launches), alone
     and in 10-trip solves, each pair bit for bit and timed in turns in
     event and device time; LpSolver(shards=4) with device "cuda" and
     "auto" on the phase-4 LP (row blocks in phase 1, column blocks in
     phase 2, on the card), each with the counters set to 0 just before,
     against the host path's objval, with K15's launches there equal to
     the sharded CR solves, K14v and K1 launched no time, their applies
     inside K15 one each a solve and a trip; "cuda" again with K15's
     host-issued form, which must take the same phase-1 CR iterations;
     sharded_batched_cr_solve at B = 256 with K16's fused apply (no K5 or
     K14 launch, K14's sum inside each apply), and again with the
     three-stage apply, the same trips and Y bit for bit;
 10. the level-scheduled triangular solves of tools/torch_trisolve_proto.py
     (ops/trisolve.py) on L and U of splu of the final basis of phase 4's
     host solve: full solves (the L sweep, then the U sweep) through K17
     at B = 1, 256 and 1024 with the counters set to 0 just before, one
     launch a sweep, each sweep against its plain version and scipy's
     spsolve_triangular and bit for bit against K17's per-level form, the
     two forms timed in turns beside torch.triangular_solve on the same
     factors; the CUDA kernels of one sweep, of one stand-alone K2 apply
     with its dot (one each), of K2's three launches (three) and of one
     per-level sweep (its levels), from CAPTURES torch.profiler captures a
     case, each open MARGIN s on either side of the call, in a fresh
     process (count_failures: every capture that recorded
     the call's kernels must count them exactly, and one at least must
     have recorded them); the host cost of a K5 call at phase 2, here and
     in that fresh process (k5_host_cost); one step of
     ipx_tpu_torch.entry.entry() on the card; afiro through the port's C
     API (capi.py) with its default device, the card, and in a subprocess
     with the card hidden (CUDA_VISIBLE_DEVICES=""), where ipx_solve
     returns 1004 and raises nothing;
 11. the port's six measuring tools (tools/torch_*.py), each once on
     "cuda" in a fresh process: tools/torch_bench.py --quick at the 20k LP
     alone, then the batched phase 1, the K6 sweep, the pipeline, the
     finish strategies and the scaling table together at small sizes. Each
     must exit 0 with a last line that names the card, holds statuses 1000
     and launches of the kernels its path runs.
 12. the port's sweep tools, each once in a fresh process with --out in a
     temporary directory, all four at once: tools/torch_stress_sweep.py
     --quick --seeds 0-1 (the four generators, two seeds each, the first
     three variants) and tools/torch_lu_update_compare.py --quick on
     "cuda", and tools/torch_results_table.py --quick on "cuda" and on
     "cpu". Each must exit 0 with a last line that names the card and no
     failures; every "cuda" solve must end at status 1000, make a cr_step
     launch where phase 1 ran on the device (kktiter1 > 0 and no dense
     columns, kkt/diag.py) and an nnt launch where phase 2 ran
     (kktiter2 > 0); the quick table's statuses on "cuda" must equal those
     on "cpu", and its objectives (Info.pobjval and objval) agree to 1e-8
     relative.
 13. the mesh (parallel/mesh.py): 4 ranks, one process each, sharing the
     card (gloo, its gathers staged through pinned host buffers; the
     transport printed). One phase-1 CR solve (ShardedDiagCR) and one N N'
     apply at the phase-2 LP over the 4 ranks, bit for bit against the
     one-card K15 and K4 at P = 4; the 2 x 2 rows x batch batched CR at
     B = 256 bit for bit against K16 at P = 2; LpSolver(shards=4,
     device="cuda") inside `with mesh:` on the phase-4 LP, with the ranks'
     counters set to 0 just before, at status 1000 with pobjval within 1e-8
     of "cpu" and of the one-process shards=4 solve, every rank launching
     K15's passes, K14v, K14, K1 and K4; dryrun_multichip(4) over the
     mesh; and a 1-rank NCCL mesh for one sharded_cr_solve, bit for bit
     with the one-card one. It prints the per-trip times, the collective's
     share of them and the K15/K16 pass launches per rank. On a machine
     with four cards, ``python3 chip_smoke.py --mesh-cards`` runs this
     phase alone with one rank a card (NCCL) in place of the shared card.

K2 is launched in phase 4 no time: its entry's `applies_inside_cr_step`
counts the applies that ran inside K3's cooperative launches there, as the
kernel counts them. Likewise K1 and K14v are launched no time on the
sharded solve of phase 9 (in phase 4 every N N' apply is one K4 launch,
and nothing else there launches K1): their entries'
`applies_inside_sharded_cr_step` count the applies that ran inside K15's
launches; and K14 none on the batched solve of phase 9, whose entry's
`applies_inside_sharded_batched_cr_step` counts the sums inside K16's
fused applies. It stops
with a non-zero exit at the first failure. The line before the
last is a JSON object with one entry per kernel: its launches on its main
path (phase 4 for K2-K4, phase 7 for K5-K13, the "cuda" solve of phase 9
for K1, K14v and K15, the batched solve of phase 9 for K14 and K16, the
full solves of phase 10 for K17), its error against
its plain version, the times of both, the least time the card could take
(`bound_ms`, computed from the run's inputs) and a PyTorch call computing
the same function where there is one (`library_ms`). The last line is
{"ok": true, "device": {...}}.
"""
import json
import os
import select
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

T_START = time.perf_counter()
REPO = os.path.dirname(os.path.abspath(__file__))
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


def device_ms(fn, reps=50):
    """Device milliseconds per call of fn(), from torch.profiler: the sum of
    the CUDA events' self device time over `reps` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type.name == "CUDA")
    return us / reps / 1e3


def max_abs(a, b):
    return float((a.double() - b.double()).abs().max())


# The least time the card could take for a kernel's work (PERF.md): the
# larger of its bytes (each input read once, each output written once) over
# the memory rate and its operations over the peak rate of their type.
# NVIDIA's H100 SXM data sheet: 3.35 TB/s of HBM3; 67 TFLOP/s in float32 and
# 34 TFLOP/s in float64 outside the tensor cores (these kernels use none).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "f64": 34e12}
FN = {"float32": "f32", "float64": "f64"}


def bound(nbytes, flops, dtype):
    """{"bound_ms", "bound_by"} of work moving `nbytes` and doing `flops`
    operations of `dtype` ("f32" or "f64")."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def op_bytes(op):
    """Bytes of a CSR operand of ops/spmv.py: indptr, indices, values."""
    return nbytes(op.indptr, op.indices, op.vals)


def library_csr(op):
    """The same CSR matrix as a torch sparse tensor, for the library
    yardstick (`library_ms`); the port never calls it."""
    import torch
    return torch.sparse_csr_tensor(op.indptr.to(torch.int32),
                                   op.indices, op.vals,
                                   size=(op.rows, op.cols))


def rel_err(got, want):
    want = want.double()
    return max_abs(got, want) / max(float(want.abs().max()), 1e-300)


def k1_vec_turns(card, op, x, want, tol):
    """K1's plan on `op` at its lanes per row (kernels.k1_lanes) and at
    ops/spmv.py's lanes_per_row (op.vec, which K2, K4 and K14v take), in
    turns (plan, op.vec, op.vec, plan): event and device time of each, both
    held to `tol` of the plain version `want`."""
    import statistics as st
    from ipx_tpu_torch import kernels
    own = kernels.plan_of(op).vec
    plans = {own: kernels.plan_of(op), op.vec: kernels.SpmvPlan(op, op.vec)}
    for vec, plan in plans.items():
        check(rel_err(plan(x), want) <= tol, f"K1 at {vec} lanes a row "
              "differs from the plain version")
    times = {vec: [] for vec in plans}
    for vec in (own, op.vec, op.vec, own):
        times[vec].append(cuda_ms(lambda: plans[vec](x)))
    dev = {vec: device_ms(lambda: plans[vec](x)) for vec in plans}
    print(f"  {'':15s} lanes per row in turns: " + "; ".join(
        f"vec {vec}: event {st.median(times[vec]):.4f} ms "
        f"({'/'.join(f'{t:.4f}' for t in times[vec])}), device "
        f"{dev[vec]:.5f} ms" for vec in plans) + f" | {card}", flush=True)


def k3_forms(card, solver, rhs, tol, mixed):
    """K3's two forms on the first inner solve of `solver` (a
    MixedPrecisionDeviceCR in f32, or a DeviceNormalCR in f64): the
    cooperative launch and the host-issued passes, held bit for bit (lhs,
    iterations, error code), timed in turns (cooperative, host-issued,
    host-issued, cooperative) in event and device time."""
    import torch
    from ipx_tpu_torch import kernels
    if mixed:
        snorm = float(np.max(np.abs(solver._resscale * rhs)))
        inner_tol = float(np.float32(max(tol, solver.F32_FLOOR * snorm)))
        dtype, W, invd, rs = (torch.float32, solver._W32, solver._invd32,
                              solver._resscale32)
    else:
        inner_tol, dtype = tol, torch.float64
        W, invd, rs = solver._W, solver._invd, solver._resscale
    r = torch.from_numpy(np.asarray(rhs)).to(dtype).to(solver.device)
    nmd = solver._nmd

    def form(cooperative):
        return kernels.CrStep(nmd.op_At, nmd.op_A, W, invd, rs, r).solve(
            solver.m + 100, inner_tol, cooperative)
    forms = {"cooperative": lambda: form(True),
             "host-issued": lambda: form(False)}
    got = {k: f() for k, f in forms.items()}
    torch.cuda.synchronize()
    (y, it, err), (y_h, it_h, err_h) = got["cooperative"], got["host-issued"]
    check((it, err) == (it_h, err_h) and torch.equal(y, y_h),
          f"K3: the cooperative form ({it} trips, error {err}) differs from "
          f"the host-issued one ({it_h}, {err_h})")
    times = {k: [] for k in forms}
    for k in ("cooperative", "host-issued", "host-issued", "cooperative"):
        times[k].append(cuda_ms(forms[k], reps=10, warm=1))
    dev = {k: device_ms(f, reps=5) for k, f in forms.items()}
    print(f"  K3 cr_step       inner solve {str(dtype)[6:]}, {it} trips, "
          f"error {err}, both forms bit for bit; event ms in turns "
          + "; ".join(f"{k} {'/'.join(f'{t:.4f}' for t in v)}"
                      for k, v in times.items())
          + "; device ms " + "; ".join(f"{k} {v:.4f}" for k, v in dev.items())
          + f" | {card}", flush=True)


def batch_ms(fn, reps):
    """Milliseconds a call of fn() over `reps` calls issued back to back
    between two CUDA events: the device's time where the card, not the
    host, sets the pace."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def forms_in_turns(forms, order, reps=REPS, device=True):
    """Two forms of one computation timed in turns (a, b, b, a): event
    milliseconds of each turn by form, one call between two events; device
    milliseconds (torch.profiler; None unless `device`) and back-to-back
    milliseconds (batch_ms) of each turn by form."""
    a, b = order
    ev, dv, bb = ({k: [] for k in order} for _ in range(3))
    for k in (a, b, b, a):
        ev[k].append(cuda_ms(forms[k], reps=reps, warm=1))
    for k in (a, b, b, a):
        if device:
            dv[k].append(device_ms(forms[k], reps=reps))
        bb[k].append(batch_ms(forms[k], reps))
    return ev, dv if device else None, bb


def turns_line(ev, dv, bb):
    def each(d, fmt):
        return "; ".join(f"{k} {'/'.join(fmt.format(x) for x in v)}"
                         for k, v in d.items())
    dev = "" if dv is None else f"; device ms {each(dv, '{:.5f}')}"
    return (f"event ms in turns {each(ev, '{:.4f}')}{dev}; back-to-back ms "
            f"{each(bb, '{:.4f}')}")


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
    # importing the port builds its native host library (the IPM's module
    # binds its vector kernels at import)
    t0 = time.perf_counter()
    from ipx_tpu_torch import (LpSolver, Parameters, backend, build,
                               kernels, testgen as tg)
    from ipx_tpu_torch.kkt.splitted_normal import SplittedNormalMatrix
    from ipx_tpu_torch.sparse import normal_diag
    from ipx_tpu_torch.ops import device_cr, device_cr2, spmv, trisolve
    from ipx_tpu_torch.parallel import batch
    native = build.build_native()
    t_gxx = time.perf_counter() - t0

    t0 = time.perf_counter()
    build.build(force=True)
    dev = backend.cuda_device()
    t_nvcc = time.perf_counter() - t0
    print(f"phase 1: CUDA kernels built by nvcc for sm_90a in {t_nvcc:.2f} s;"
          f" the port imported, with its native host library {native} "
          f"built by g++, in {t_gxx:.2f} s", flush=True)

    # -- phase 2: kernels against their plain versions -------------------------
    data = tg.transportation(8000, 12000, 0.001, seed=1)
    host = LpSolver(Parameters(display=0, device="cpu", stop_at_switch=1))
    check(tg.load_into_solver(data, host) == 0, "load_model failed")
    host.solve()
    check(host.basis is not None, "no basis at the phase switch")
    md = host.basis.model
    m, n = md.num_rows, md.num_cols
    print(f"phase 2: presolved model m={m} n={n} nnz(A)={md.A.nnz}; "
          f"{card}\n  K5 host probe, before any kernel of phase 2 (phase 10 "
          f"reads it again): {k5_host_cost(dev)} | {card}", flush=True)
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
            # K1 through the plan cached on the operand (one ctypes call)
            y = kernels.csr_spmv(op, x).clone()
            again = kernels.csr_spmv(op, x)
            y_p = spmv.csr_spmv_plain(op, x)
            A_lib = library_csr(op)
            y_l = A_lib @ x
            torch.cuda.synchronize()
            check(torch.equal(y, again), "K1: two runs differ")
            err = rel_err(y, y_p)
            ms = cuda_ms(lambda: kernels.csr_spmv(op, x))
            dms = device_ms(lambda: kernels.csr_spmv(op, x))
            pms = cuda_ms(lambda: spmv.csr_spmv_plain(op, x))
            lms = cuda_ms(lambda: A_lib @ x)
            ldms = device_ms(lambda: A_lib @ x)
            report("K1 csr_spmv", f"{opname} {dn} (vec "
                   f"{kernels.plan_of(op).vec}), plan", err, RTOL[dn], ms,
                   pms)
            print(f"  {'':15s} device {dms:.5f} ms; library "
                  f"sparse_csr_tensor @ x: {lms:.4f} ms event, {ldms:.5f} ms "
                  f"device (rel diff {rel_err(y_l, y_p):.1e}) | {card}",
                  flush=True)
            check(rel_err(y_l, y_p) <= RTOL[dn], "K1: the library differs")
            if opname == "A u":
                k1_vec_turns(card, op, x, y_p, RTOL[dn])
            if opname == "A u" and dtype == torch.float64:
                rows["csr_spmv"] = dict(
                    case="A u, f64, through the operand's plan",
                    max_abs_err=max_abs(y, y_p), ms=ms,
                    plain_ms=pms, library_ms=lms,
                    **bound(op_bytes(op) + nbytes(x, y),
                            2 * op.vals.numel(), "f64"))

        # K2 (Cv, v.Cv): the stand-alone apply in one cooperative launch
        # (spmv.normal_apply) against its three launches, bit for bit; their
        # device times come from tools/torch_profile.py --what k2, in a
        # fresh process (torch.profiler reads cooperative kernels low late
        # in this one, PERF.md §7)
        W = t(10.0 ** rng.uniform(-2, 2, n + m), dtype)
        v = t(rng.standard_normal(m), dtype)
        Cv, vCv = spmv.normal_apply(nmd, W, v)
        Cv_p, vCv_p = spmv.normal_apply_plain(nmd, W, v)

        def k2_form(one):
            dot = torch.empty(1, dtype=dtype, device=dev)
            out = kernels.normal_apply(nmd.op_At, nmd.op_A, W, v, dot=dot,
                                       one_launch=one)
            return out, dot
        k2_forms = {"one launch": lambda: k2_form(True),
                    "three launches": lambda: k2_form(False)}
        Cv3, vCv3 = k2_forms["three launches"]()
        torch.cuda.synchronize()
        check(torch.equal(Cv, Cv3) and float(vCv) == float(vCv3[0]),
              f"K2 {dn}: the one launch differs from the three launches")
        err = max(rel_err(Cv, Cv_p),
                  abs(float(vCv) - float(vCv_p)) / abs(float(vCv_p)))
        ev, _, bb = forms_in_turns(k2_forms, tuple(k2_forms), device=False)
        ms = statistics.median(ev["one launch"])
        pms = cuda_ms(lambda: spmv.normal_apply_plain(nmd, W, v))
        report("K2 normal_apply", f"(Cv, v.Cv) {dn}, one launch", err,
               RTOL[dn], ms, pms)
        print(f"  {'':15s} one launch and three bit for bit (Cv, v.Cv); "
              + turns_line(ev, None, bb) + f" | {card}", flush=True)
        if dtype == torch.float32:
            nnz = nmd.op_A.vals.numel()
            rows["normal_apply"] = dict(
                case="(Cv, v.Cv), f32, the stand-alone K2 in one "
                     "cooperative launch; on the main path it is not "
                     "launched: its applies run inside cr_step's "
                     "cooperative launches (applies_inside_cr_step)",
                max_abs_err=max_abs(Cv, Cv_p),
                ms=ms, plain_ms=pms, library_ms=None,
                three_launches_ms=statistics.median(ev["three launches"]),
                back_to_back_ms=statistics.median(bb["one launch"]),
                three_launches_back_to_back_ms=statistics.median(
                    bb["three launches"]),
                **bound(op_bytes(nmd.op_A) + op_bytes(nmd.op_At)
                        + nbytes(W, v, Cv) + 4, 4 * nnz + n + 4 * m, "f32"))

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
        k3_forms(card, kern, rhs, tol, mixed)
        if mixed:
            nmd32 = kern._nmd
            # inputs once (the f32 operands, W, 1/diag, resscale, the f64
            # rhs), y once; per CR iteration K2's flops and ~20 per row
            rows["cr_step"] = dict(
                case=f"MixedPrecisionDeviceCR solve, {it} iterations, one "
                     "cooperative launch an inner solve",
                max_abs_err=max_abs(yt, ypt), ms=ms, plain_ms=pms,
                library_ms=None,
                **bound(op_bytes(nmd32.op_A) + op_bytes(nmd32.op_At)
                        + 4 * (n + m) + 4 * m * 2 + 8 * m * 2,
                        it * (4 * md.A.nnz + n + 20 * m), "f32"))

    # K4 on a prepared SplittedNormalMatrix, through the NntPlan that the
    # phase-2 CR builds, in both forms
    sn = SplittedNormalMatrix(md)
    sn.prepare(host.basis, host.iterate.scaling_factors())
    dsc = device_cr2.DeviceSplittedCR(md, dev)
    dsc.prepare(sn)
    w = t(rng.standard_normal(m), torch.float64)
    plan = dsc._plan
    forms = {"cooperative": lambda: plan(w),
             "two-launch": lambda: plan._kernel.launch(w, cooperative=False)}
    z = {name: form().clone() for name, form in forms.items()}
    again = {name: form().clone() for name, form in forms.items()}
    z_p = device_cr2.nnt_plain(dsc._Nt, dsc._N, w)
    Nt_lib, N_lib = library_csr(dsc._Nt), library_csr(dsc._N)
    z_l = N_lib @ (Nt_lib @ w)
    torch.cuda.synchronize()
    check(all(torch.equal(z[k], again[k]) for k in forms),
          "K4: two runs differ")
    check(torch.equal(z["cooperative"], z["two-launch"]),
          "K4: the two forms differ")
    # the forms timed in turns: cooperative, two-launch, two-launch,
    # cooperative
    times = {name: [] for name in forms}
    for name in ("cooperative", "two-launch", "two-launch", "cooperative"):
        times[name].append(cuda_ms(forms[name]))
    ms_of = {name: statistics.median(v) for name, v in times.items()}
    dev_of = {name: device_ms(form) for name, form in forms.items()}
    kept = "cooperative"        # the plan's form
    ms = ms_of[kept]
    pms = cuda_ms(lambda: device_cr2.nnt_plain(dsc._Nt, dsc._N, w))
    lms = cuda_ms(lambda: N_lib @ (Nt_lib @ w))
    lib_dev = device_ms(lambda: N_lib @ (Nt_lib @ w))
    w_host = w.cpu().numpy()
    t0 = time.perf_counter()
    for _ in range(200):
        plan.apply(w_host)
    host_ms = (time.perf_counter() - t0) / 200 * 1e3
    b = bound(op_bytes(dsc._Nt) + op_bytes(dsc._N) + nbytes(w, z_p),
              4 * sn.N.nnz, "f64")
    for name in forms:
        report("K4 nnt", f"N (N' w) f64 {name}", rel_err(z[name], z_p),
               1e-12, ms_of[name], pms)
    print(f"  {'':15s} event ms in turns {times}; device ms "
          f"{ {k: round(v, 5) for k, v in dev_of.items()} }; kept "
          f"{kept}; bound {b['bound_ms']:.5f} ms; a host apply through the "
          f"pinned buffers {host_ms:.4f} ms; library N_csr @ (Nt_csr @ w): "
          f"{lms:.4f} ms event, {lib_dev:.5f} ms device (rel diff "
          f"{rel_err(z_l, z_p):.1e}); nnz(N)={sn.N.nnz} | {card}",
          flush=True)
    check(rel_err(z_l, z_p) <= 1e-12, "K4: the library differs")
    rows["nnt"] = dict(case=f"N (N' w), f64, P=1, {kept}, the plan's launch",
                       max_abs_err=max_abs(z[kept], z_p), ms=ms,
                       plain_ms=pms, library_ms=lms, **b)
    N_phase2 = sn.N
    del host, forms, z, again

    # -- phase 3: afiro ----------------------------------------------------------
    sys.path.insert(0, os.path.join(REPO, "tests"))
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
    with counted_inner_solves() as inner:
        kernels.reset_launches()
        t0 = time.perf_counter()
        st = port.solve()
        torch.cuda.synchronize()
        t_port = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        inside = dict(kernels.INSIDE)
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
    # the factors of phase 10: splu of the host solve's final basis
    factors = trisolve.basis_factors(ref.basis)
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
    for name in SINGLE:
        check(launches[name] > 0, f"kernel {name} was not launched in "
              "phase 4")
    # each inner CR solve of phase 1 is one cooperative K3 launch, its K2
    # applies inside it (1 + trips + rechecks each) and none on their own
    print(f"  K3: {launches['cr_step']} launches for {inner['solves']} "
          f"inner CR solves ({inner['trips']} trips); K2 applies inside "
          f"them {inside['normal_apply']} (expected {inner['applies']}), K2 "
          f"launched on its own {launches['normal_apply']} times", flush=True)
    check(launches["cr_step"] == inner["solves"] > 0, "phase 4: K3's "
          "launches are not the inner CR solves")
    check(inside["normal_apply"] == inner["applies"] > 0
          and launches["normal_apply"] == 0, "phase 4: K2 did not run "
          "inside K3's launches alone")
    check("jax" not in sys.modules, "jax was imported")
    # the launches of K2-K4 on their main path, the single LP: none of K2,
    # whose applies there run inside K3's launches
    path_launches = {k: launches[k] for k in SINGLE + ("normal_apply",)}
    rows["normal_apply"]["applies_inside_cr_step"] = inside["normal_apply"]
    host_objval = ri.objval
    walls_phase4(card, data, host_objval)

    del port, ref
    t_batched = time.perf_counter()
    batched_rows, launches = batched_phases(card, data, dev, rng)
    rows.update(batched_rows)
    path_launches.update({k: launches[k] for k in BATCHED})
    print(f"phases 5-8 took {time.perf_counter() - t_batched:.1f} s; the "
          f"script {time.perf_counter() - T_START:.1f} s", flush=True)

    t_sharded = time.perf_counter()
    sharded_rows, launches = sharded_phase(card, data, md, N_phase2,
                                           host_objval, dev)
    rows.update(sharded_rows)
    path_launches.update({k: launches[k] for k in SHARDED + ("csr_spmv",)})
    # K14v's and K1's applies run inside K15's launches on the sharded
    # solve, and K14's sums inside K16's fused applies on the batched one
    inside = launches["inside"]
    for name in ("block_spmv_sum", "csr_spmv"):
        rows[name]["applies_inside_sharded_cr_step"] = inside[name]
    rows["block_sum"]["applies_inside_sharded_batched_cr_step"] = \
        inside["block_sum"]
    print(f"phase 9 took {time.perf_counter() - t_sharded:.1f} s; the "
          f"script {time.perf_counter() - T_START:.1f} s", flush=True)

    t_tri = time.perf_counter()
    rows["level_solve"], launches = trisolve_phase(card, *factors, dev)
    path_launches["level_solve"] = launches["level_solve"]
    print(f"phase 10 took {time.perf_counter() - t_tri:.1f} s; the "
          f"script {time.perf_counter() - T_START:.1f} s", flush=True)

    t_tools = time.perf_counter()
    tools_phase(card)
    print(f"phase 11 took {time.perf_counter() - t_tools:.1f} s; the "
          f"script {time.perf_counter() - T_START:.1f} s", flush=True)

    t_sweep = time.perf_counter()
    sweep_phase(card)
    print(f"phase 12 took {time.perf_counter() - t_sweep:.1f} s; the "
          f"script {time.perf_counter() - T_START:.1f} s", flush=True)

    t_mesh = time.perf_counter()
    mesh_phase(card, data, md, N_phase2, dev)
    print(f"phase 13 took {time.perf_counter() - t_mesh:.1f} s; the "
          f"script {time.perf_counter() - T_START:.1f} s", flush=True)

    print(card, flush=True)
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=SOURCE[name],
             replaces=REPLACES[name], launches=path_launches[name],
             **rows[name])
        for name in SOURCE]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


SOURCE = {"csr_spmv": "ipx_tpu_torch/csrc/spmv.cu",
          "normal_apply": "ipx_tpu_torch/csrc/cr.cu",
          "cr_step": "ipx_tpu_torch/csrc/cr.cu",
          "nnt": "ipx_tpu_torch/csrc/nnt.cu",
          "csr_spmm": "ipx_tpu_torch/csrc/spmm.cu",
          "normal_apply_batched": "ipx_tpu_torch/csrc/spmm.cu",
          "batched_cr_step": "ipx_tpu_torch/csrc/batch_cr.cu",
          "step_batch": "ipx_tpu_torch/csrc/ipm_step.cu",
          "ipm_update": "ipx_tpu_torch/csrc/ipm_step.cu",
          "ipm_prologue": "ipx_tpu_torch/csrc/ipm_prologue.cu",
          "newton_rhs": "ipx_tpu_torch/csrc/newton.cu",
          "newton_recover": "ipx_tpu_torch/csrc/newton.cu",
          "starting_point": "ipx_tpu_torch/csrc/start.cu",
          "block_sum": "ipx_tpu_torch/csrc/sharded.cu",
          "sharded_cr_step": "ipx_tpu_torch/csrc/sharded.cu",
          "sharded_batched_cr_step": "ipx_tpu_torch/csrc/sharded.cu",
          "level_solve": "ipx_tpu_torch/csrc/trisolve.cu",
          "block_spmv_sum": "ipx_tpu_torch/csrc/nnt.cu"}
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
            "starting_point": "ipx_tpu/parallel/batch.py:331",
            "block_sum": "ipx_tpu/parallel/sharding.py:170",
            "sharded_cr_step": "ipx_tpu/parallel/sharding.py:221",
            "sharded_batched_cr_step": "ipx_tpu/parallel/sharding.py:429",
            "level_solve": "tools/device_trisolve_proto.py:118",
            "block_spmv_sum": "ipx_tpu/parallel/sharding.py:132"}
# the kernels launched on the single LP's main path (phase 4); K1 runs in
# phase 9, and K2's applies run inside K3's cooperative launches
SINGLE = ("cr_step", "nnt")
BATCHED = ("csr_spmm", "normal_apply_batched", "batched_cr_step",
           "step_batch", "ipm_update", "ipm_prologue", "newton_rhs",
           "newton_recover", "starting_point")
# the kernels of the sharded solves (phase 9)
SHARDED = ("block_sum", "block_spmv_sum", "sharded_cr_step",
           "sharded_batched_cr_step")
P_SHARDS = 4
# the kernels of a polish step: its CR runs on the host
POLISH = ("csr_spmm", "step_batch", "ipm_update", "ipm_prologue",
          "newton_rhs", "newton_recover")
B_FULL = 256
POLISH_STEPS = 3
STAGE_STEPS = 3     # steps of the stage profiled for K7's passes (phase 6)


class counted_inner_solves:
    """Within it every inner CR solve of phase 1's device CR classes is
    counted, with its trips and the K2 applies it runs (1 + trips + one
    every RECHECK_EVERY trips), through a wrapper of their inner_solve."""

    def __enter__(self):
        from ipx_tpu_torch.ops import device_cr
        self.count = dict(solves=0, trips=0, applies=0)
        self.classes = (device_cr.DeviceNormalCR,
                        device_cr.MixedPrecisionDeviceCR)
        self.saved = [c.__dict__["inner_solve"] for c in self.classes]

        def counted(*args, **kw):
            out = device_cr.cr_solve(*args, **kw)
            it = out[1]
            self.count["solves"] += 1
            self.count["trips"] += it
            self.count["applies"] += 1 + it + it // device_cr.RECHECK_EVERY
            return out
        for c in self.classes:
            c.inner_solve = staticmethod(counted)
        return self.count

    def __exit__(self, *exc):
        for c, saved in zip(self.classes, self.saved):
            c.inner_solve = saved


# phase 4's walls come from a worker in a fresh process whose OpenMP
# setting is its environment's: it makes the LP, prints "ready", then
# solves on the device named by each line of its input and prints the
# solve as one JSON line (status, wall, objval, the host's steal ticks
# over the solve from /proc/stat, the iteration counts); at the end of its
# input it prints its OpenMP team, the OpenBLAS pools' size in a solve and
# the CPUs its main thread may run on
WALLS = r"""
import json, os, sys, time
import torch
from ipx_tpu_torch import LpSolver, Parameters, testgen as tg
from ipx_tpu_torch.native import threads
data = tg.transportation(8000, 12000, 0.001, seed=1)
def steal():
    try:
        with open("/proc/stat") as f:
            v = f.readline().split()
        return int(v[8])
    except (OSError, IndexError, ValueError):
        return 0
print(json.dumps({"ready": True}), flush=True)
for line in sys.stdin:
    s = LpSolver(Parameters(display=0, device=line.strip()))
    assert tg.load_into_solver(data, s) == 0
    torch.cuda.synchronize()
    k0, t0 = steal(), time.perf_counter()
    st = s.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    i = s.get_info()
    print(json.dumps({"st": st, "wall": wall, "objval": i.objval,
                      "steal": steal() - k0,
                      "iters": [i.iter, i.kktiter1, i.kktiter2]}), flush=True)
print(json.dumps({"team": torch.get_num_threads(),
                  "blas": (threads.blas_threads(os.environ)
                           or [get() for get, _ in threads.blas_pools()]),
                  "cpus": len(os.sched_getaffinity(0))}), flush=True)
"""

# the thread settings phase 4 compares: the caller's, and OMP_NUM_THREADS=4
SETTINGS = {"default": {}, "omp4": {"OMP_NUM_THREADS": "4"}}
SHORT = {"default": "default", "omp4": "4"}   # as the turns are printed
# phase 4's six fresh processes, in turns and two at a time: each pair is
# started together and its solves are interleaved, so that a host whose
# load changes over the call weighs on both settings alike
PAIRS = (("default", "omp4"), ("omp4", "default"), ("default", "omp4"))
# the solves of a pair (a, b), 0 for a and 1 for b: a first "cuda" solve
# each, which pays the process's first-use costs (12% of a wall, the median
# of 30 processes; PERF.md §6) and is left out of the guard, then "cuda"
# solves a b b a a b b a, then one "cpu" solve each
SOLVES = ((("first", 0), ("first", 1))
          + tuple(("cuda", k) for k in (0, 1, 1, 0, 0, 1, 1, 0))
          + (("cpu", 0), ("cpu", 1)))
# seconds between two solves, in which the other worker's threads stop
# spinning
PAUSE = 0.25
WORKER_TIMEOUT = 300.0  # seconds a worker may take to start or to solve
# phase 4's thread guard: the default setting's "cuda" wall at most this
# many times its wall under OMP_NUM_THREADS=4, and at most this many times
# the "cpu" wall, each setting's walls taken by their median
OVER_OMP4 = 1.15
OVER_CPU = 1.5


def guard_ratios(runs):
    """The walls and ratios of phase 4's thread guard under each statistic:
    "median", the one the guard decides by, and "best" (the least wall),
    printed beside it. `runs` maps each setting of SETTINGS to its "cuda"
    and "cpu" walls in seconds; returns {statistic: {"walls": {setting:
    {device: s}}, "omp4": ratio, "cpu": ratio}}."""
    out = {}
    for name, stat in (("median", statistics.median), ("best", min)):
        w = {k: {d: stat(runs[k][d]) for d in ("cuda", "cpu")} for k in runs}
        out[name] = dict(walls=w,
                         omp4=w["default"]["cuda"] / w["omp4"]["cuda"],
                         cpu=w["default"]["cuda"] / w["default"]["cpu"])
    return out


def thread_guard(runs):
    """The failures of phase 4's thread guard on `runs` (as guard_ratios
    takes them), each a message; empty when it passes. The fault it guards
    against: the native regions waiting on the BLAS pools' spinning workers
    made the card path 1.8x the host path and about 5x its own time under
    OMP_NUM_THREADS=4 (PERF.md §5). It decides on each setting's median
    wall, which no single wall sets: the shared LU refactorizes on measured
    time, so one solve's path, and its wall, can stray from the rest. With
    the pools quiet the host path, whose whole phase-2 CR is native, is
    faster than the card path on this LP, so no bound asks the card to
    win."""
    w = guard_ratios(runs)["median"]["walls"]
    card, omp4, cpu = (w["default"]["cuda"], w["omp4"]["cuda"],
                       w["default"]["cpu"])
    failures = []
    if card > OVER_OMP4 * omp4:
        failures.append(f"phase 4: the card path's median wall ({card:.3f} "
                        f"s) is above {OVER_OMP4}x its median under "
                        f"OMP_NUM_THREADS=4 ({omp4:.3f} s)")
    if card > OVER_CPU * cpu:
        failures.append(f"phase 4: the card path's median wall ({card:.3f} "
                        f"s) is above {OVER_CPU}x the host path's median "
                        f"({cpu:.3f} s)")
    return failures


def guard_line(runs):
    """Phase 4's walls with the OpenMP team, the OpenBLAS pools, the main
    thread's CPUs, the host's steal time over the "cuda" solves and their
    iteration counts of each setting, then the guard's ratios under both
    statistics."""
    fmt = lambda v: "/".join(f"{x:.3f}" for x in v)  # noqa: E731
    said = "; ".join(
        f"{k} (OpenMP team {r['team']} of {len(os.sched_getaffinity(0))} "
        f"CPUs, main thread on {r['cpus']}, OpenBLAS pools {r['blas']} in a "
        f"solve): cuda {fmt(r['cuda'])} s, cpu {fmt(r['cpu'])} s, steal "
        f"over the cuda solves {r['steal']:.2f} CPU s, IPM/CR iterations "
        f"{sorted(r['iters'])}" for k, r in runs.items())
    ratios = "; ".join(
        f"{name} cuda / {name} cpu {r['cpu']:.3f}, {name} cuda / {name} cuda "
        f"at OMP_NUM_THREADS=4 {r['omp4']:.3f}"
        for name, r in guard_ratios(runs).items())
    first = "; ".join(f"{k} {fmt(r['first'])} s" for k, r in runs.items())
    pairs = ", ".join("(" + ", ".join(SHORT[k] for k in p) + ")"
                      for p in PAIRS)
    return (f"walls, six fresh processes in pairs {pairs}, each pair's "
            f"cuda solves a b b a a b b a: {said}; {ratios} (the guard: "
            f"median, at most {OVER_CPU} and {OVER_OMP4}); each process's "
            f"first cuda solve, left out: {first}")


class Phase4Worker:
    """A WALLS worker in a fresh process under the environment `env`, asked
    for one solve at a time; `what` names it in a failure."""

    def __init__(self, env, what):
        self.what = what
        self.err = tempfile.TemporaryFile(mode="w+")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", WALLS], cwd=REPO, env=env, text=True,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=self.err)

    def read(self):
        """The worker's next JSON line, parsed (other lines skipped); fails
        if none comes within WORKER_TIMEOUT seconds of the last."""
        while True:
            ready, _, _ = select.select([self.proc.stdout], [], [],
                                        WORKER_TIMEOUT)
            line = self.proc.stdout.readline() if ready else ""
            if not line:
                self.stop()
                self.err.seek(0)
                fail(f"phase 4: the {self.what} worker failed: "
                     + self.err.read()[-2000:])
            if line.startswith("{"):
                return json.loads(line)

    def solve(self, device):
        try:
            self.proc.stdin.write(device + "\n")
            self.proc.stdin.flush()
        except BrokenPipeError:
            pass
        return self.read()

    def finish(self):
        """Ends the worker's input; its team, pools and CPUs."""
        self.proc.stdin.close()
        out = self.read()
        self.proc.wait(timeout=WORKER_TIMEOUT)
        return out

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def phase4_runs(host_objval):
    """The walls of WALLS workers under each thread setting of SETTINGS on
    top of this process's environment: the six processes of PAIRS, two at a
    time, each pair's solves in the order of SOLVES with PAUSE between two.
    Fails unless every solve is at status 1000 with `host_objval` to 1e-8.
    Returns {setting: {"cuda": walls, "cpu": walls, "first": the first
    "cuda" walls, "steal": the host's steal CPU seconds over the "cuda"
    solves, "iters": the (IPM, CR phase 1, CR phase 2) iterations of the
    "cuda" solves, "team": the OpenMP team, "blas": the OpenBLAS pools' size
    in a solve, "cpus": the CPUs of a worker's main thread}}."""
    tick = os.sysconf("SC_CLK_TCK")
    runs = {k: {"first": [], "cuda": [], "cpu": [], "steal": 0.0,
                "iters": set()} for k in SETTINGS}
    for pair in PAIRS:
        workers = [Phase4Worker(dict(os.environ, **SETTINGS[k]), k)
                   for k in pair]
        try:
            for w in workers:
                check(w.read() == {"ready": True}, f"phase 4: the {w.what} "
                      "worker did not start")
            for key, i in SOLVES:
                time.sleep(PAUSE)
                got = workers[i].solve("cpu" if key == "cpu" else "cuda")
                rel = abs(got["objval"] - host_objval) / abs(host_objval)
                check(got["st"] == 1000 and rel <= 1e-8, f"phase 4 "
                      f"{pair[i]} {key}: status {got['st']}, objval rel "
                      f"diff {rel:.1e}")
                r = runs[pair[i]]
                r[key].append(got["wall"])
                if key == "cuda":
                    r["steal"] += got["steal"] / tick
                    r["iters"].add(tuple(got["iters"]))
            for k, w in zip(pair, workers):
                runs[k].update(w.finish())
        finally:
            for w in workers:
                w.stop()
    return runs


def walls_phase4(card, data, host_objval):
    """The rest of phase 4: an f64-precision "cuda" solve (the f64 device
    CR), then the walls of phase4_runs, each beside the OpenMP team and the
    OpenBLAS pools' size in a solve. Fails if a solve is not at status 1000
    with the host objval to 1e-8, or on thread_guard's failures."""
    import torch
    from ipx_tpu_torch import LpSolver, Parameters
    from ipx_tpu_torch import testgen as tg

    def rel(objval):
        return abs(objval - host_objval) / abs(host_objval)

    s = LpSolver(Parameters(display=0, device="cuda", precision="f64"))
    check(tg.load_into_solver(data, s) == 0, "load_model failed")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = s.solve()
    torch.cuda.synchronize()
    f64_wall = time.perf_counter() - t0
    f64 = s.get_info()
    check(st == 1000 and rel(f64.objval) <= 1e-8, f"phase 4 f64 precision: "
          f"status {st}, objval rel diff {rel(f64.objval):.1e}")

    runs = phase4_runs(host_objval)
    print(f"  f64-precision cuda {f64_wall:.3f} s (cr1 {f64.time_cr1:.3f} s, "
          f"CR iters {f64.kktiter1}+{f64.kktiter2}, objval rel diff "
          f"{rel(f64.objval):.1e})\n  {guard_line(runs)} | {card}",
          flush=True)
    failures = thread_guard(runs)
    check(not failures, "; ".join(failures))


def k6_forms(card, nmd, W, V, b):
    """K6's two forms at the phase-5 shapes, through the pair's plan: the
    fused launch and the two K5 launches, out and the partials held bit for
    bit, timed in turns (fused, two-launch, two-launch, fused) in event and
    device time beside the bound `b`. Returns the plan's form's event and
    device ms."""
    import torch
    from ipx_tpu_torch import kernels
    At, A = nmd.op_At, nmd.op_A
    plan = kernels.normal_plan_of(At, A)
    m, n, B = nmd.m, nmd.n, V.shape[1]
    e = lambda *s: torch.empty(s, dtype=V.dtype, device=V.device)  # noqa
    bufs = {f: (e(m, B), e(*plan.partials_shape(W, V, V))) for f in
            ("fused", "two-launch")}
    U = e(n, B)
    forms = {"fused": lambda: plan(W, V, out=bufs["fused"][0],
                                   partials=bufs["fused"][1], fused=True),
             "two-launch": lambda: plan(W, V, out=bufs["two-launch"][0],
                                        partials=bufs["two-launch"][1], U=U,
                                        fused=False)}
    for f in forms.values():
        f()
    torch.cuda.synchronize()
    check(all(torch.equal(bufs["fused"][i], bufs["two-launch"][i])
              for i in (0, 1)), "K6: the fused launch and the two launches "
          "differ")
    times = {k: [] for k in forms}
    for k in ("fused", "two-launch", "two-launch", "fused"):
        times[k].append(cuda_ms(forms[k]))
    dev = {k: device_ms(f) for k, f in forms.items()}
    kept = "fused" if plan.fused else "two-launch"
    print(f"  K6 normal_apply_batched {str(V.dtype)[6:]}: the plan takes "
          f"{kept} (sum of squared column lengths {At.sq_rows} = "
          f"{At.sq_rows / A.vals.numel():.3f} nnz(A)); fused and two-launch "
          f"out and partials bit for bit; event ms in turns "
          + "; ".join(f"{k} {'/'.join(f'{t:.4f}' for t in v)}"
                      for k, v in times.items())
          + "; device ms " + "; ".join(f"{k} {v:.5f}" for k, v in dev.items())
          + f"; bound {b['bound_ms']:.5f} ms ({b['bound_by']}) | {card}",
          flush=True)
    del U, bufs
    return statistics.median(times[kept]), dev[kept]


def k5_forms(card, op, X, name):
    """K5's forms on `op` (csrc/spmm.cu): the row body at unroll 1 and 2
    and the tiled form: Y bit for bit across all of them, the row body's
    epilogue partials at unroll 1 and 2 bit for bit; timed in turns (row1,
    row2, tile, tile, row2, row1) in event time and back to back
    (batch_ms), beside the forms kernels.k5_form and k5_unroll take. Returns
    {form: median back-to-back ms}. (torch.profiler reads kernels low or
    not at all late in this process, PERF.md §6; tools/torch_profile.py
    --what k5 gives their device times.)"""
    import torch
    from ipx_tpu_torch import kernels
    B = X.shape[1]
    e = lambda *s: torch.empty(s, dtype=X.dtype, device=X.device)  # noqa
    vw = kernels.spmm_width(B, X.dtype, X)
    forms = {f"row{u}": dict(form="row", unroll=u) for u in (1, 2)}
    forms["tile"] = dict(form="tile")
    Y = {k: e(op.rows, B) for k in forms}
    calls = {k: (lambda k=k: kernels._spmm(op, X, Y[k], **kw))
             for k, kw in forms.items()}
    w = torch.ones((op.rows, B), dtype=X.dtype, device=X.device)
    part = {u: e(kernels.lane_blocks(op.rows, B // vw), B) for u in (1, 2)}
    for k in forms:
        calls[k]()
    for u in (1, 2):
        kernels._spmm(op, X, e(op.rows, B), addw=w, addv=w,
                      partials=part[u], unroll=u)
    torch.cuda.synchronize()
    for k in forms:
        check(torch.equal(Y[k], Y["row1"]),
              f"K5 {name}: the {k} form differs from the row body")
    check(torch.equal(part[1], part[2]),
          f"K5 {name}: unroll 2's partials differ from one at a time")
    order = list(forms) + list(forms)[::-1]
    times = {k: [] for k in forms}
    for k in order:
        times[k].append(cuda_ms(calls[k]))
    bb = {k: [] for k in forms}
    for k in order:
        bb[k].append(batch_ms(calls[k], REPS))
    print(f"  {'':22s} {name}: {', '.join(forms)} bit for bit; k5_form "
          f"takes {kernels.k5_form(B, X.element_size(), False)}, "
          f"k5_unroll {kernels.k5_unroll(op)}; event ms in turns "
          + "; ".join(f"{k} {'/'.join(f'{t:.4f}' for t in v)}"
                      for k, v in times.items())
          + "; back-to-back ms " + "; ".join(
              f"{k} {'/'.join(f'{t:.5f}' for t in v)}"
              for k, v in bb.items()) + f" | {card}", flush=True)
    return {k: statistics.median(v) for k, v in bb.items()}


class K5Tally:
    """Within it, K5's launches by operand (its rows), dtype and form, from
    a wrapper around kernels._spmm; the launch counters are untouched."""

    def __enter__(self):
        from collections import Counter
        from ipx_tpu_torch import kernels
        self.counts, self.saved = Counter(), kernels._spmm

        def spmm(op, U, Y, rowscale=None, addw=None, addv=None,
                 partials=None, state=None, **kw):
            epilogue = any(t is not None
                           for t in (rowscale, addw, partials, state))
            form = kw.get("form") or kernels.k5_form(
                U.shape[1], U.element_size(), epilogue)
            self.counts[(op.rows, str(U.dtype)[6:], form)] += 1
            return self.saved(op, U, Y, rowscale, addw, addv, partials,
                              state, **kw)
        kernels._spmm = spmm
        return self

    def __exit__(self, *exc):
        from ipx_tpu_torch import kernels
        kernels._spmm = self.saved


# K13's two forms in a fresh process at the given (n, m, B) on seeded
# inputs: the CUDA kernels one call of each launches, from torch.profiler
K13_LAUNCHES = r"""
import json, sys
import torch
from torch.profiler import ProfilerActivity, profile
from ipx_tpu_torch import backend, kernels
n, m, B = map(int, sys.argv[1:4])
dev = backend.cuda_device()
g = torch.Generator(device=dev).manual_seed(0)
r = lambda *s: torch.randn(s, generator=g, dtype=torch.float64, device=dev)
fin = torch.ones(n + m, dtype=torch.bool, device=dev)
lb = torch.zeros(n + m, dtype=torch.float64, device=dev)
args = (r(n + m, B).abs(), r(n, B), r(m, B), r(n, B), r(m, B), r(n + m, B),
        lb, lb + 10.0, fin, fin)
out = {}
for name, coop in (("one", True), ("seven", False)):
    kernels.starting_point(*args, 0.1, cooperative=coop)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        kernels.starting_point(*args, 0.1, cooperative=coop)
        torch.cuda.synchronize()
    out[name] = sum(e.count for e in prof.key_averages()
                    if e.device_type.name == "CUDA" and "Memcpy" not in e.key
                    and "Memset" not in e.key)
print(json.dumps(out))
"""


def k13_launches(n, m, B):
    """{"one": k, "seven": k}: the CUDA kernels one call of K13's one
    launch and of its seven launches start, counted by torch.profiler in a
    fresh process (late in this one it misses kernels, PERF.md §6)."""
    out = subprocess.run([sys.executable, "-c", K13_LAUNCHES, str(n), str(m),
                          str(B)], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    check(out.returncode == 0, "K13's launch count failed: "
          + out.stderr[-2000:])
    return json.loads(out.stdout.strip().splitlines()[-1])


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
    from ipx_tpu_torch import testgen as tg
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
            A_lib = library_csr(op)
            Y_l = A_lib @ X
            torch.cuda.synchronize()
            ms = cuda_ms(lambda: kernels.csr_spmm(op, X))
            pms = cuda_ms(lambda: spmv.csr_spmm_plain(op, X))
            lms = cuda_ms(lambda: A_lib @ X)
            report("K5 csr_spmm", f"{opname} {dn}", rel_err(Y, Y_p),
                   RTOL[dn], ms, pms)
            bbms = batch_ms(lambda: kernels.csr_spmm(op, X), REPS)
            b = bound(op_bytes(op) + nbytes(X, Y), 2 * op.vals.numel() * B,
                      FN[dn])
            form = kernels.k5_form(B, X.element_size(), False)
            print(f"  {'':22s} back to back {bbms:.5f} ms ({form} form), "
                  f"bound {b['bound_ms']:.5f} ms; library "
                  f"sparse_csr_tensor @ U: {lms:.4f} ms (rel diff "
                  f"{rel_err(Y_l, Y_p):.1e}) | {card}", flush=True)
            check(rel_err(Y_l, Y_p) <= RTOL[dn], "K5: the library differs")
            dv = k5_forms(card, op, X, f"{opname} {dn}")
            del A_lib, Y_l
            k5_case = (dict(
                case=f"{opname}, {FN[dn]}, B={B}, {form} form",
                max_abs_err=max_abs(Y, Y_p), ms=ms, back_to_back_ms=bbms,
                row_back_to_back_ms=dv["row1"], plain_ms=pms, library_ms=lms,
                **b))
            # the kernels line's numbers are A U f64's, the other cases
            # beside them
            if "csr_spmm" in rows:
                rows["csr_spmm"]["cases"].append(k5_case)
            else:
                rows["csr_spmm"] = dict(k5_case, cases=[])
            if dtype == torch.float64:
                # the entry step's and phase 7's lane counts: B = 4
                X4 = X[:, :4].contiguous()
                Y4 = kernels.csr_spmm(op, X4)
                torch.cuda.synchronize()
                check(rel_err(Y4, spmv.csr_spmm_plain(op, X4)) <= RTOL[dn],
                      f"K5 {opname} {dn} B=4 differs from the plain version")
                k5_forms(card, op, X4, f"{opname} {dn} B=4")
                del X4, Y4

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
        pms = cuda_ms(lambda: spmv.normal_apply_batched_plain(nmd, W, V))
        b = bound(op_bytes(nmd.op_A) + op_bytes(nmd.op_At)
                  + nbytes(W, V, out, dots),
                  (4 * blp.A.nnz + n + 4 * m) * B, FN[dn])
        ms, dms = k6_forms(card, nmd, W, V, b)
        report("K6 normal_apply_batch", f"(CV, V.CV) {dn}", err, RTOL[dn],
               ms, pms)
        if dtype == torch.float32:
            fused = kernels.normal_plan_of(nmd.op_At, nmd.op_A).fused
            rows["normal_apply_batched"] = dict(
                case="(CV, partials of V.CV), f32, B=256, the plan's form "
                     f"(fused: {fused}), device {dms:.5f} ms",
                max_abs_err=max_abs(out, out_p), ms=ms, plain_ms=pms,
                library_ms=None, **b)

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
            # inputs once: operands, W, 1/diag, resscale, rhs, tol; Y once
            pass_bounds = k7_elem_bounds(m, B, kernels.lane_blocks(m, B))
            print(f"  {'':15s} bounds of K7's elementwise passes (B={B}, "
                  f"m={m}, each array once): " + ", ".join(
                      f"{k} {v * 1e3:.2f} us" for k, v in pass_bounds.items())
                  + f" | {card}", flush=True)
            rows["batched_cr_step"] = dict(
                case=f"batched CR solve, f32, B=256, {trips} trips",
                max_abs_err=max_abs(Yc, Yc_p), ms=ms, plain_ms=pms,
                library_ms=None, pass_bound_ms=pass_bounds,
                **bound(op_bytes(nmd.op_A) + op_bytes(nmd.op_At)
                        + 4 * (nm + 5 * m + 1) * B,
                        trips * (4 * blp.A.nnz + n + 20 * m) * B, "f32"))

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
                                max_abs(maxd, maxd_p)), ms=ms, plain_ms=pms,
                library_ms=None,
                **bound(nbytes(*sargs, maxp, maxd), 8 * nm * B, "f64"))
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
            rows["ipm_update"] = dict(
                case="in place, f64, B=256", max_abs_err=err, ms=ms,
                plain_ms=pms, library_ms=None,
                **bound(nbytes(*state, *dirs) + nbytes(*state),
                        2 * (5 * nm + m) * B, "f64"))
        del nmd, W, V, out, out2, out_p, st, sargs, state, dirs, got, want
        torch.cuda.empty_cache()
    rows.update(step_kernels(card, blp, dev, rng, report, t))
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
    # the trip count is deterministic for a given tree: a second run of the
    # stage takes the same steps and trips
    # (its K5 launches tallied by operand and form)
    t0 = time.perf_counter()
    with K5Tally() as tally:
        again = ph1.solve(handoff="auto")
        torch.cuda.synchronize()
    t_again = time.perf_counter() - t0
    check(int(again["cr"]) == int(out["cr"])
          and np.array_equal(again["iters"], out["iters"]),
          f"phase 6: a second run of the stage took {int(again['cr'])} CR "
          f"trips, the first {int(out['cr'])}")
    del again
    names = {m: "A or A.^2 (m rows)", n: "A' (n rows)"}
    by_op = {f"{names.get(r, r)} {dn} {form}": k
             for (r, dn, form), k in sorted(tally.counts.items(), key=str)}
    print(f"  K5 launches of the stage by operand, dtype and form: {by_op}",
          flush=True)
    check(sum(tally.counts.values()) == stage_launches["csr_spmm"],
          "phase 6: K5's tally differs from its launch counter")
    # every K5 launch of the stage is a plain product (K6 is fused there)
    check(all(form == "tile" for (_, _, form) in tally.counts),
          "phase 6: a K5 launch of the stage took the row body")
    rows["csr_spmm"]["launches_a_stage_by_operand"] = by_op
    k6_form = ("fused" if kernels.normal_plan_of(
        ph1.nmd32.op_At, ph1.nmd32.op_A).fused else "two-launch")
    finl, finu = np.isfinite(blp.lb)[:, None], np.isfinite(blp.ub)[:, None]
    with np.errstate(invalid="ignore"):
        mu = (np.sum(np.where(finl, out["XL"] * out["ZL"], 0.0), axis=0)
              + np.sum(np.where(finu, out["XU"] * out["ZU"], 0.0), axis=0)
              ) / max(int(finl.sum() + finu.sum()), 1)
    steps = int(out["iters"].max())
    print(f"phase 6: BatchedPhase1Solver(device=\"cuda\", cr_dtype=f32) "
          f"B={B} m={m} n={n}: {steps} steps, {int(out['done'].sum())} "
          f"lanes converged, {int(out['cr'])} CR trips (the same in a second "
          f"run, wall {t_again:.3f} s), wall {t_stage:.3f} s; K6 {k6_form}; "
          f"mu from median {np.median(mu0):.3e} / max "
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
    k7_pass_times(card, blp, dev)

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
    for name in SINGLE + BATCHED:
        check(launches[name] > 0, f"kernel {name} was not launched in "
              "phase 7")
    check("jax" not in sys.modules, "jax was imported")

    polish_phase(card, data, b_batch[:4], handoff, "cuda")
    return rows, launches


K7_PASSES = ("kInit", "kStart", "kPassCA", "kCheck", "kPassB", "kBeta")


def k7_passes(prof):
    """{(dtype, pass name): (launches, mean device us)} of K7's kernels in a
    torch.profiler window; the pass is the kernel's template argument."""
    import re
    out = {}
    for e in prof.key_averages():
        hit = re.search(
            r"bcr_(?:lane|elem)_kernel<(float|double),[^0-9>]*(\d)[^>]*>",
            e.key)
        if e.device_type.name == "CUDA" and hit:
            key = (hit.group(1), K7_PASSES[int(hit.group(2))])
            n, us = out.get(key, (0, 0.0))
            out[key] = (n + e.count, us + e.self_device_time_total)
    return {k: (n, us / n) for k, (n, us) in out.items()}


def k7_elem_arrays(m, B, npa):
    """{pass: (values read, values written)} of K7's elementwise passes on
    a trip after the first, each array once (csrc/batch_cr.cu): kPassCA
    reads S, D, CS, CD, 1/diag, resscale, R and the lanes' beta and writes
    D, CD and the (2, B, npa) partials; kPassB reads the B active flags,
    alpha, D, CD, Y, R, S, 1/diag and writes Y, R and S."""
    mb = m * B
    return {"kPassCA": (7 * mb + B, 2 * mb + 2 * npa * B),
            "kPassB": (6 * mb + 2 * B, 3 * mb)}


def k7_elem_bounds(m, B, npa):
    """{"kPassCA f32": ms, ...}: the byte bounds of K7's elementwise passes
    in f32 and f64 (k7_elem_arrays) over the card's memory rate."""
    return {f"{name} {dn}": bound(size * (r + w), 0, dn)["bound_ms"]
            for dn, size in (("f32", 4), ("f64", 8))
            for name, (r, w) in k7_elem_arrays(m, B, npa).items()}


def k7_pass_times(card, blp, dev):
    """Phase 6, K7's passes by name: the first STAGE_STEPS steps of the
    B = 256 stage under torch.profiler, each pass's launches and mean device
    time beside its byte bound (the partials it reads once, the lane slots
    it reads and writes)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from ipx_tpu_torch import kernels
    from ipx_tpu_torch.parallel import batch
    m, B = blp.A.shape[0], blp.batch
    ph = batch.BatchedPhase1Solver(blp, feasibility_tol=1e-4,
                                   optimality_tol=1e-4, maxiter=STAGE_STEPS,
                                   device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ph.solve()
        torch.cuda.synchronize()
    passes = k7_passes(prof)
    npa = kernels.lane_blocks(m, B)
    lines = []
    for (dn, name), (n, us) in sorted(passes.items()):
        size = 4 if dn == "float" else 8
        npc = kernels.lane_blocks(m, B // (16 // size))
        elem = k7_elem_arrays(m, B, npa)
        read = {"kCheck": 2 * npa * B + 2 * B, "kStart": npc * B,
                "kBeta": npc * B + 2 * B}.get(name, elem.get(name, (0,))[0])
        wrote = {"kCheck": 3 * B, "kStart": B, "kBeta": 2 * B + 1}.get(
            name, elem.get(name, (0, 0))[1])
        b_us = (f", bound {1e6 * size * (read + wrote) / HBM_BYTES_PER_S:.3f}"
                f" us" if read else "")
        lines.append(f"{dn} {name} {n} x {us:.2f} us{b_us}")
    for name in ("kStart", "kCheck", "kBeta"):
        check(any(k[1] == name for k in passes), f"phase 6: K7 {name} was "
              "not seen by the profiler")
    print(f"  K7 passes over the first {STAGE_STEPS} steps of the stage "
          f"(B={B}, m={m}, npa={npa}): " + "; ".join(lines) + f" | {card}",
          flush=True)


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


def step_kernels(card, blp, dev, rng, report, t):
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
                                max_abs_err=err, ms=ms, plain_ms=pms,
                                library_ms=None,
                                **bound(nbytes(*args) + nbytes(*got[:7])
                                        + B, 20 * nm * B, "f64"))

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
        ms=ms, plain_ms=pms, library_ms=None,
        **bound(op_bytes(nmd.op_A) + nbytes(*rhs_in[1:]) + nbytes(*r_got),
                (2 * blp.A.nnz + 20 * nm) * B, "f64"))
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
        ms=ms, plain_ms=pms, library_ms=None,
        **bound(op_bytes(nmd.op_A) + nbytes(*rec_in[1:]) + nbytes(*d_got),
                (2 * blp.A.nnz + 20 * nm) * B, "f64"))
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
    k13_bytes = nbytes(*sp_in, *k_got, lane)
    # the one launch against the seven of the earlier form, bit for bit
    seven = kernels.starting_point(*sp_in, batch.RHO, cooperative=False)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip((*k_got, lane), seven)),
          "K13: the one launch differs from the seven launches")
    del seven
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
    forms = {"one": lambda: batch.starting_point(*sp_in),
             "seven": lambda: kernels.starting_point(*sp_in, batch.RHO,
                                                     cooperative=False)}
    ev, bb = {k: [] for k in forms}, {k: [] for k in forms}
    for k in ("one", "seven", "seven", "one"):
        ev[k].append(cuda_ms(forms[k], reps=10, warm=1))
    for k in ("one", "seven", "seven", "one"):
        bb[k].append(batch_ms(forms[k], 10))
    launched = k13_launches(n, m, B)
    ms = statistics.median(ev["one"])
    pms = cuda_ms(lambda: batch.starting_point_plain(*sp_in), reps=10)
    b13 = bound(k13_bytes, 20 * nm * B, "f64")
    report("K13 starting_point", f"f64, exact given scalars {exact}", err,
           1e-12, ms, pms)
    print(f"  {'':22s} one launch and seven bit for bit; CUDA kernels a "
          f"call (torch.profiler, a fresh process) {launched}; event ms in "
          "turns " + "; ".join(
              f"{k} {'/'.join(f'{x:.4f}' for x in v)}" for k, v in ev.items())
          + "; back-to-back ms " + "; ".join(
              f"{k} {'/'.join(f'{x:.4f}' for x in v)}" for k, v in bb.items())
          + f"; bound {b13['bound_ms']:.4f} ms | {card}", flush=True)
    check(exact, "K13: an output differs given the kernel's scalars")
    check(launched == {"one": 1, "seven": 7}, f"K13's CUDA kernels a call "
          f"{launched}, not one and seven")
    rows["starting_point"] = dict(
        case="f64, B=256, one cooperative launch, against the plain sums",
        max_abs_err=abs_err, ms=ms, plain_ms=pms, library_ms=None,
        back_to_back_ms=statistics.median(bb["one"]),
        seven_launch_ms=statistics.median(ev["seven"]),
        seven_launch_back_to_back_ms=statistics.median(bb["seven"]),
        cuda_launches_a_call=launched["one"],
        cuda_launches_a_call_seven=launched["seven"], **b13)
    return rows


def polish_phase(card, data, b4, handoff, device):
    """Phase 8: POLISH_STEPS steps of SharedBasisBatchedPolish from the
    handoff state of the 4 scenarios b4, through the kernels and through
    the plain versions on `device`, from twin bases; then
    BatchedScenarioSolver(phase2_polish=True) end to end on a small LP.
    The plain run replays the kernel run's host CR solutions."""
    import torch
    from ipx_tpu_torch import LpSolver, Parameters, kernels
    from ipx_tpu_torch import testgen as tg
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


def block_products_turns(card, snm, u, Wl, v, Ws):
    """Phase 9, K1's block products of one vector apply: the one launch
    (BlockSpmvPlan) against the P per-block K1 launches it replaced, out and
    partials bit for bit, each timed in turns (one, P, P, one) in event and
    device time; then the whole vector apply both ways (K14v and the one
    launch, K14v and the P launches), in turns."""
    import statistics as st
    import torch
    from ipx_tpu_torch import kernels
    m, P = v.numel(), len(snm.op_A)
    vecs = [kernels.k1_lanes(op) for op in snm.op_A]
    _, blk_off = kernels.block_layout([op.rows for op in snm.op_A], vecs)
    e = lambda k: torch.empty(k, dtype=v.dtype, device=v.device)  # noqa
    out, parts, out_p, parts_p = e(m), e(blk_off[-1]), e(m), e(blk_off[-1])
    plan = kernels.BlockSpmvPlan(snm.op_A, u, out, Wl, v, parts)
    slices = kernels._slices(parts_p, np.diff(blk_off))

    def per_block():
        kernels._block_products(kernels.csr_spmv, snm.op_A, u, out_p, Wl, v,
                                slices, None)

    plan.launch()
    per_block()
    torch.cuda.synchronize()
    check(torch.equal(out, out_p) and torch.equal(parts, parts_p),
          "K1's one launch differs from its P launches")
    forms = {"one launch": plan.launch, f"{P} launches": per_block}
    # a vector apply as K15's step object makes it: K14v into u, then the
    # block products
    applies = {"one launch": lambda: (kernels.block_spmv_sum(
        snm.op_At_split, v, Ws, out=u), plan.launch()),
        f"{P} launches": lambda: (kernels.block_spmv_sum(
            snm.op_At_split, v, Ws, out=u), per_block())}
    for label, fns in (("block products", forms), ("vector apply", applies)):
        times = {k: [] for k in fns}
        for k in ("one launch", f"{P} launches", f"{P} launches",
                  "one launch"):
            times[k].append(cuda_ms(fns[k]))
        dev = {k: device_ms(fns[k]) for k in fns}
        print(f"  K1 {label}: " + "; ".join(
            f"{k}: event {st.median(times[k]):.4f} ms ("
            f"{'/'.join(f'{t:.4f}' for t in times[k])}), device "
            f"{dev[k]:.5f} ms" for k in fns) + f"; blocks' lanes per row "
            f"{vecs} (agree: {len(set(vecs)) == 1}), bit for bit with the P "
            f"launches | {card}", flush=True)


def sharded_phase(card, data, md, N2, host_objval, dev):
    """Phase 9, the sharded solves (parallel/sharding.py) with P_SHARDS row
    blocks on the card: K4 over P_SHARDS column blocks of phase 2's N
    (`N2`), K14v and K14-K16 against their plain versions at the presolved
    LP `md` of phase 2; LpSolver(shards=4) with device "cuda" and "auto" on
    `data`, with the counters set to 0 just before each, against the host
    path's objval; sharded_batched_cr_solve at B = B_FULL. Returns the
    kernel rows of K14v and K14-K16 and the launch counts of their main
    paths: the "cuda" solve for K1, K14v and K15, the batched solve for
    K14 and K16."""
    import torch
    from ipx_tpu_torch import LpSolver, Parameters, kernels
    from ipx_tpu_torch import testgen as tg
    from ipx_tpu_torch.ops import spmv
    from ipx_tpu_torch.parallel import sharding

    A = md.A
    m, n = A.shape
    P, B = P_SHARDS, B_FULL
    rows, launches = {}, {}
    rng = np.random.default_rng(9)
    f64 = torch.float64

    def t(x):
        return torch.from_numpy(np.asarray(x, dtype=np.float64)).to(dev)

    def report(name, case, err, tol, ms, plain_ms):
        print(f"  {name:26s} {case:34s} err {err:.3e} (tol {tol:.0e}) "
              f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms | {card}",
              flush=True)
        check(err <= tol, f"{name} {case}: error {err:.3e} > {tol:.0e}")

    snm = sharding.ShardedNormalMatrix(A, P, dev)
    # the operands each loop reads: K15's apply takes the whole A' split at
    # the row bounds (K14v), K16's the blocks' A_p' (K5); both the A_p
    ops_A = sum(op_bytes(op) for op in snm.op_A)
    ops_k15 = ops_A + op_bytes(snm.op_At_split)
    ops_k16 = ops_A + sum(op_bytes(op) for op in snm.op_At)
    print(f"phase 9: sharded solves, P={P} row blocks {snm.rows} of m={m} "
          f"n={n} nnz(A)={A.nnz}; {card}", flush=True)

    def moved(fn):
        """fn() and the launches it made, by kernel."""
        before = dict(kernels.LAUNCHES)
        out = fn()
        return out, {k: v - before[k] for k, v in kernels.LAUNCHES.items()
                     if v != before[k]}

    # K4 over P column blocks of phase 2's N, its psum inside: one launch an
    # apply, against the per-block plain version and cuSPARSE on the whole N
    nnt = sharding.ShardedSplittedNNt(N2.shape[0], N2.shape[1], P, dev)
    nnt.set_operand(N2)
    w = t(rng.standard_normal(N2.shape[0]))
    z, launched = moved(lambda: sharding.block_nnt(nnt, w).clone())
    check(launched == {"nnt": 1}, f"block_nnt launched {launched}, not one "
          "K4")
    again = sharding.block_nnt(nnt, w).clone()
    z_p = sharding.block_nnt_plain(nnt.blocks, w)
    Nt_lib, N_lib = library_csr(nnt.plan.Nt), library_csr(nnt.plan.N)
    torch.cuda.synchronize()
    check(torch.equal(z, again), "K4 over column blocks: two runs differ")
    ms = cuda_ms(lambda: sharding.block_nnt(nnt, w))
    dms = device_ms(lambda: sharding.block_nnt(nnt, w))
    pms = cuda_ms(lambda: sharding.block_nnt_plain(nnt.blocks, w))
    lms = cuda_ms(lambda: N_lib @ (Nt_lib @ w))
    ldms = device_ms(lambda: N_lib @ (Nt_lib @ w))
    report("K4 nnt", f"P={P} column blocks, 1 launch/apply",
           rel_err(z, z_p), 1e-12, ms, pms)
    print(f"  {'':26s} device {dms:.5f} ms; cuSPARSE N_csr @ (Nt_csr @ w) "
          f"on the whole N: {lms:.4f} ms event, {ldms:.5f} ms device | "
          f"{card}", flush=True)
    del nnt, Nt_lib, N_lib

    # K14v: the vector apply's first pass with its psum, beside today's
    # composition (P K1 launches into parts, then K14) and A' v by cuSPARSE
    # (unscaled, a yardstick); then the launches of one vector apply
    op = snm.op_At_split
    Ws, Wl, v = t(rng.uniform(0.5, 2.0, n)), t(rng.uniform(0.5, 2.0, m)), \
        t(rng.standard_normal(m))

    def composition():
        parts = torch.empty((P, n), dtype=f64, device=dev)
        for o, (r0, r1), part in zip(snm.op_At, snm.bounds, parts):
            kernels.csr_spmv(o, v[r0:r1], out=part)
        return kernels.block_sum(parts, Ws)

    u = kernels.block_spmv_sum(op, v, Ws).clone()
    again = kernels.block_spmv_sum(op, v, Ws).clone()
    u_p = spmv.split_spmv_plain(op, v, Ws)
    u_c = composition()
    At_lib = library_csr(op)
    torch.cuda.synchronize()
    check(torch.equal(u, again), "K14v: two runs differ")
    check(rel_err(u_c, u_p) <= 1e-12, "K14v: the composition differs")
    ms = cuda_ms(lambda: kernels.block_spmv_sum(op, v, Ws))
    dms = device_ms(lambda: kernels.block_spmv_sum(op, v, Ws))
    pms = cuda_ms(lambda: spmv.split_spmv_plain(op, v, Ws))
    cms, cdms = cuda_ms(composition), device_ms(composition)
    lms, ldms = cuda_ms(lambda: At_lib @ v), device_ms(lambda: At_lib @ v)
    report("K14v block_spmv_sum", f"W_s * sum of P={P} A_p' v_p f64",
           rel_err(u, u_p), 1e-12, ms, pms)
    out, launched = moved(lambda: sharding.block_normal_apply(snm, Ws, Wl,
                                                              v))
    want = sharding._block_apply_plain(snm, Ws, Wl, v, spmv.csr_spmv_plain)
    print(f"  {'':26s} device {dms:.5f} ms; the P K1 + K14 composition it "
          f"replaced: {cms:.4f} ms event, {cdms:.5f} ms device; cuSPARSE "
          f"At_csr @ v (unscaled): {lms:.4f} ms event, {ldms:.5f} ms "
          f"device; one vector apply launched {launched} (rel err "
          f"{rel_err(out, want):.1e}) | {card}", flush=True)
    check(launched == {"block_spmv_sum": 1, "csr_spmv": 1},
          f"a vector apply launched {launched}, not one K14v and one K1")
    check(rel_err(out, want) <= 1e-12, "the vector apply differs")
    block_products_turns(card, snm, u, Wl, v, Ws)
    rows["block_spmv_sum"] = dict(
        case=f"u = W_struct * sum_p A_p' v_p, P={P}, f64",
        max_abs_err=max_abs(u, u_p), ms=ms, plain_ms=pms, library_ms=None,
        **bound(op_bytes(op) + nbytes(v, Ws, u), 2 * op.vals.numel() + n,
                "f64"))
    del u, again, u_p, u_c, At_lib, out, want, Ws, Wl, v

    # K14 at the shapes it had on the main path, bit for bit: (P, m)
    # unscaled (the N N' psum before K4 took it in), (P, n) scaled (the
    # vector apply's, before K14v) and (P, n, B) scaled (the batched apply,
    # K16's, its one shape on a main path now and the row's case). One
    # library call, torch.sum(parts, 0), computes the unscaled case.
    for shape, scaled in (((m,), False), ((n,), True), ((n, B), True)):
        parts = t(rng.standard_normal((P,) + shape))
        scale = t(rng.uniform(0.5, 2.0, shape)) if scaled else None
        got = sharding.block_sum(parts, scale)
        want = sharding.block_sum_plain(parts, scale)
        torch.cuda.synchronize()
        exact = torch.equal(got, want)
        ms = cuda_ms(lambda: sharding.block_sum(parts, scale))
        pms = cuda_ms(lambda: sharding.block_sum_plain(parts, scale))
        case = (f"{'scale * ' if scaled else ''}sum of P={P} parts of "
                f"{shape} f64")
        report("K14 block_sum", f"{case}, exact {exact}",
               0.0 if exact else 1.0, 0.0, ms, pms)
        if not scaled:
            lms = cuda_ms(lambda: torch.sum(parts, 0))
            print(f"  K14 library torch.sum(parts, 0) on the same parts: "
                  f"{lms:.4f} ms, max abs diff "
                  f"{max_abs(torch.sum(parts, 0), want):.3e} | {card}",
                  flush=True)
        if len(shape) == 2:
            rows["block_sum"] = dict(
                case=case, max_abs_err=max_abs(got, want), ms=ms,
                plain_ms=pms, library_ms=None,
                **bound(nbytes(parts, got, scale), P * n * B, "f64"))
        del parts, scale, got, want
    torch.cuda.empty_cache()

    # K15: five trips against the plain version, trip by trip, then its
    # cooperative launch and its host-issued passes on a fixed number of
    # trips, bit for bit, in turns
    W = 10.0 ** rng.uniform(-2, 2, n + m)
    A2 = A.copy()
    A2.data **= 2
    diag = A2 @ W[:n] + W[n:]
    Ws, Wl, invd, rs = t(W[:n]), t(W[n:]), t(1.0 / diag), t(1.0 / np.sqrt(
        W[n:]))
    rhs = t(rng.standard_normal(m))
    worst = 0.0
    for trips in range(1, 6):
        y, it, err, _ = sharding.sharded_cr(snm, Ws, Wl, invd, rs, rhs,
                                            0.0, trips)
        y_p, it_p, err_p, _ = sharding.sharded_cr_plain(
            snm, Ws, Wl, invd, rs, rhs, 0.0, trips)
        check(it == it_p == trips and err == err_p == 0,
              f"K15 trip {trips}: {it}/{err} against plain {it_p}/{err_p}")
        worst = max(worst, rel_err(y, y_p))
    timed = 20
    k15 = {"cooperative": lambda: sharding.sharded_cr(
        snm, Ws, Wl, invd, rs, rhs, 0.0, timed),
        "host-issued": lambda: kernels.ShardedCrStep(
            snm.op_At_split, snm.op_A, Ws, Wl, invd, rs, rhs, True).solve(
            timed, 0.0, cooperative=False)}
    got = {k: f() for k, f in k15.items()}
    y_p, _, _, _ = sharding.sharded_cr_plain(snm, Ws, Wl, invd, rs, rhs, 0.0,
                                             timed)
    torch.cuda.synchronize()
    (y, it, err, res), (y_h, it_h, err_h, res_h) = (got["cooperative"],
                                                    got["host-issued"])
    check(it == timed and (it, err, res) == (it_h, err_h, res_h)
          and torch.equal(y, y_h),
          f"K15: the cooperative form ({it} trips, error {err}) differs from "
          f"the host-issued one ({it_h}, {err_h})")
    ev, dv, bb = forms_in_turns(k15, ("cooperative", "host-issued"), reps=5)
    ms = statistics.median(ev["cooperative"])
    pms = cuda_ms(lambda: sharding.sharded_cr_plain(
        snm, Ws, Wl, invd, rs, rhs, 0.0, timed), reps=5, warm=1)
    report("K15 sharded_cr_step", f"trips 1-5 and {timed}, f64",
           max(worst, rel_err(y, y_p)), 1e-12, ms, pms)
    print(f"  {'':26s} {it} trips, both forms bit for bit; "
          + turns_line(ev, dv, bb) + f" | {card}", flush=True)
    rows["sharded_cr_step"] = dict(
        case=f"ShardedDiagCR recurrence, P={P}, {timed} trips, f64, one "
             f"cooperative launch",
        max_abs_err=max_abs(y, y_p), ms=ms,
        back_to_back_ms=statistics.median(bb["cooperative"]),
        host_issued_ms=statistics.median(ev["host-issued"]),
        host_issued_back_to_back_ms=statistics.median(bb["host-issued"]),
        plain_ms=pms,
        library_ms=None,
        **bound(ops_k15 + 8 * (n + 5 * m), timed * (4 * A.nnz + n + 20 * m),
                "f64"))
    del got, k15

    # K16's apply: the fused launch against the three-stage form's 2P + 1
    # launches, out and partials bit for bit, in turns
    Wb = t(rng.uniform(0.5, 2.0, (n + m, B)))
    diag_b = A2 @ Wb[:n].cpu().numpy() + Wb[n:].cpu().numpy()
    Wbs, Wbl, invd_b = Wb[:n].contiguous(), Wb[n:].contiguous(), t(
        1.0 / diag_b)
    del Wb
    R = t(rng.standard_normal((m, B)))
    plan = kernels.block_plan_of(snm.op_At_split, snm.op_At, snm.op_A)
    check(plan.fused, "K16's plan did not take the fused apply on the "
          "transportation LP")
    e = lambda *s: torch.empty(s, dtype=f64, device=dev)  # noqa: E731
    npc = sum(plan.partials_rows(B, plan.width(Wbs, Wbl, R, R)))
    outs = {f: e(m, B) for f in (True, False)}
    pcs = {f: e(npc, B) for f in (True, False)}
    parts, U = e(P, n, B), e(n, B)
    apply = {"fused": lambda: plan(Wbs, Wbl, R, out=outs[True],
                                   partials=pcs[True], fused=True),
             "three-stage": lambda: plan(Wbs, Wbl, R, out=outs[False],
                                         partials=pcs[False], parts=parts,
                                         U=U, fused=False)}
    for f in apply.values():
        f()
    want = sharding._block_apply_plain(snm, Wbs, Wbl, R, spmv.csr_spmm_plain)
    torch.cuda.synchronize()
    check(torch.equal(outs[True], outs[False])
          and torch.equal(pcs[True], pcs[False]),
          "K16: the fused apply differs from the three-stage one")
    a_err = rel_err(outs[True], want)
    a_ev, a_dv, a_bb = forms_in_turns(apply, ("fused", "three-stage"))
    a_pms = cuda_ms(lambda: sharding._block_apply_plain(
        snm, Wbs, Wbl, R, spmv.csr_spmm_plain), reps=5, warm=1)
    a_bound = bound(ops_k15 + nbytes(R, Wbs, Wbl, outs[True], pcs[True]),
                    2 * B * (int(snm.op_At_split.sq_rows) + A.nnz)
                    + 3 * m * B, "f64")
    report("K16 apply", f"C V over P={P} blocks, B={B} f64",
           a_err, 1e-12, statistics.median(a_ev["fused"]), a_pms)
    print(f"  {'':26s} fused and three-stage bit for bit (out, partials); "
          + turns_line(a_ev, a_dv, a_bb)
          + f"; bound {a_bound['bound_ms']:.4f} ms "
          f"({a_bound['bound_by']}) | {card}", flush=True)
    del parts, U, outs, pcs, want, apply
    torch.cuda.empty_cache()

    # K16: five trips against the plain version, then a fixed number of
    # trips in both forms of its apply, bit for bit, in turns
    worst = 0.0
    for trips in range(1, 6):
        Y, it = sharding.sharded_batched_cr(snm, Wbs, Wbl, invd_b, R, 0.0,
                                            trips)
        Y_p, it_p = sharding.sharded_batched_cr_plain(snm, Wbs, Wbl, invd_b,
                                                      R, 0.0, trips)
        check(it == it_p == trips, f"K16 trip {trips}: {it} / plain {it_p}")
        worst = max(worst, rel_err(Y, Y_p))
    del Y_p
    timed = 10

    def k16(fused):
        return kernels.ShardedBatchedCrStep(
            snm.op_At_split, snm.op_At, snm.op_A, Wbs, Wbl, invd_b, R,
            fused=fused).solve(timed, 0.0)
    k16_forms = {"fused": lambda: k16(True),
                 "three-stage": lambda: k16(False)}
    (Y, it), (Y_3, it_3) = k16(True), k16(False)
    Y, Y_3 = Y.clone(), Y_3.clone()
    Y_p, _ = sharding.sharded_batched_cr_plain(snm, Wbs, Wbl, invd_b, R, 0.0,
                                               timed)
    torch.cuda.synchronize()
    check(it == it_3 == timed and torch.equal(Y, Y_3),
          "K16: the solve with the fused apply differs from the three-stage "
          "one")
    ev, dv, bb = forms_in_turns(k16_forms, ("fused", "three-stage"), reps=3)
    ms = statistics.median(ev["fused"])
    pms = cuda_ms(lambda: sharding.sharded_batched_cr_plain(
        snm, Wbs, Wbl, invd_b, R, 0.0, timed), reps=3, warm=1)
    report("K16 sharded_batched_cr", f"trips 1-5 and {timed}, f64, B={B}",
           max(worst, rel_err(Y, Y_p)), 1e-12, ms, pms)
    print(f"  {'':26s} {timed} trips, the fused and three-stage applies bit "
          f"for bit; " + turns_line(ev, dv, bb) + f" | {card}", flush=True)
    rows["sharded_batched_cr_step"] = dict(
        case=f"batched recurrence, P={P}, B={B}, {timed} trips, f64, one "
             f"fused apply a trip",
        max_abs_err=max_abs(Y, Y_p), ms=ms,
        back_to_back_ms=statistics.median(bb["fused"]),
        three_stage_ms=statistics.median(ev["three-stage"]),
        three_stage_back_to_back_ms=statistics.median(bb["three-stage"]),
        apply_ms=statistics.median(a_ev["fused"]),
        apply_back_to_back_ms=statistics.median(a_bb["fused"]),
        apply_three_stage_back_to_back_ms=statistics.median(
            a_bb["three-stage"]),
        apply_bound_ms=a_bound["bound_ms"], plain_ms=pms, library_ms=None,
        **bound(ops_k16 + 8 * (n + 4 * m) * B,
                timed * (4 * A.nnz + n + 20 * m) * B, "f64"))
    del Y, Y_3, Y_p, Wbs, Wbl, invd_b, R, k16_forms
    torch.cuda.empty_cache()

    # the main path: LpSolver(shards=4), device "cuda" then "auto", then
    # "cuda" with K15's host-issued form (a comparison, not counted)
    host_issued = {}
    for device in ("cuda", "auto", "host-issued"):
        s = LpSolver(Parameters(display=0, shards=P, device="cuda"
                                if device == "host-issued" else device))
        check(tg.load_into_solver(data, s) == 0, "load_model failed")
        torch.cuda.synchronize()
        kernels.reset_launches()
        solve_k15 = kernels.ShardedCrStep.solve
        if device == "host-issued":
            kernels.ShardedCrStep.solve = (
                lambda self, maxiter, tol, cooperative=True:
                solve_k15(self, maxiter, tol, cooperative=False))
        try:
            t0 = time.perf_counter()
            st = s.solve()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            kernels.ShardedCrStep.solve = solve_k15
        launched, inside = dict(kernels.LAUNCHES), dict(kernels.INSIDE)
        i = s.get_info()
        e = abs(i.objval - host_objval) / abs(host_objval)
        cr = s.model._sharded_cr[1]
        if device == "host-issued":
            host_issued = dict(kktiter1=i.kktiter1, objval=i.objval,
                               wall=wall, cr1=i.time_cr1)
            print(f"  LpSolver(shards={P}, device='cuda') with K15's "
                  f"host-issued form: status {st}, objval {i.objval!r}, wall "
                  f"{wall:.3f} s, CR iters {i.kktiter1}+{i.kktiter2}, cr1 "
                  f"{i.time_cr1:.3f} s, K15 launches "
                  f"{launched['sharded_cr_step']}, K14v "
                  f"{launched['block_spmv_sum']}, K1 {launched['csr_spmv']} "
                  f"| {card}", flush=True)
            check(st == 1000 and i.kktiter1 == cuda_kkt[0]
                  and abs(i.objval - cuda_kkt[1]) <= 1e-8 * abs(cuda_kkt[1]),
                  f"shards={P}: K15's host-issued form took {i.kktiter1} CR "
                  f"iterations in phase 1 (objval {i.objval!r}) against the "
                  f"cooperative form's {cuda_kkt[0]} ({cuda_kkt[1]!r})")
            del s
            continue
        if device == "cuda":
            launches.update(launched)
            launches["inside"] = inside
            cuda_kkt = (i.kktiter1, i.objval)
        nnt = getattr(s.model, "_sharded_nnt", None)
        applies = nnt[1].applies if nnt is not None else 0
        print(f"  LpSolver(shards={P}, device={device!r}) on transportation"
              f"(8000, 12000, 0.001, 1): status {st}, objval {i.objval!r} "
              f"(host {host_objval!r}, rel {e:.1e}), wall {wall:.3f} s, IPM "
              f"iters {i.iter}, CR iters {i.kktiter1}+{i.kktiter2}, sharded "
              f"CR solves {cr.solves} ({cr.iterations} trips) on "
              f"{cr.device}, sharded N N' applies {applies}; ipm1 "
              f"{i.time_ipm1:.3f} s, ipm2 {i.time_ipm2:.3f} s, cr1 "
              f"{i.time_cr1:.3f} s, cr2 {i.time_cr2:.3f} s (NNt "
              f"{i.time_cr2_NNt:.3f} s); launches "
              f"{ {k: v for k, v in launched.items() if v} }; applies inside "
              f"K15: K14v {inside['block_spmv_sum']}, K1 "
              f"{inside['csr_spmv']}; {card}", flush=True)
        check(st == 1000, f"shards={P} {device}: status {st}")
        check(e <= 1e-8, f"shards={P} {device}: objval differs by {e:.1e}")
        check(i.kktiter1 > 0 and cr.solves > 0 and cr.device.type == "cuda",
              f"shards={P} {device}: the sharded CR did not run on the card")
        check(launched["sharded_cr_step"] == cr.solves,
              f"shards={P} {device}: {launched['sharded_cr_step']} K15 "
              f"launches for {cr.solves} sharded CR solves, not one each")
        check(launched["block_spmv_sum"] == launched["csr_spmv"] == 0,
              f"shards={P} {device}: K14v or K1 was launched on its own")
        check(inside["block_spmv_sum"] == inside["csr_spmv"]
              == cr.solves + cr.iterations,
              f"shards={P} {device}: the applies inside K15 (K14v "
              f"{inside['block_spmv_sum']}, K1 {inside['csr_spmv']}) are "
              f"not one each a solve and a trip ({cr.solves} + "
              f"{cr.iterations})")
        check(launched["block_sum"] == 0, f"shards={P} {device}: K14 ran on "
              "a vector path")
        check(applies > 0 and nnt[1].device.type == "cuda"
              and launched["nnt"] == applies,
              f"shards={P} {device}: the sharded N N' did not run on the "
              "card, one K4 launch an apply")
        del s

    # sharded_batched_cr_solve at full width, weights as in
    # tests/test_sharded.py, then the same solve with the three-stage apply
    brng = np.random.default_rng(1)
    W = brng.uniform(0.5, 2.0, size=(n + m, B))
    diag = A2 @ W[:n] + W[n:]
    RHS = brng.standard_normal((m, B))
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    Y, iters = sharding.sharded_batched_cr_solve(snm, W[:n], W[n:], diag,
                                                 RHS, 1e-10, 2000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    batched = dict(kernels.LAUNCHES)
    k14_inside = kernels.INSIDE["block_sum"]
    for name in ("sharded_batched_cr_step", "block_sum"):
        launches[name] = batched[name]
    launches["inside"]["block_sum"] = k14_inside
    Wt = t(W)
    Y3, iters3 = kernels.ShardedBatchedCrStep(
        snm.op_At_split, snm.op_At, snm.op_A, Wt[:n].contiguous(),
        Wt[n:].contiguous(), t(1.0 / diag), t(RHS), fused=False).solve(
        2000, 1e-10)
    Y3 = Y3.cpu().numpy()
    torch.cuda.synchronize()
    Yt = t(Y)

    def worst_of(Yt):
        res = (t(RHS) - snm.apply(Wt[:n].contiguous(), Wt[n:].contiguous(),
                                  Yt)).abs().amax(0).cpu().numpy()
        return float(np.max(res / np.abs(RHS).max(axis=0)))
    worst, worst3 = worst_of(Yt), worst_of(t(Y3))
    print(f"  sharded_batched_cr_solve P={P} B={B}: {iters} trips, wall "
          f"{wall:.3f} s, worst lane residual / max|rhs| {worst!r} (tol "
          f"1e-9); with the three-stage apply {iters3} trips, "
          f"{worst3!r}; launches "
          f"{ {k: v for k, v in batched.items() if v} }, K14 sums inside "
          f"K16's fused applies {k14_inside}; {card}", flush=True)
    check(worst <= 1e-9, f"sharded batched CR: residual {worst:.2e}")
    check(iters == iters3 and np.array_equal(Y, Y3),
          "sharded batched CR: the fused apply's solve differs from the "
          "three-stage one's")
    check(batched["sharded_batched_cr_step"] > 0
          and batched["block_sum"] == batched["csr_spmm"] == 0
          and k14_inside == 1 + iters,
          "sharded batched CR: the applies were not K16's fused launches, "
          "K14's sum inside each")
    bad = sorted(k for k in sys.modules
                 if k.split(".")[0] in ("ipx_tpu", "jax", "jaxlib"))
    check(not bad, f"modules of ipx_tpu or jax were imported: {bad[:5]}")
    rows["sharded_batched_cr_step"].update(full_solve_trips=iters,
                                           full_solve_worst=worst)
    rows["sharded_cr_step"].update(
        host_issued_kktiter1=host_issued["kktiter1"])
    return rows, launches


# afiro through the C API in a process without the card: ipx_solve returns
# INTERNAL_ERROR and enters neither presolve nor the IPM
HIDDEN = r"""
import sys
sys.path.insert(0, "tests")
import torch
from ipx_tpu_torch import capi
from ipx_tpu_torch.lp_solver import LpSolver
from lp_fixtures import afiro
assert not torch.cuda.is_available()
entered = []
for name in ("_presolve", "_interior_point_solve"):
    orig = getattr(LpSolver, name)
    setattr(LpSolver, name, lambda self, _o=orig, _n=name: (
        entered.append(_n), _o(self))[1])
h = capi.ipx_new()
a = afiro().arrays()
assert capi.ipx_load_model(h, a["num_var"], a["obj"], a["lb"], a["ub"],
                           a["num_constr"], a["Ap"], a["Ai"], a["Ax"],
                           a["rhs"], a["constr_type"]) == 0
print("status", capi.ipx_solve(h), "entered", entered)
"""

TRI_B = (1, 256, 1024)
TRI_ROW_B = 256       # the case of K17's row in the kernels line


# torch.profiler captures of each case of ONE_LAUNCH: a capture can miss a
# call's kernel (ROADMAP Queue 3 item 8), so no one capture decides
CAPTURES = 5
# seconds each capture stays open before the call and after its
# synchronize: the profiler drops a kernel whose device timestamps fall
# outside its window, and a kernel that ends just before the window closes
# can, by the skew between the device's clock and the host's
MARGIN = 0.005

# the CUDA kernels one K17 sweep (at each B of argv[2:], on a lower factor
# of 3000 rows), one stand-alone K2 apply with its dot (both forms) and, as
# the negative control, one K17 sweep in its per-level form (nlev launches)
# start, counted by torch.profiler in argv[1] captures a case, each open
# argv[2] seconds before the call and after it, in a fresh process; with
# the K5 host probe (k5_host_cost) before the first capture and after the
# last
ONE_LAUNCH = r"""
import json, sys, time
import numpy as np
import scipy.sparse as sp
import torch
from torch.profiler import ProfilerActivity, profile
from chip_smoke import k5_host_cost
from ipx_tpu_torch import backend, kernels
from ipx_tpu_torch.ops import spmv, trisolve
dev = backend.cuda_device()
rng = np.random.default_rng(0)
m = 3000
i = np.repeat(np.arange(1, m), 2)
j = (rng.random(len(i)) * i).astype(np.int64)
T = sp.csr_matrix((0.1 * rng.standard_normal(len(i)), (i, j)),
                  shape=(m, m)) + sp.diags(rng.uniform(1.0, 2.0, m))
sched = trisolve.level_schedule(sp.csr_matrix(T), True, dev)
A = sp.random(700, 1500, density=0.01, random_state=rng, format="csc")
nmd = spmv.NormalMatrixDevice(A, dev)
W = torch.ones(2200, dtype=torch.float64, device=dev)
v = torch.ones(700, dtype=torch.float64, device=dev)
dot = torch.empty(1, dtype=torch.float64, device=dev)
captures, margin = int(sys.argv[1]), float(sys.argv[2])
Bs = [int(b) for b in sys.argv[3:]]


def kernels_of(fn):
    fn()
    torch.cuda.synchronize()
    counts = []
    for _ in range(captures):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(margin)
            fn()
            torch.cuda.synchronize()
            time.sleep(margin)
        counts.append(sum(e.count for e in prof.key_averages()
                          if e.device_type.name == "CUDA"
                          and "Memcpy" not in e.key
                          and "Memset" not in e.key))
    return counts


host = {"before": k5_host_cost(dev)}
out = {}
for B in Bs:
    V = torch.ones((m, B), dtype=torch.float64, device=dev)
    out[f"sweep B={B}"] = kernels_of(lambda: kernels.level_solve(sched, V))
out["K2 with its dot"] = kernels_of(lambda: kernels.normal_apply(
    nmd.op_At, nmd.op_A, W, v, dot=dot))
out["K2 three"] = kernels_of(lambda: kernels.normal_apply(
    nmd.op_At, nmd.op_A, W, v, dot=dot, one_launch=False))
# V is the last B's
out[f"per level B={Bs[-1]}"] = kernels_of(
    lambda: kernels.level_solve(sched, V, per_level=True))
host["after"] = k5_host_cost(dev)
print(json.dumps({"nlev": sched.nlev, "captures": out, "k5_host": host}))
"""


def one_launch_expected(nlev, Bs=TRI_B):
    """{case of ONE_LAUNCH: its CUDA kernels a call}: one a K17 sweep at
    every B, one a stand-alone K2 apply with its dot, three for K2's three
    launches, and `nlev` for the per-level sweep at the last B."""
    return {**{f"sweep B={B}": 1 for B in Bs}, "K2 with its dot": 1,
            "K2 three": 3, f"per level B={Bs[-1]}": nlev}


def count_failures(captures, expected):
    """The failures of phase 10's kernel count, each a message; empty when
    it passes. `captures` maps each case to the CUDA kernels that each of
    its profiler captures recorded, `expected` each case to its count. A
    capture that recorded none of the call's kernels lost the trace and
    decides nothing; any other count than the expected one fails, and so
    does a case whose every capture recorded none."""
    failures = []
    for case, want in expected.items():
        got = captures.get(case, [])
        wrong = [c for c in got if c not in (0, want)]
        if wrong:
            failures.append(f"{case}: captures counted {wrong} CUDA kernels "
                            f"a call, not {want} (all captures {got})")
        elif not any(got):
            failures.append(f"{case}: no capture recorded its kernels "
                            f"(captures {got})")
    return failures


def one_launch_counts(captures=CAPTURES, margin=MARGIN):
    """ONE_LAUNCH's output, run in a fresh process (late in this one
    torch.profiler misses kernels, PERF.md §6): {"nlev", "captures": {case:
    CUDA kernels of each capture}, "k5_host": {"before", "after"}}."""
    out = subprocess.run([sys.executable, "-c", ONE_LAUNCH, str(captures),
                          str(margin), *map(str, TRI_B)], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, "the one-launch counts failed: "
          + out.stderr[-2000:])
    return json.loads(out.stdout.strip().splitlines()[-1])


def k5_host_cost(dev, calls=200, rounds=5):
    """What a K5 call costs this process's host, and what may make it cost
    more (ROADMAP Queue 3 item 6): the host microseconds of one
    kernels.csr_spmm call (700 x 1500 operand from a seed, B = 4, f64),
    the median of `rounds` rounds of `calls` issued back to back (a launch
    queue far from full); the process's threads; the CPU seconds its other
    threads burn while this one sleeps 0.5 s (workers left spinning); and
    whether a torch.profiler session is open."""
    import threading
    import scipy.sparse as sp
    import torch
    from ipx_tpu_torch import kernels
    from ipx_tpu_torch.ops import spmv
    rng = np.random.default_rng(5)
    A = sp.random(700, 1500, density=0.01, random_state=rng, format="csc")
    op = spmv.NormalMatrixDevice(A, dev).op_A
    U = torch.from_numpy(rng.standard_normal((1500, 4))).to(dev)
    Y = kernels.csr_spmm(op, U)
    torch.cuda.synchronize()
    per = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(calls):
            kernels.csr_spmm(op, U, out=Y)
        per.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()

    def others_cpu():
        tick, me = os.sysconf("SC_CLK_TCK"), threading.get_native_id()
        total = 0
        for tid in os.listdir("/proc/self/task"):
            try:
                with open(f"/proc/self/task/{tid}/stat") as f:
                    fields = f.read().rsplit(")", 1)[1].split()
            except OSError:
                continue
            if int(tid) != me:
                total += int(fields[11]) + int(fields[12])
        return total / tick

    c0 = others_cpu()
    time.sleep(0.5)
    spin = others_cpu() - c0
    return dict(us=round(statistics.median(per), 2),
                threads=len(os.listdir("/proc/self/task")),
                others_cpu_s=round(spin, 2),
                profiler_on=bool(torch.autograd.profiler._is_profiler_enabled))


def library_solve(L_lib, U_lib, V):
    """L U X = V by torch.triangular_solve on sparse CSR factors (cuSPARSE
    on the card), the yardstick of K17; the port never calls it."""
    import torch
    Y = torch.triangular_solve(V, L_lib, upper=False)[0]
    return torch.triangular_solve(Y, U_lib, upper=True)[0]


def trisolve_phase(card, L, U, dev):
    """Phase 10: K17 on the factors L and U (scipy CSR) of phase 4's host
    basis, entry()'s step and the C API on afiro. Returns K17's kernel row
    (full solves at B = TRI_ROW_B) and the launch counts of the main path,
    the full solves at every B of TRI_B."""
    import scipy.sparse.linalg as spla
    import torch
    from ipx_tpu_torch import capi, entry, kernels
    from ipx_tpu_torch.ops import spmv, trisolve
    from ipx_tpu_torch.parallel import batch
    from lp_fixtures import afiro

    m = L.shape[0]
    t0 = time.perf_counter()
    sL = trisolve.level_schedule(L, True, dev)
    sU = trisolve.level_schedule(U, False, dev)
    t_sched = time.perf_counter() - t0
    print(f"phase 10: level-scheduled solves with splu's L and U of phase "
          f"4's host basis, m={m}, nnz(L)={L.nnz}, nnz(U)={U.nnz}: "
          f"{sL.nlev} L levels, {sU.nlev} U levels, Rmax {sL.Rmax}, Emax "
          f"{sL.Emax}; schedules built in {t_sched:.2f} s; {card}",
          flush=True)
    rng = np.random.default_rng(10)
    Vs = {B: torch.from_numpy(rng.standard_normal((m, B))).to(dev)
          for B in TRI_B}

    def full(V):
        return trisolve.level_solve(sU, trisolve.level_solve(sL, V))

    def full_plain(V):
        return trisolve.level_solve_plain(
            sU, trisolve.level_solve_plain(sL, V))

    def full_levels(V):
        return kernels.level_solve(sU, kernels.level_solve(
            sL, V, per_level=True), per_level=True)

    # the main path: a full solve at every B
    torch.cuda.synchronize()
    kernels.reset_launches()
    X = {B: full(V) for B, V in Vs.items()}
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    check(launches["level_solve"] == len(TRI_B) * 2,
          f"K17 launched {launches['level_solve']} times, not once a sweep")

    L_lib, U_lib = (library_csr(spmv.CsrOperand(T.indptr, T.indices, T.data,
                                                m, dev, torch.float64))
                    for T in (L, U))
    lib_error = None
    row = None
    for B, V in Vs.items():
        Y = trisolve.level_solve(sL, V)
        again = trisolve.level_solve(sL, V)
        Xk = trisolve.level_solve(sU, Y)
        errs = [rel_err(Y, trisolve.level_solve_plain(sL, V)),
                rel_err(Xk, trisolve.level_solve_plain(sU, Y))]
        k = min(B, 8)
        Yh, Vh = Y[:, :k].cpu(), V[:, :k].cpu().numpy()
        errs.append(rel_err(Yh, torch.from_numpy(
            spla.spsolve_triangular(L, Vh, lower=True))))
        errs.append(rel_err(Xk[:, :k].cpu(), torch.from_numpy(
            spla.spsolve_triangular(U, Yh.numpy(), lower=False))))
        torch.cuda.synchronize()
        check(torch.equal(Y, again), f"K17 B={B}: two runs differ")
        check(torch.equal(Xk, X[B]), f"K17 B={B}: the main path's full "
              "solve differs from this one")
        Y_l = kernels.level_solve(sL, V, per_level=True)
        check(torch.equal(Y, Y_l) and torch.equal(
            Xk, kernels.level_solve(sU, Y_l, per_level=True)),
            f"K17 B={B}: the sweep differs from the per-level form")
        X_p = full_plain(V)
        k17_forms = {"sweep": lambda: full(V),
                     "per level": lambda: full_levels(V)}
        ev, _, bb = forms_in_turns(k17_forms, tuple(k17_forms),
                                   device=False)
        ms = statistics.median(ev["sweep"])
        pms = cuda_ms(lambda: full_plain(V))
        lms = None
        if lib_error is None:
            try:
                X_l = library_solve(L_lib, U_lib, V)
                torch.cuda.synchronize()
                lms = cuda_ms(lambda: library_solve(L_lib, U_lib, V))
                lib = (f"torch.triangular_solve L then U: {lms:.4f} ms "
                       f"(rel diff {rel_err(X_l, X_p):.1e})")
            except Exception as e:   # the yardstick only: say why
                lib_error = f"{type(e).__name__}: {e}"
        if lib_error is not None:
            lib = f"torch.triangular_solve refused: {lib_error[:300]}"
        err = max(errs)
        print(f"  K17 level_solve  full solve B={B:<5d} rel_err {err:.3e} "
              f"(tol 1e-12; L sweep and U sweep against plain and "
              f"spsolve_triangular; bit for bit with the per-level form) "
              f"kernel {ms:.4f} ms  plain {pms:.4f} ms | {lib} | {card}",
              flush=True)
        print(f"  {'':15s} B={B} sweep (1 launch a sweep) and per level "
              f"({sL.nlev}+{sU.nlev} launches): " + turns_line(ev, None, bb)
              + f" | {card}", flush=True)
        check(err <= 1e-12, f"K17 B={B}: relative error {err:.3e} > 1e-12")
        if B == TRI_ROW_B:
            e_off = sL.cols.numel() + sU.cols.numel()
            sched_bytes = sum(nbytes(s.rows, s.entry_ptr, s.cols, s.vals,
                                     s.inv_diag) for s in (sL, sU))
            row = dict(case=f"full solve (L then U sweep), f64, B={B}, "
                       f"{sL.nlev}+{sU.nlev} levels, one launch a sweep",
                       max_abs_err=max_abs(X[B], X_p), ms=ms, plain_ms=pms,
                       library_ms=lms,
                       per_level_ms=statistics.median(ev["per level"]),
                       back_to_back_ms=statistics.median(bb["sweep"]),
                       per_level_back_to_back_ms=statistics.median(
                           bb["per level"]),
                       **bound(sched_bytes + 2 * 2 * m * B * 8,
                               2 * (e_off + 2 * m) * B, "f64"))
        del Y, again, Xk, X_p
    del Vs, X
    torch.cuda.empty_cache()
    check(launches["level_solve"] > 0, "K17 was not launched")
    # the CUDA kernels of a K17 sweep, of a stand-alone K2 apply and of the
    # per-level sweep, from torch.profiler in a fresh process; the K5 host
    # probe here, late in this process, beside phase 2's and the fresh
    # process's
    late = k5_host_cost(dev)
    kern = one_launch_counts()
    print(f"  CUDA kernels a call, {CAPTURES} torch.profiler captures a case "
          f"({MARGIN} s open on each side) in a fresh process (nlev "
          f"{kern['nlev']}): {kern['captures']} | {card}\n  K5 host probe: "
          f"phase 10 {late}; fresh process before "
          f"its captures {kern['k5_host']['before']}, after them "
          f"{kern['k5_host']['after']} | {card}", flush=True)
    failures = count_failures(kern["captures"],
                              one_launch_expected(kern["nlev"]))
    check(not failures, "phase 10's kernel count: " + "; ".join(failures))

    # entry(): one batched IPM step with the default device, the card, then
    # timed from copies of the same state, beside the plain versions' step
    step, (S,) = entry.entry()
    solver = step.__self__
    start = {k: v.clone() if torch.is_tensor(v) else v for k, v in S.items()}

    def fresh():
        return {k: v.clone() if torch.is_tensor(v) else v
                for k, v in start.items()}

    mu0 = solver._mu_of(S).clone()
    torch.cuda.synchronize()
    kernels.reset_launches()
    out = step(S)
    torch.cuda.synchronize()
    stepped = {k: v for k, v in kernels.LAUNCHES.items() if v}
    mu1 = solver._mu_of(out)
    ok = all(bool(torch.isfinite(out[k]).all()) for k in ("X", "Y", "mu"))
    plain = batch.PlainBatchedPhase1Solver(solver.lp, maxiter=50,
                                           device=dev.type,
                                           cr_dtype=solver.cr_dtype)
    ms = cuda_ms(lambda: step(fresh()))
    pms = cuda_ms(lambda: plain._ipm_step(fresh()))
    nm, B = start["X"].shape
    trips = int(out["cr"]) - int(start["cr"])
    A_ops = solver.nmd.op_A, solver.nmd.op_At
    b = bound(sum(op_bytes(op) for op in A_ops)
              + 2 * nbytes(*(start[k] for k in ("X", "XL", "XU", "Y", "ZL",
                                                "ZU")))
              + nbytes(solver.bT, solver.cT, solver.static["lb"],
                       solver.static["ub"]),
              trips * (4 * solver.lp.A.nnz + nm + 20 * solver.m) * B, "f32")
    print(f"  entry(): state on {S['X'].device}, one batched IPM step over "
          f"{B} scenarios ({trips} CR trips): event {ms:.4f} ms, plain "
          f"{pms:.4f} ms, bound {b['bound_ms'] * 1e3:.3f} us "
          f"({b['bound_by']}); finite {ok}, mu from max "
          f"{float(mu0.max()):.3e} to max {float(mu1.max()):.3e}; launches "
          f"{stepped} | {card}", flush=True)
    check(S["X"].device.type == "cuda", "entry(): the state is not on the "
          "card")
    check(ok and bool((mu1 < mu0).all()), "entry(): the step is not finite "
          "or mu did not fall on every lane")

    # the C API on afiro, with the default device
    h = capi.ipx_new()
    try:
        p = capi.ipx_get_parameters(h)
        check(p.device == "cuda", f"capi: default device {p.device!r}")
        p.display = 0
        capi.ipx_set_parameters(h, p)
        a = afiro().arrays()
        check(capi.ipx_load_model(h, a["num_var"], a["obj"], a["lb"],
                                  a["ub"], a["num_constr"], a["Ap"], a["Ai"],
                                  a["Ax"], a["rhs"], a["constr_type"]) == 0,
              "capi: load failed")
        kernels.reset_launches()
        st = capi.ipx_solve(h)
        info = capi.ipx_get_info(h)
        e = abs(info.objval - AFIRO) / abs(AFIRO)
        used = {k: v for k, v in kernels.LAUNCHES.items() if v}
    finally:
        capi.ipx_free(h)
    print(f"  capi.ipx_solve on afiro, device \"cuda\": status {st}, objval "
          f"{info.objval!r} (rel err {e:.1e}); launches {used}", flush=True)
    check(st == 1000 and e <= 1e-9, f"capi afiro: status {st}, rel err "
          f"{e:.1e}")
    check(used.get("cr_step", 0) > 0, "capi afiro: no kernel launched")
    # the C API with the card hidden: a status, not an exception
    out = subprocess.run([sys.executable, "-c", HIDDEN], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    said = out.stdout.strip().splitlines()[-1:] or [""]
    print(f"  capi.ipx_solve on afiro with CUDA_VISIBLE_DEVICES=\"\": rc "
          f"{out.returncode}, {said[0]}", flush=True)
    check(out.returncode == 0 and said[0] == "status 1004 entered []",
          "capi with the card hidden: " + (said[0] or out.stderr[-2000:]))
    bad = sorted(k for k in sys.modules
                 if k.split(".")[0] in ("ipx_tpu", "jax", "jaxlib"))
    check(not bad, f"modules of ipx_tpu or jax were imported: {bad[:5]}")
    return row, launches


# phase 11: the port's measuring tools on "cuda", each in a fresh process:
# (tool, its arguments); the bench at its own 20k instance, the others small
SMALL = ["--src", "300", "--snk", "450", "--density", "0.01"]
TOOL_RUNS = (
    ("torch_bench.py", ["--quick"]),
    ("torch_device_batch_solve_bench.py", SMALL + ["--B", "32",
                                                  "--handoff"]),
    ("torch_device_batched_bench.py", ["--sources", "300", "--sinks", "450",
                                       "--batches", "8", "256"]),
    ("torch_pipeline_e2e_bench.py", SMALL + ["--B", "4"]),
    ("torch_batched_finish_bench.py", ["--src", "30", "--snk", "45",
                                       "--density", "0.3", "--B", "4"]),
    ("torch_scaling_table.py", ["--src", "300", "--snk", "450"]),
)


def need(launches, names, what):
    """Fails unless each kernel of `names` was launched in `launches`."""
    missing = [k for k in names if launches.get(k, 0) <= 0]
    check(not missing, f"phase 11: {what} launched no {missing}")


def tool_checks(tool, line, card):
    """The checks of one tool's last line: the card, its statuses and the
    launches of the kernels its path runs."""
    check(line.get("failures") == [], f"phase 11: {tool}: "
          f"{line.get('failures')}")
    if tool == "torch_bench.py":
        extra = line["extra"]
        check(extra["card"] == card, f"phase 11: {tool} ran on "
              f"{extra['card']!r}")
        check(all(st[0] == 1000 for st in extra["solve_status"].values()),
              f"phase 11: bench statuses {extra['solve_status']}")
        need(extra["launches"]["solve"], SINGLE, "the bench's cuda solve")
        need(extra["launches"]["rates"], ("normal_apply",
                                          "normal_apply_batched"),
             "the bench's rates")
        need(extra["batched_stage_device"]["launches"], BATCHED,
             "the bench's stage")
        return
    check(line["card"] == card, f"phase 11: {tool} ran on {line['card']!r}")
    if tool == "torch_device_batch_solve_bench.py":
        need(line["launches"], BATCHED, tool)
    elif tool == "torch_device_batched_bench.py":
        need(line["launches"], ("normal_apply_batched",), tool)
    elif tool == "torch_pipeline_e2e_bench.py":
        check(line["optimal"] == line["B"], f"phase 11: {tool}: "
              f"{line['optimal']} of {line['B']} optimal")
        need(line["phase1_launches"], BATCHED, tool + " phase 1")
        need(line["finish_launches"], SINGLE, tool + " finishes")
    elif tool == "torch_batched_finish_bench.py":
        need(line["phase1_launches"], BATCHED, tool + " phase 1")
        finishes = {}
        for k in ("r3_finish_only", "r4_shared_basis_polish",
                  "r5_polish_with_correction"):
            check(line[k]["optimal"] == line["B"], f"phase 11: {tool} "
                  f"{k}: {line[k]['optimal']} of {line['B']} optimal")
            if not k.startswith("r3"):
                need(line[k]["launches"], POLISH, f"{tool} {k}'s polish")
            for name in SINGLE:
                finishes[name] = (finishes.get(name, 0)
                                  + line[k]["launches"].get(name, 0))
        need(finishes, SINGLE, tool + "'s finishes")
    elif tool == "torch_scaling_table.py":
        for row in line["rows"]:
            check(row["trips"] == line["trips"], f"phase 11: {tool} P="
                  f"{row['blocks']}: {row['trips']} trips")
            need(row["launches"], ("sharded_cr_step",),
                 f"{tool} P={row['blocks']}")


def tools_phase(card):
    """Phase 11: each of the port's six measuring tools once on "cuda" in
    a fresh process: the bench alone (--quick at the 20k LP), then the
    other five together at small sizes. Each must exit 0, and its last
    line must name the card, hold statuses 1000 and launches of the
    kernels its path runs."""
    def start(tool, args):
        return subprocess.Popen(
            [sys.executable, os.path.join("tools", tool), "--device",
             "cuda"] + args, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)

    def finish(tool, proc):
        try:
            out, err = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            fail(f"phase 11: {tool} ran past 600 s")
        check(proc.returncode == 0, f"phase 11: {tool} exited "
              f"{proc.returncode}: {err[-2000:]}")
        line = json.loads(out.strip().splitlines()[-1])
        tool_checks(tool, line, card)
        print(f"  {tool}: {json.dumps(line)}", flush=True)

    (bench, bench_args), rest = TOOL_RUNS[0], TOOL_RUNS[1:]
    t0 = time.perf_counter()
    finish(bench, start(bench, bench_args))
    print(f"  the bench took {time.perf_counter() - t0:.1f} s | {card}",
          flush=True)
    procs = [(tool, start(tool, args)) for tool, args in rest]
    try:
        for tool, proc in procs:
            finish(tool, proc)
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


# phase 12: the sweep tools, each in a fresh process: (tool, device, its
# arguments); the quick results table on "cuda" and on "cpu"
SWEEP_RUNS = (
    ("torch_stress_sweep.py", "cuda", ["--quick", "--seeds", "0-1"]),
    ("torch_results_table.py", "cuda", ["--quick"]),
    ("torch_results_table.py", "cpu", ["--quick"]),
    ("torch_lu_update_compare.py", "cuda", ["--quick"]),
)


def sweep_rows(tool, line):
    """Every "cuda" solve of a sweep tool's last line at status 1000, with
    a cr_step launch where phase 1 ran on the device and an nnt launch
    where phase 2 ran; returns the count of solves and their launches."""
    total = {}
    for r in line["rows"]:
        tag = (f"phase 12: {tool} "
               + " ".join(str(r[k]) for k in ("gen", "seed", "variant",
                                              "instance", "kern") if k in r))
        k1 = r.get("kktiter1", r.get("kkt1"))
        k2 = r.get("kktiter2", r.get("kkt2"))
        launches = r["launches"]
        check(r["status"] == 1000, f"{tag}: status {r['status']}")
        if k1 > 0 and r["dense_cols"] == 0:
            check(launches.get("cr_step", 0) > 0, f"{tag}: phase 1 ran "
                  f"{k1} CR iterations and launched no cr_step")
        check(k2 <= 0 or launches.get("nnt", 0) > 0, f"{tag}: phase 2 ran "
              f"{k2} CR iterations and launched no nnt")
        for name, v in launches.items():
            if name != "inside":
                total[name] = total.get(name, 0) + v
    return len(line["rows"]), total


def sweep_phase(card):
    """Phase 12: the stress sweep, the quick results table (on "cuda" and
    on "cpu") and the quick LU comparison, each once in a fresh process,
    all at once, --out in a temporary directory."""
    lines = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        try:
            for k, (tool, device, args) in enumerate(SWEEP_RUNS):
                if tool != "torch_stress_sweep.py":
                    args = args + ["--out", os.path.join(tmp, f"{k}.tbl")]
                procs.append(((tool, device), subprocess.Popen(
                    [sys.executable, os.path.join("tools", tool),
                     "--device", device] + args, cwd=REPO,
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True)))
            for key, proc in procs:
                try:
                    out, err = proc.communicate(timeout=600)
                except subprocess.TimeoutExpired:
                    fail(f"phase 12: {key} ran past 600 s")
                check(proc.returncode == 0, f"phase 12: {key} exited "
                      f"{proc.returncode}: {out[-1500:]} {err[-2000:]}")
                lines[key] = json.loads(out.strip().splitlines()[-1])
        finally:
            for _, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    for (tool, device), line in lines.items():
        check(line["card"] == card and line["device"] == device,
              f"phase 12: {tool} on {device} ran on {line['card']!r}")
        check(line["failures"] == [], f"phase 12: {tool} on {device}: "
              f"{line['failures']}")
        if device == "cuda":
            n, total = sweep_rows(tool, line)
            print(f"  {tool} on \"cuda\": {n} solves at status 1000; "
                  f"launches {total}", flush=True)
    table = {d: lines[("torch_results_table.py", d)]["rows"]
             for d in ("cuda", "cpu")}
    check([r["instance"] for r in table["cuda"]]
          == [r["instance"] for r in table["cpu"]],
          "phase 12: the two quick tables hold other instances")
    for rc, rh in zip(table["cuda"], table["cpu"]):
        errs = [abs(rc[k] - rh[k]) / abs(rh[k]) for k in ("objective",
                                                          "objval")]
        print(f"  {rc['instance']:22s} cuda {rc['status']} {rc['objective']!r}"
              f" ({rc['time']:.3f} s, {rc['iter']} it) cpu {rh['status']} "
              f"{rh['objective']!r} ({rh['time']:.3f} s, {rh['iter']} it); "
              f"rel err pobjval {errs[0]:.1e}, objval {errs[1]:.1e}",
              flush=True)
        check(rc["status"] == rh["status"], f"phase 12: {rc['instance']}: "
              f"status {rc['status']} on cuda, {rh['status']} on cpu")
        check(max(errs) <= 1e-8, f"phase 12: {rc['instance']}: objectives "
              f"{errs[0]:.2e} (pobjval), {errs[1]:.2e} (objval) apart")
    print(f"  | {card}", flush=True)


MESH_TIMEOUT = 120.0     # seconds: the mesh's start and each collective


def mesh_trips(what, stats, card):
    """Prints a mesh solve's per-rank trips, seconds a trip and collective
    share (and, for the row CR, the share of the gathers of the (P, n)
    parts of u), and returns the slowest rank's (ms a trip, share)."""
    worst = (0.0, 0.0)
    for st in stats:
        per = st["seconds"] / max(st["trips"], 1) * 1e3
        share = st["collective_s"] / max(st["seconds"], 1e-12)
        worst = max(worst, (per, share))
        launches = {k: v for k, v in st.items() if k.endswith("launches")}
        parts = (f", the parts of u {st['parts_s']:.4f} s "
                 f"({100 * st['parts_s'] / max(st['seconds'], 1e-12):.1f}%)"
                 if "parts_s" in st else "")
        print(f"  {what} rank {st['rank']}: {st['trips']} trips, "
              f"{st['seconds']:.4f} s, {per:.4f} ms a trip, collectives "
              f"{st['collective_s']:.4f} s ({100 * share:.1f}%){parts}; "
              f"{launches} | {card}", flush=True)
    return worst


def mesh_phase(card, data, md, N2, dev, own_cards=False):
    """Phase 13, the mesh (see the module docstring): its ranks share the
    card, or with `own_cards` (--mesh-cards) each has a card of its own,
    cards 0..P-1, over NCCL."""
    import torch
    from ipx_tpu_torch import LpSolver, Parameters, entry
    from ipx_tpu_torch import testgen as tg
    from ipx_tpu_torch.parallel import mesh as pm
    from ipx_tpu_torch.parallel import sharding
    from ipx_tpu_torch.sparse import normal_diag

    P = P_SHARDS
    A = md.A
    m, n = A.shape
    rng = np.random.default_rng(13)
    t0 = time.perf_counter()
    devices = ([f"cuda:{k}" for k in range(P)] if own_cards
               else [str(dev)] * P)
    mesh = pm.Mesh((P,), ("rows",), devices, timeout=MESH_TIMEOUT)
    print(f"phase 13: {mesh.describe()}, started in "
          f"{time.perf_counter() - t0:.2f} s | {card}", flush=True)
    if own_cards:
        check(mesh.transport == "nccl" and not mesh.staged,
              f"{P} ranks on {P} cards took {mesh.transport}, not NCCL")
    else:
        check(mesh.transport == "gloo" and mesh.staged,
              f"4 ranks on one card took {mesh.transport}, not gloo staged")
    summary = {"transport": mesh.describe()}
    try:
        # one phase-1 CR solve at the phase-2 LP, against the one-card K15
        W = 10.0 ** rng.uniform(-2, 2, n + m)
        diag = normal_diag(A, W)
        resscale = 1.0 / np.sqrt(W[n:])
        rhs = rng.standard_normal(m)
        one = sharding.ShardedDiagCR(A, P, dev)
        t1 = time.perf_counter()
        want = one.solve(W[:n], W[n:], diag, resscale, rhs, 1e-8, 400)
        torch.cuda.synchronize()
        t_one = time.perf_counter() - t1
        over = sharding.ShardedDiagCR(A, P, mesh=mesh)
        t1 = time.perf_counter()
        got = over.solve(W[:n], W[n:], diag, resscale, rhs, 1e-8, 400)
        t_mesh = time.perf_counter() - t1
        print(f"  ShardedDiagCR P={P} at m={m} n={n}: one card (K15's "
              f"cooperative launch) {want[1]} trips, err {want[2]}, "
              f"{t_one:.4f} s; mesh {got[1]} trips, err {got[2]}, "
              f"{t_mesh:.4f} s | {card}", flush=True)
        check(got[1:] == want[1:] and np.array_equal(got[0], want[0]),
              "the mesh's CR solve is not the one-card K15's bit for bit")
        mesh_trips("CR", mesh.last[-1], card)
        # again: the per-trip time without the first solve's set-up
        t1 = time.perf_counter()
        again = over.solve(W[:n], W[n:], diag, resscale, rhs, 1e-8, 400)
        t_mesh = time.perf_counter() - t1
        check(again[1:] == got[1:] and np.array_equal(again[0], got[0]),
              "the mesh's CR solve differs from run to run")
        per, share = mesh_trips("CR again", mesh.last[-1], card)
        summary["cr"] = dict(trips=got[1], ms_a_trip=per,
                             collective_share=share,
                             one_card_ms_a_trip=t_one / max(want[1], 1)
                             * 1e3, wall_s=t_mesh)
        summary["k15_pass_launches"] = {
            st["rank"]: st["k15_launches"] for st in mesh.last[-1]}
        check(all(st["k15_launches"] > 0 and st["k14v_launches"] > 0
                  and st["k14_launches"] > 0 and st["k1_launches"] > 0
                  for st in mesh.last[-1]),
              "a rank launched no K15 pass, K14v, K14 or K1")

        # one N N' apply over 4 column blocks, against the one-card K4
        w = rng.standard_normal(m)
        one_n = sharding.ShardedSplittedNNt(m, N2.shape[1], P, dev)
        one_n.set_operand(N2)
        over_n = sharding.ShardedSplittedNNt(m, N2.shape[1], P, mesh=mesh)
        over_n.set_operand(N2)
        z_one = one_n.apply(w)
        t1 = time.perf_counter()
        z_mesh = over_n.apply(w)
        t_apply = time.perf_counter() - t1
        print(f"  N N' over {P} column blocks, nnz(N)={N2.nnz}: "
              f"{t_apply * 1e3:.3f} ms on the mesh | {card}", flush=True)
        check(np.array_equal(z_mesh, z_one),
              "the mesh's N N' is not the one-card K4's bit for bit")
        summary["nnt_apply_ms"] = t_apply * 1e3

        # the 2 x 2 rows x batch batched CR at B = 256, against K16 at P = 2
        B = B_FULL
        m2 = mesh.reshape((2, 2), ("rows", "batch"))
        W2 = 10.0 ** rng.uniform(-2, 2, (n + m, B))
        A2 = A.copy()
        A2.data = A2.data ** 2
        diag2 = np.asarray(A2 @ W2[:n]) + W2[n:]
        RHS = rng.standard_normal((m, B))
        snm2 = sharding.ShardedNormalMatrix(A, 2, dev)
        t1 = time.perf_counter()
        Y1, it1 = sharding.sharded_batched_cr_solve(snm2, W2[:n], W2[n:],
                                                    diag2, RHS, 1e-8, 20)
        t_one = time.perf_counter() - t1
        t1 = time.perf_counter()
        Y2, it2 = sharding.sharded_batched_cr_solve(snm2, W2[:n], W2[n:],
                                                    diag2, RHS, 1e-8, 20,
                                                    mesh=m2)
        t_mesh = time.perf_counter() - t1
        print(f"  sharded_batched_cr_solve B={B}, 20 trips at most: K16 at "
              f"P=2 on one card {it1} trips {t_one:.4f} s; 2 x 2 mesh "
              f"{it2} trips {t_mesh:.4f} s | {card}", flush=True)
        check(it1 == it2 and np.array_equal(Y1, Y2),
              "the 2 x 2 mesh's batched CR is not K16's at P = 2 bit for bit")
        check(all(st["exact"] for st in m2.last[-1]),
              f"a rank of the 2 x 2 mesh at B = {B} did not keep the one "
              f"card's grids")
        per, share = mesh_trips("batched CR", m2.last[-1], card)
        summary["batched_cr"] = dict(trips=it2, ms_a_trip=per,
                                     collective_share=share,
                                     one_card_ms_a_trip=t_one / max(it1, 1)
                                     * 1e3)
        summary["k16_pass_launches"] = {
            st["rank"]: st["k16_launches"] for st in m2.last[-1]}
        check(all(st["k16_launches"] > 0 and st["k5_launches"] > 0
                  and st["k14_launches"] > 0 for st in m2.last[-1]),
              "a rank launched no K16 pass, K5 or K14")

        # the phase-4 LP with shards=4 over the mesh, against "cpu" and the
        # one-process shards=4 solve
        objs = {}
        for how in ("cpu", "one process", "mesh"):
            s = LpSolver(Parameters(display=0, device="cuda" if how != "cpu"
                                    else "cpu",
                                    shards=P if how != "cpu" else None))
            check(tg.load_into_solver(data, s) == 0, "load_model failed")
            mesh.reset_launches()
            t1 = time.perf_counter()
            if how == "mesh":
                with mesh:
                    st = s.solve()
            else:
                st = s.solve()
            wall = time.perf_counter() - t1
            i = s.get_info()
            objs[how] = i.pobjval
            print(f"  LpSolver(shards={P if how != 'cpu' else None}) "
                  f"{how}: status {st}, pobjval {i.pobjval!r}, wall "
                  f"{wall:.3f} s, CR iters {i.kktiter1}+{i.kktiter2}, cr1 "
                  f"{i.time_cr1:.3f} s, cr2 {i.time_cr2:.3f} s | {card}",
                  flush=True)
            check(st == 1000, f"shards={P} {how}: status {st}")
            if how == "mesh":
                launched = mesh.launches()
                print(f"  launches by rank in the mesh solve: {launched}",
                      flush=True)
                summary["solve"] = dict(wall_s=wall, kktiter1=i.kktiter1,
                                        kktiter2=i.kktiter2,
                                        launches=launched)
                check(s.model._sharded_cr[1].mesh is mesh
                      and s.model._sharded_nnt[1].mesh is mesh,
                      "the solve's blocks were not on the mesh")
                check(sorted(launched) == list(range(P)) and all(
                    c.get(k, 0) > 0 for c in launched.values()
                    for k in ("sharded_cr_step", "block_spmv_sum",
                              "block_sum", "csr_spmv", "nnt")),
                      "a rank launched no K15 pass, K14v, K14, K1 or K4 in "
                      "the mesh solve")
        for how in ("cpu", "one process"):
            e = abs(objs["mesh"] - objs[how]) / abs(objs[how])
            check(e <= 1e-8, f"the mesh solve's pobjval differs from "
                  f"{how}'s by {e:.1e}")

        t1 = time.perf_counter()
        entry.dryrun_multichip(P, mesh=mesh)
        print(f"  dryrun_multichip({P}) over the mesh: "
              f"{time.perf_counter() - t1:.2f} s | {card}", flush=True)
    finally:
        mesh.close()

    # a 1-rank NCCL mesh: one sharded_cr_solve, against the one-card one
    nccl = pm.Mesh((1,), ("rows",), [str(dev)], timeout=MESH_TIMEOUT)
    try:
        check(nccl.transport == "nccl" and not nccl.staged,
              f"one rank on a card took {nccl.transport}")
        W = 10.0 ** rng.uniform(-2, 2, n + m)
        diag = normal_diag(A, W)
        rhs = rng.standard_normal(m)
        want = sharding.sharded_cr_solve(sharding.ShardedNormalMatrix(
            A, 1, dev), W[:n], W[n:], diag, rhs, 1e-8, 300)
        snm1 = sharding.ShardedNormalMatrix(A, 1, mesh=nccl)
        for run in ("", " again"):   # the first sets NCCL's communicator up
            got = sharding.sharded_cr_solve(snm1, W[:n], W[n:], diag, rhs,
                                            1e-8, 300)
            print(f"  {nccl.describe()}: sharded_cr_solve{run} {got[1]} "
                  f"trips (one card {want[1]}) | {card}", flush=True)
            check(got[1] == want[1] and np.array_equal(got[0], want[0]),
                  "the NCCL mesh's solve is not the one-card one bit for "
                  "bit")
            per, share = mesh_trips("NCCL CR" + run, nccl.last[-1], card)
        summary["nccl_cr"] = dict(trips=got[1], ms_a_trip=per,
                                  collective_share=share)
    finally:
        nccl.close()
    print(json.dumps({"mesh": summary, "card": card}), flush=True)


def mesh_cards_main():
    """`python3 chip_smoke.py --mesh-cards`: phase 13 alone with its mesh
    over cards 0..3, one rank a card (NCCL), on a machine with four cards;
    the kernels are built first and the phase-2 LP presolved as main()
    does. The last line is main()'s."""
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    have = torch.cuda.device_count()
    if have < P_SHARDS:
        fail(f"--mesh-cards needs {P_SHARDS} cards, this machine has {have}")
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    card = f"{lines[0]} (x{len(lines)})"
    from ipx_tpu_torch import LpSolver, Parameters, backend, build
    from ipx_tpu_torch import testgen as tg
    from ipx_tpu_torch.kkt.splitted_normal import SplittedNormalMatrix
    build.build_native()
    build.build(force=True)
    dev = backend.cuda_device()
    data = tg.transportation(8000, 12000, 0.001, seed=1)
    host = LpSolver(Parameters(display=0, device="cpu", stop_at_switch=1))
    check(tg.load_into_solver(data, host) == 0, "load_model failed")
    host.solve()
    md = host.basis.model
    sn = SplittedNormalMatrix(md)
    sn.prepare(host.basis, host.iterate.scaling_factors())
    t0 = time.perf_counter()
    mesh_phase(card, data, md, sn.N, dev, own_cards=True)
    print(f"phase 13 over {P_SHARDS} cards took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--mesh-cards"]:
        mesh_cards_main()
    else:
        main()
