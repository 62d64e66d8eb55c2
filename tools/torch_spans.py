"""The program's spans and counters over windows of a benchmark cell.

    python tools/torch_spans.py --workload transport20k.b256 --seed 7 \\
        --seconds 20 [--trace 0|1] [--forms spans,stub,stub,spans]

Serves the cell's requests through lpbench's entry and window (lpbench/run.py,
lpbench/entries/), as the benchmark does, once per form in the order given:
`spans`, the program as it is, or `stub`, the program with trace.span and
trace.count replaced by no-ops (the comparison that prices them). Each
request's solver record (BatchedPhase1Solver.trace) is kept beside the
harness's own numbers for it.

Prints, per window, one JSON line: the rate (scenarios/s, the benchmark's
scen_per_s over this window), the means of the numbers a request's
per-layer metrics would read and of its bytes copied (`request_numbers`),
every span's mean seconds a request, the ratio of ipxt.construct to the
harness's construct_s request by request; and, traced, the device's idle
share, the device operations by name, the idle gaps labelled by the
innermost `ipxt.` span and the host operation under it, the ipxt. spans
found outside every lpbench.* span (none expected) and the device
operations named like a span (none expected). The whole record of each
window goes to chiprun_out/spans_<workload>.json.

`--device torch_cpu` rehearses on the CPU with lpbench's tiny cell (the
plain versions; no rate or device number means anything there).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from ipx_tpu_torch import trace  # noqa: E402
from ipx_tpu_torch.parallel import batch  # noqa: E402

GAPS = 30           # idle-gap labels kept, the longest first


def request_numbers(record: trace.Record) -> dict:
    """The numbers of one request that the per-layer metrics
    construct_operands_s, construct_inputs_s, copy_out_s, cr_f64_trips and
    host_syncs would read from its solver's record, and beside host_syncs
    the bytes its constructor's inputs and its copy out moved through
    page-locked and pageable host memory."""
    s, c = record.seconds, record.counts
    return dict(construct_operands_s=s.get("ipxt.construct.operands", 0.0),
                construct_inputs_s=s.get("ipxt.construct.inputs", 0.0),
                copy_out_s=s.get("ipxt.copy_out", 0.0),
                cr_f64_trips=c.get("cr_f64_trips", 0),
                host_syncs=c.get("host_syncs", 0),
                copy_bytes_pinned=c.get("copy_bytes_pinned", 0),
                copy_bytes_pageable=c.get("copy_bytes_pageable", 0))


class _NullSpan:
    def __init__(self, name):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _stubbed(on: bool):
    """Puts no-ops in the place of trace.span and trace.count (on), or the
    real ones back."""
    trace.span, trace.count = ((_NullSpan, lambda name, n=1: None) if on
                               else (_SPAN, _COUNT))


_SPAN, _COUNT = trace.span, trace.count


def cell_of(workload: str, device: str) -> dict:
    from lpbench import run
    cell = run.cell_of(run.load_benchmark(), workload)
    if device != "cuda":
        with open(os.path.join(ROOT, "lpbench", "tests", "data",
                               "tiny.json")) as f:
            cell = dict(cell, config=json.load(f),
                        traffic=dict(cell["traffic"], lanes=4, pool=3))
    return cell


def label_gaps(host, device) -> dict:
    """lpbench.tracing's summary with the idle gaps labelled by the
    innermost `ipxt.` span (else the lpbench.* span) over the gap's start."""
    from lpbench import tracing
    tracing.GAPS = GAPS
    renamed = [("lpbench." + n if n.startswith("ipxt.") else n, s, e)
               for n, s, e in host]
    return tracing.summarize(renamed, device)


def outside(host) -> int:
    """The ipxt. host spans that lie inside no lpbench.* span."""
    outer = [(s, e) for n, s, e in host
             if n.startswith("lpbench.") and n != "lpbench.window"]
    return sum(1 for n, s, e in host if n.startswith("ipxt.")
               and not any(s0 <= s and e <= e1 for s0, e1 in outer))


def window(entry, seconds: float, traced: bool, cuda: bool) -> dict:
    from lpbench import run, tracing
    records = []
    solve = batch.BatchedPhase1Solver.solve

    def kept(self, *a, **k):
        out = solve(self, *a, **k)
        records.append(self.trace)
        return out
    batch.BatchedPhase1Solver.solve = kept
    try:
        tracer = tracing.Tracer(cuda) if traced else None
        if tracer is not None:
            with tracer:
                w = run.serve_window(entry, seconds)
        else:
            w = run.serve_window(entry, seconds)
    finally:
        batch.BatchedPhase1Solver.solve = solve
    reqs = w["requests"]
    done = [r for r in reqs if r["finite"]]
    span = w["t_end"] - w["t0"]
    res = dict(requests=len(reqs), failed=w["failed"],
               rate=entry.lanes * len(done) / span if done else None,
               window_s=span)
    if len(records) == len(reqs):
        nums = [request_numbers(r) for r in records]
        res["means"] = {k: statistics.fmean(x[k] for x in nums)
                        for k in nums[0]} if nums else {}
        names = sorted({k for r in records for k in r.seconds})
        res["span_s"] = {k: statistics.fmean(r.seconds.get(k, 0.0)
                                             for r in records)
                         for k in names}
        res["counts"] = {k: statistics.fmean(r.counts.get(k, 0)
                                             for r in records)
                         for k in sorted({k for r in records
                                          for k in r.counts})}
        res["construct_ratio"] = [
            r.seconds["ipxt.construct"] / q["construct_s"]
            for r, q in zip(records, reqs)
            if "ipxt.construct" in r.seconds]
        res["construct_s"] = [q["construct_s"] for q in reqs]
        res["trips"] = [q["trips"] for q in reqs]
    if tracer is not None:
        host, dev = tracer.events()
        harness = tracing.summarize(host, dev)
        mine = label_gaps(host, dev)
        res.update(
            idle_share=100.0 * (1.0 - harness["busy_s"]
                                / harness["window_s"]),
            device_ops=harness["device_ops"],
            span_named_device_ops=[k for k, _, _ in harness["kernels"]
                                   if k.startswith(("ipxt.", "lpbench."))],
            harness_gaps=harness["idle_gaps"],
            ipxt_gaps=mine["idle_gaps"], spans_outside=outside(host),
            ipxt_host_spans=sum(1 for n, _, _ in host
                                if n.startswith("ipxt.")))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="transport20k.b256")
    ap.add_argument("--seed", type=int, default=4300000101)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--forms", default="spans")
    ap.add_argument("--device", default="cuda",
                    choices=("cuda", "torch_cpu"))
    args = ap.parse_args(argv)
    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        print("torch_spans: no CUDA card", file=sys.stderr)
        return 2
    import importlib
    cell = cell_of(args.workload, args.device)
    entry = importlib.import_module(
        f"lpbench.entries.{cell['traffic']['entry']}").Entry(
        cell["config"], cell["traffic"], args.seed, args.device)
    t0 = time.perf_counter()
    entry.warm_up()
    card = (torch.cuda.get_device_name(0) if cuda else "cpu")
    head = dict(workload=args.workload, seed=args.seed, card=card,
                device=args.device, warm_up_s=time.perf_counter() - t0)
    results = []
    for i, form in enumerate(args.forms.split(",")):
        if form not in ("spans", "stub"):
            raise SystemExit(f"unknown form {form!r}")
        _stubbed(form == "stub")
        try:
            res = window(entry, args.seconds, bool(args.trace), cuda)
        finally:
            _stubbed(False)
        res = dict(head, turn=i, form=form, trace=args.trace, **res)
        results.append(res)
        short = {k: v for k, v in res.items()
                 if k not in ("construct_s", "construct_ratio", "trips",
                              "harness_gaps", "device_ops")}
        if res.get("construct_ratio"):
            r = res["construct_ratio"]
            short["construct_ratio"] = [min(r), statistics.median(r),
                                        max(r)]
        print(json.dumps(short), flush=True)
    out = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"spans_{args.workload}.json"), "a") as f:
        for res in results:
            f.write(json.dumps(res) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
