"""The benchmark of ipx_tpu_torch: one cell, one run, one JSON line.

    python3 lpbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is looked up by name in BENCHMARK.json at the root of the checkout:
its configuration file, its traffic file (lpbench/traffic/<name>.json), the
entry that the traffic names (lpbench/entries/<entry>.py), the limits of
that entry's check (lpbench/limits/<entry>.json) and, in a traced run, one
reader a per-layer metric (lpbench/metrics/<metric>.py). Adding any of them
is adding files and entries of BENCHMARK.json; this file stays as it is.

A run builds its inputs (the order of the traffic's requests from --seed),
warms up the cell's own shapes (set-up, `setup_s`), then serves requests one
after another for --seconds in a closed loop, rounded up to whole passes
over the traffic's pool of requests (the entry's `pass_len`), so that every
seed's window does the same work. The window's last request, whose batch
of the pool the seed's order draws, is then checked against the plain
reference (lpbench/reference/), each number compared printed beside its
limit as the last lines of standard error, and the result is printed as the
last line of standard output.
Without a card (torch.cuda) it exits 2 and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the program's build and kernel caches, at fixed paths inside the checkout
CACHE = os.path.join(ROOT, ".lpbench_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# when main() had torch imported and the card found (set-up's first part)
MARKS: dict = {}

# top-level module names that no run may load (the JAX package beside the
# port, and JAX itself), compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "ipx_tpu")


def load_benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def load_json(*parts) -> dict:
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def cell_of(bench: dict, workload: str) -> dict:
    """The cell `workload`: its entry in BENCHMARK.json with its
    configuration, traffic, limits and metrics."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(configs[w["config"]]["file"])
    traffic = load_json("lpbench", "traffic", f"{w['traffic']}.json")
    limits = load_json("lpbench", "limits", f"{traffic['entry']}.json")

    def mine(metric):
        return workload in metric.get("workloads", [workload])
    return dict(name=workload, chips=w["chips"], config=config,
                traffic=traffic, limits=limits,
                end_to_end=[m for m in bench["end_to_end"] if mine(m)],
                per_layer=[m for m in bench["per_layer"] if mine(m)])


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


# -- the measured window ---------------------------------------------------------
def serve_window(entry, seconds: float):
    """Serves requests one after another until `seconds` have passed since
    the first one started and the last one has finished a whole pass over
    the entry's pool (entry.pass_len requests). Returns the record of the
    window: per request its times and counts, and the last request's
    answer, kept for the check. No other answer is held while the window
    runs: holding the program's first answer through a window slowed every
    later request by about a tenth on the card (PERF.md)."""
    requests, kept = [], None
    attempted = failed = 0
    launches0 = entry.launches()
    t0 = time.perf_counter()
    while True:
        i = attempted
        attempted += 1
        start = time.perf_counter()
        try:
            out, info = entry.serve(i)
        except Exception as exc:  # a request that raises counts as failed
            print(f"request {i} raised {type(exc).__name__}: {exc}",
                  file=sys.stderr)
            failed += 1
            out, info = None, None
        end = time.perf_counter()
        last = end - t0 >= seconds and attempted % entry.pass_len == 0
        if info is not None:
            requests.append(dict(info, index=i, start_s=start - t0,
                                 total_s=end - start))
            if not info["finite"]:
                failed += 1
            elif last:
                kept = (i, out)
        del out
        if last:
            break
    launches = {k: v - launches0.get(k, 0)
                for k, v in entry.launches().items()}
    return dict(t0=t0, t_end=end, attempted=attempted, failed=failed,
                requests=requests, launches=launches, kept=kept)


def end_to_end(cell, entry, window, setup_s) -> dict:
    """The cell's end-to-end metrics of an untraced run."""
    done = [r for r in window["requests"] if r["finite"]]
    span = window["t_end"] - window["t0"]
    values = dict(
        scen_per_s=(entry.lanes * len(done) / span) if done else None,
        setup_s=setup_s)
    return {m["name"]: dict(value=values[m["name"]], unit=m["unit"])
            for m in cell["end_to_end"] if values.get(m["name"]) is not None}


def per_layer(cell, record) -> dict:
    """The cell's per-layer metrics, each from its reader
    (lpbench/metrics/<name>.py); a reader that finds nothing to read
    returns None and its metric is left out."""
    out = {}
    for m in cell["per_layer"]:
        reader = importlib.import_module(f"lpbench.metrics.{m['name']}")
        value = reader.read(record)
        if value is not None:
            out[m["name"]] = dict(value=value, unit=m["unit"])
    return out


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str):
    """One run of `cell` on `device` ("cuda", or "torch_cpu" for a
    rehearsal). Returns (result, check lines)."""
    import torch
    from lpbench import tracing
    module = importlib.import_module(
        f"lpbench.entries.{cell['traffic']['entry']}")
    t_entry = time.perf_counter()
    entry = module.Entry(cell["config"], cell["traffic"], seed, device)
    entry.warm_up()
    # the parts of the set-up: torch and the card, the imports before the
    # entry, then the entry's own (the program's import, its instance, its
    # requests, its warm-up)
    t_torch = MARKS.get("torch", T_START)
    phases = dict(torch=t_torch - T_START, before_entry=t_entry - t_torch,
                  **entry.setup_phases)
    cuda = device == "cuda"
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - T_START
    tracer = tracing.Tracer(cuda) if trace else None
    if tracer is not None:
        with tracer:
            window = serve_window(entry, seconds)
    else:
        window = serve_window(entry, seconds)
    peak = None
    if cuda:
        peak = torch.cuda.max_memory_allocated()
    record = dict(cell=cell["name"], sizes=entry.sizes(),
                  lanes=entry.lanes, requests=window["requests"],
                  launches=window["launches"], window_peak_bytes=peak,
                  trace=tracer.summary() if tracer is not None else None)
    metrics = (per_layer(cell, record) if trace
               else end_to_end(cell, entry, window, setup_s))
    device_info = dict(platform="gpu" if cuda else "cpu",
                       kind=(torch.cuda.get_device_name(0) if cuda
                             else "cpu"),
                       count=1 if cuda else 0,
                       memory_peak_bytes=(max(setup_peak, peak) if cuda
                                          else None))
    result = dict(correct=False, attempted=window["attempted"],
                  failed=window["failed"], metrics=metrics,
                  device=device_info)
    if tracer is not None:
        t = record["trace"]
        device_info.update(busy_s=t["busy_s"], window_s=t["window_s"])
        result["breakdown"] = dict(device_ops=t["device_ops"],
                                   idle_gaps=t["idle_gaps"])
    kept = window.pop("kept")
    del window
    if kept is None:
        readings = {}
        lines = ["check: no request finished in the window"]
        correct = False
    else:
        index, out = kept
        t_check = time.perf_counter()
        readings = entry.check(index, out)
        readings.update(request=index,
                        check_s=time.perf_counter() - t_check)
        del out
        correct, lines = judge_readings(readings, cell["limits"])
        # what the check reads but does not judge (steps and CR trips of
        # both sides) goes before the judged numbers
        lines = [f"info {k} {v!r}" for k, v in readings.items()
                 if k not in cell["limits"]] + lines
    # each request's seconds, in the order served
    times = " ".join(f"{r['total_s']:.4f}" for r in record["requests"])
    lines = ([f"info setup.{k} {v!r}" for k, v in phases.items()]
             + [f"info request_s {times}"] + lines)
    result["correct"] = bool(correct and result["failed"] == 0)
    result["check"] = {k: dict(value=v, limit=cell["limits"][k])
                       for k, v in readings.items() if k in cell["limits"]}
    return result, lines


def judge_readings(readings: dict, limits: dict):
    """(every number within its limit, one line a number)."""
    lines, ok = [], True
    for name, limit in limits.items():
        value = readings.get(name)
        good = value is not None and math.isfinite(value) and value <= limit
        ok &= good
        lines.append(f"check {name} {value!r} limit {limit!r} "
                     f"{'ok' if good else 'FAILED'}")
    return ok, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = cell_of(load_benchmark(), args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"lpbench: the cell needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    MARKS["torch"] = time.perf_counter()
    result, lines = run_cell(cell, args.seed, args.seconds,
                             bool(args.trace), "cuda")
    loaded = forbidden_modules()
    if loaded:
        print(f"lpbench: the run loaded {loaded}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
