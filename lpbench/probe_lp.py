"""What a single-LP solve of a benchmark cell does besides its own work:
solves of one pool member, each with the host's CPU accounting around it.

    python3 lpbench/probe_lp.py --workload staircase120.single \
        [--solves 3] [--member 0] [--threads k] [--tag name]

Builds the cell's entry (lpbench/entries/lp_solve.py) as a run does,
warms it up, then solves pool member `member` `solves` times through it and
prints one JSON line a solve: its seconds; the process's CPU seconds (user,
system) and context switches (voluntary, involuntary) over the solve; the
machine's CPU time over the solve by /proc/stat (busy, idle, steal), in
seconds summed over its CPUs; the solve's Info counts and times; and the
spans and counters of solver.trace where the program has them. The same
member solved again does the same arithmetic, so a solve that takes longer
either did more (its counts) or waited more (its CPU accounting).
`--threads k` sets torch's thread count, which is also the OpenMP team of
the native LU's parallel regions (omp_get_max_threads), before the warm-up.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import os
import resource
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TICK = os.sysconf("SC_CLK_TCK")


def machine() -> dict:
    """The machine's CPU seconds so far, summed over its CPUs."""
    with open("/proc/stat") as f:
        v = [int(x) for x in f.readline().split()[1:]]
    user, nice, system, idle, iowait, irq, softirq, steal = v[:8]
    return dict(busy=(user + nice + system + irq + softirq) / TICK,
                idle=(idle + iowait) / TICK, steal=steal / TICK)


def process() -> dict:
    r = resource.getrusage(resource.RUSAGE_SELF)
    return dict(user=r.ru_utime, system=r.ru_stime, vcsw=r.ru_nvcsw,
                ivcsw=r.ru_nivcsw)


def delta(a: dict, b: dict) -> dict:
    return {k: round(b[k] - a[k], 6) for k in a}


def main(argv=None) -> int:
    from lpbench import run
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--solves", type=int, default=3)
    ap.add_argument("--member", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--threads", type=int, default=0)
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    import torch
    if args.threads:
        torch.set_num_threads(args.threads)
    cell = run.cell_of(run.load_benchmark(), args.workload)
    module = importlib.import_module(
        f"lpbench.entries.{cell['traffic']['entry']}")
    entry = module.Entry(cell["config"], cell["traffic"], args.seed,
                         args.device)
    entry.warm_up()
    head = dict(tag=args.tag, workload=args.workload, member=args.member,
                cpus=len(os.sched_getaffinity(0)),
                threads=torch.get_num_threads(),
                env={k: os.environ[k] for k in os.environ
                     if k.startswith(("OMP_", "GOMP_", "OPENBLAS_"))})
    for k in range(args.solves):
        m0, p0, t0 = machine(), process(), time.perf_counter()
        s = entry.solver(args.member)
        seconds = time.perf_counter() - t0
        m1, p1 = machine(), process()
        info = dataclasses.asdict(s.get_info())
        trace = getattr(s, "trace", None)
        line = dict(head, solve=k, seconds=round(seconds, 4),
                    process=delta(p0, p1), machine=delta(m0, m1),
                    loadavg=os.getloadavg()[0],
                    info={n: v for n, v in info.items()
                          if n.startswith("time_") or n in (
                              "iter", "kktiter1", "kktiter2", "updates_ipm",
                              "status")},
                    trace=None if trace is None else dict(
                        seconds=trace.seconds, counts=trace.counts))
        print(json.dumps(line), flush=True)
        del s
    return 0


if __name__ == "__main__":
    sys.exit(main())
