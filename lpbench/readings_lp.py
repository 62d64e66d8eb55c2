"""The readings that the limits of the entry `lp_solve` are set from
(PERF.md), on the card.

    python3 lpbench/readings_lp.py --workload <name> [--device cuda]

At the cell's own size, each cost vector of the traffic's pool is solved
once through the program (entries/lp_solve.py) and its answer judged as a
run judges it: the vertex certificate and obj_rel against the reference's
IPM (reference/lp.py). Then, on each member, the control: the program's
answer rounded to float32; and the five faults: one basic x moved by
1e-6 (1 + |x|), the basic x nearest a finite bound moved past it by
1e-6 (1 + |bound|), one nonbasic variable moved from its lower bound to
its upper bound (its status with it), the interior solution in place of
the basic one, and another member's answer (other costs). One JSON line a
reading. The benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

NONBASIC_LB, NONBASIC_UB = -1, -2


def control(out: dict) -> dict:
    """The answer one precision below the configuration's: x, slack, y and
    z rounded to float32."""
    import numpy as np
    return dict(out, **{k: out[k].astype(np.float32).astype(np.float64)
                        for k in ("x", "slack", "y", "z")})


def interior(solver, out: dict) -> dict:
    """The solver's interior solution in place of its basic one (x, slack,
    y, z = zl - zu), with the basic solution's statuses."""
    sol = solver.get_interior_solution()
    return dict(out, x=sol.x.copy(), slack=sol.slack.copy(), y=sol.y.copy(),
                z=sol.zl - sol.zu)


def faults(out: dict, lb, ub, interior_out: dict, other: dict) -> dict:
    """{fault: the answer it gives} from a sound answer `out` of an LP with
    bounds `lb` and `ub`, its interior solution and another member's
    answer."""
    import numpy as np
    x = out["x"]
    basic = np.nonzero(out["vbasis"] == 0)[0]
    moved = dict(out, x=x.copy())
    i = basic[int(np.argmax(np.abs(x[basic])))]
    moved["x"][i] += 1e-6 * (1.0 + abs(x[i]))
    past = dict(out, x=x.copy())
    to_lb = np.where(np.isfinite(lb[basic]), x[basic] - lb[basic], np.inf)
    to_ub = np.where(np.isfinite(ub[basic]), ub[basic] - x[basic], np.inf)
    k = int(np.argmin(np.minimum(to_lb, to_ub)))
    i = basic[k]
    if to_lb[k] <= to_ub[k]:
        past["x"][i] = lb[i] - 1e-6 * (1.0 + abs(lb[i]))
    else:
        past["x"][i] = ub[i] + 1e-6 * (1.0 + abs(ub[i]))
    flipped = dict(out, x=x.copy(), vbasis=out["vbasis"].copy())
    j = np.nonzero((out["vbasis"] == NONBASIC_LB) & np.isfinite(ub))[0][0]
    flipped["x"][j] = ub[j]
    flipped["vbasis"][j] = NONBASIC_UB
    return dict(basic_moved=moved, basic_past_bound=past,
                nonbasic_flipped=flipped, interior=interior_out,
                other_member=other)


def main(argv=None) -> int:
    import numpy as np
    import torch
    from lpbench import run
    from lpbench.entries.lp_solve import answer
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = run.cell_of(run.load_benchmark(), args.workload)
    module = importlib.import_module(
        f"lpbench.entries.{cell['traffic']['entry']}")
    card = (torch.cuda.get_device_name(0) if args.device == "cuda"
            else "cpu")
    entry = module.Entry(cell["config"], cell["traffic"], args.seed,
                         args.device)
    entry.warm_up()

    def emit(kind, j, readings):
        print(json.dumps(dict(workload=args.workload, kind=kind, card=card,
                              **dict(readings, draw=j))), flush=True)

    answers = []
    for j in range(entry.pass_len):
        s = entry.solver(j)
        out = answer(s)
        answers.append((out, interior(s, out)))
        del s
    lb = np.asarray(entry.data["lb"], dtype=np.float64)
    ub = np.asarray(entry.data["ub"], dtype=np.float64)
    for j, (out, inner) in enumerate(answers):
        ref = entry.reference(j)
        emit("program", j, entry.judge(j, out, ref))
        emit("control", j, entry.judge(j, control(out), ref))
        other = answers[(j + 1) % len(answers)][0]
        for name, got in faults(out, lb, ub, inner, other).items():
            emit(f"fault.{name}", j, entry.judge(j, got, ref))
    return 0


if __name__ == "__main__":
    sys.exit(main())
