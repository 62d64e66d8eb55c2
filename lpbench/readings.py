"""The readings that the check's limits are set from (PERF.md), on the card.

    python3 lpbench/readings.py --workload <name> [--repeats 2] \
        [--control 3] [--faults 3] [--device cuda]

At the cell's own size, each batch of the traffic's pool (every seed's
window serves the same pool, in another order) is served --repeats times
through the program and its answer judged as a run judges it
(entries/<entry>.py check). Then, on the first --control batches, the
control: the reference computed one precision below the configuration's
(its state and defect correction in float32) put in the program's place.
On the first --faults batches, the faults that the cell can have: planted
in the reference put in the program's place, a step that returns its state
unchanged (the starting point comes back), half the lanes left out (each
replaced by the mean of the kept half) and one value of the answer altered
where it is produced; planted in the program, K9 writing the primal part
alone (alpha_d = 0: Y, ZL and ZU keep their starting values). One JSON line
a reading. The benchmark's own runs do not run this.
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


def faults(state: dict, start: dict) -> dict:
    """{fault: the answer it gives} from a sound answer `state` and the
    starting point `start`, numpy arrays (dim, B) and (B,)."""
    import numpy as np
    keys = ("X", "XL", "XU", "Y", "ZL", "ZU")
    B = state["X"].shape[1]
    half = {k: v.copy() for k, v in state.items()}
    for k in keys:
        half[k][:, B // 2:] = state[k][:, :B // 2].mean(axis=1,
                                                        keepdims=True)
    altered = {k: v.copy() for k, v in state.items()}
    i = int(np.argmax(np.abs(altered["X"][:, 0])))
    altered["X"][i, 0] *= 1.0 + 1e-6
    unchanged = dict(start, iters=state["iters"], done=state["done"],
                     cr=state["cr"])
    return dict(unchanged=unchanged, half=half, altered=altered)


def frozen_dual(update):
    """K9 `update` (the stage's ipm_update) that writes the primal part
    alone: alpha_d = 0, so Y, ZL and ZU keep their starting values."""
    import torch

    def frozen(*args):
        args = list(args)
        args[13] = torch.zeros_like(args[13])      # alphad
        update(*args)
    return frozen


def main(argv=None) -> int:
    import numpy as np
    import torch
    from lpbench import run
    from lpbench.reference.judge import judge
    from lpbench.reference.stage import host
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
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

    def free():
        if args.device == "cuda":
            torch.cuda.empty_cache()

    for r in range(args.repeats):
        for j in range(entry.pass_len):
            out, info = entry.solve_draw(j)
            emit("program", j, dict(entry.check_draw(j, out),
                                    construct_s=info["construct_s"]))
            del out
            free()
    batch = entry.batch
    sound_update = batch.BatchedPhase1Solver.ipm_update
    for j in range(max(args.control, args.faults)):
        ref = entry.reference(j)
        ctl = (entry.reference(j, dtype=torch.float32).run()[0]
               if j < args.control else None)
        own, at = ref.run(None if ctl is None
                          else int(np.max(ctl["iters"])))
        if ctl is not None:
            emit("control", j, judge(ref, ctl, at))
        del ctl
        free()
        if j < args.faults:
            start = host(ref.start())
            for name, got in faults(own, start).items():
                emit(f"fault.{name}", j, judge(ref, got, own))
            del own, at, ref
            free()
            batch.BatchedPhase1Solver.ipm_update = staticmethod(
                frozen_dual(sound_update))
            try:
                out, _ = entry.solve_draw(j)
            finally:
                batch.BatchedPhase1Solver.ipm_update = staticmethod(
                    sound_update)
            emit("fault.frozen_dual", j, entry.check_draw(j, out))
            del out
            free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
