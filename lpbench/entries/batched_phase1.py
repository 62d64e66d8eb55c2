"""Requests to the batched scenario phase 1 of ipx_tpu_torch.

A request is one batch of B scenarios of the configuration's LP, differing
in their right-hand sides, run through the entry that
BatchedScenarioSolver.solve uses for its phase 1 (parallel/batch.py):

    BatchedPhase1Solver(BatchedLp(A, b, c, lb, ub), feasibility_tol,
                        optimality_tol, maxiter=..., device=...)
        .solve(handoff="auto")

timed from the constructor call to the returned numpy dict, after the
device has finished. The BatchedLp is built as BatchedScenarioSolver
builds it (yardstick.stage_lp): the slacks' bounds from the constraint
types, the costs shared by the lanes.

The right-hand sides come from a pool of `pool` batches that the traffic
fixes (drawn from its `pool_seed` by the configuration's scenario rule), so
that every seed serves the same work: --seed chooses only the order, a new
permutation of the pool for each pass over it. A window is served in whole
passes (`pass_len` requests).
"""
from __future__ import annotations

import importlib
import time

import numpy as np
import torch
from torch.profiler import record_function

from lpbench import yardstick
from lpbench.reference.judge import judge
from lpbench.reference.stage import Phase1


class Entry:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        t_import = time.perf_counter()
        from ipx_tpu_torch import kernels
        from ipx_tpu_torch.parallel import batch
        self.kernels, self.batch = kernels, batch
        self.device = device
        self.stage = dict(config["stage"])
        self.lanes = int(traffic["lanes"])
        gen = importlib.import_module(
            f"lpbench.generators.{config['generator']}")
        t0 = time.perf_counter()
        self.data = gen.make(**config["args"])
        t1 = time.perf_counter()
        sizes = self.sizes()
        want = {k: config["sizes"][k] for k in sizes if k in config["sizes"]}
        if {k: sizes[k] for k in want} != want:
            raise ValueError(f"the generator made {sizes}, the configuration "
                             f"states {config['sizes']}")
        # the pool of right-hand sides, the same for every seed
        self.pool = [gen.scenarios(self.data, B=self.lanes,
                                   seed=int(traffic["pool_seed"]), request=j,
                                   **config["scenario_rule"])
                     for j in range(int(traffic["pool"]))]
        self.pass_len = len(self.pool)
        self.seed = seed
        self.A, _, self.c, self.lb, self.ub = yardstick.stage_lp(
            self.data, self.pool[0][:1])
        self.c = np.ascontiguousarray(
            np.broadcast_to(self.c, (self.lanes, self.c.shape[1])))
        self.cuda = device == "cuda"
        # seconds of each part of the set-up, printed beside setup_s
        self.setup_phases = dict(program_import=t0 - t_import,
                                 instance=t1 - t0,
                                 pool=time.perf_counter() - t1)

    def sizes(self) -> dict:
        d = self.data
        return dict(m=int(d["num_constr"]), n=int(d["num_var"]),
                    nnz=int(len(d["Ax"])), B=self.lanes)

    def launches(self) -> dict:
        return dict(self.kernels.LAUNCHES)

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def _solver(self, b, **over):
        st = dict(self.stage, **over)
        lp = self.batch.BatchedLp(A=self.A, b=b, c=self.c, lb=self.lb,
                                  ub=self.ub)
        return self.batch.BatchedPhase1Solver(
            lp, feasibility_tol=st["feasibility_tol"],
            optimality_tol=st["optimality_tol"], maxiter=st["maxiter"],
            cr_dtype=st["cr_dtype"], device=self.device)

    def draw(self, i: int) -> int:
        """The pool batch that request i serves: pass i // pass_len takes
        the pool in an order drawn from (seed, pass)."""
        order = np.random.default_rng([self.seed, i // self.pass_len]
                                      ).permutation(self.pass_len)
        return int(order[i % self.pass_len])

    def warm_up(self) -> None:
        """One constructor and a solve of two steps on the cell's shapes."""
        t0 = time.perf_counter()
        self._solver(self.pool[0], maxiter=2).solve(
            handoff=self.stage["handoff"])
        self._sync()
        self.setup_phases["warm_up"] = time.perf_counter() - t0

    def serve(self, i: int):
        """Request i: (the stage's numpy dict, its record)."""
        return self.solve_draw(self.draw(i))

    def solve_draw(self, j: int):
        """Pool batch j through the stage: (its numpy dict, its record)."""
        b = self.pool[j]
        t0 = time.perf_counter()
        with record_function("lpbench.construct"):
            solver = self._solver(b)
            self._sync()
        t1 = time.perf_counter()
        with record_function("lpbench.solve"):
            out = solver.solve(handoff=self.stage["handoff"])
            self._sync()
        del solver
        finite = bool(np.isfinite(out["pobj"]).all()
                      and np.isfinite(out["mu"]).all())
        return out, dict(construct_s=t1 - t0, steps=int(out["iters"].max()),
                         trips=int(out["cr"]), finite=finite, draw=j)

    def reference(self, j: int, dtype=torch.float64) -> Phase1:
        """The plain reference of pool batch j, its state in `dtype`."""
        b = self.pool[j]
        st = self.stage
        mixed = st["cr_dtype"] == "f32" or (st["cr_dtype"] == "auto"
                                            and self.cuda)
        return Phase1(self.A, b, self.c, self.lb, self.ub,
                      feasibility_tol=st["feasibility_tol"],
                      optimality_tol=st["optimality_tol"],
                      maxiter=st["maxiter"], mixed=mixed, dtype=dtype,
                      device="cuda" if self.cuda else "cpu")

    def check(self, i: int, out: dict) -> dict:
        """The readings of request i's answer `out` (judge.py), with the
        steps and CR trips of both sides beside them."""
        return self.check_draw(self.draw(i), out)

    def check_draw(self, j: int, out: dict) -> dict:
        """The readings of the answer `out` to pool batch j."""
        if self.cuda:
            torch.cuda.empty_cache()
        ref = self.reference(j)
        steps = int(out["iters"].max())
        own, at = ref.run(steps)
        readings = judge(ref, out, at if at is not None else own)
        readings.update(draw=j, steps=steps,
                        ref_steps=int(own["iters"].max()),
                        trips=int(out["cr"]), ref_trips=int(own["cr"]))
        return readings
