"""Requests to the single-LP solve of ipx_tpu_torch, to a vertex.

A request is the configuration's LP with one cost vector of the traffic's
pool, solved through the port's user API with the traffic's Parameters
(the defaults written out: device "cuda", crossover on, ipm tolerances
1e-6 and 1e-8):

    solver = LpSolver(Parameters(**parameters))
    solver.load_model(...)
    solver.solve()
    solver.get_basic_solution(), solver.get_info()

timed from the constructor call to the basic solution and the interior
objective copied to numpy. Its `info` carries the solve's IPM steps
(`steps`) and its spans' seconds and counters (solver.trace,
ipx_tpu_torch/trace.py) under the trace's own names; a program without
them leaves them out. One LP a request:
`lanes` is 1, so `scen_per_s` counts solves a second.

The costs come from a pool of `pool` vectors that the traffic fixes (c
times U(cost_factor) drawn from (pool_seed, member)), so that every seed
serves the same work: --seed chooses only the order, a new permutation of
the pool for each pass over it. A window is served in whole passes.
"""
from __future__ import annotations

import importlib
import time

import numpy as np
import torch
from torch.profiler import record_function

from lpbench.reference import lp as reference

# the statuses of an optimal solve with crossover (ipx_tpu_torch/status.py)
SOLVED, OPTIMAL = 1000, 1


def costs(c: np.ndarray, factor, seed: int, member: int) -> np.ndarray:
    """Pool member `member`'s costs: c times U(factor) drawn from (seed,
    member)."""
    rng = np.random.default_rng([seed, member])
    return c * rng.uniform(factor[0], factor[1], size=c.shape)


class Entry:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        t_import = time.perf_counter()
        import ipx_tpu_torch
        from ipx_tpu_torch import kernels
        self.ipx, self.kernels = ipx_tpu_torch, kernels
        self.device = device
        self.cuda = device == "cuda"
        self.lanes = int(traffic["lanes"])
        self.parameters = dict(traffic["parameters"], device=device)
        self.blocks = config.get("normal_blocks")
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
        self.pool = [costs(np.asarray(self.data["obj"], dtype=np.float64),
                           traffic["cost_factor"], int(traffic["pool_seed"]),
                           k) for k in range(int(traffic["pool"]))]
        self.pass_len = len(self.pool)
        self.seed = seed
        # seconds of each part of the set-up, printed beside setup_s
        self.setup_phases = dict(program_import=t0 - t_import,
                                 instance=t1 - t0,
                                 pool=time.perf_counter() - t1)

    def sizes(self) -> dict:
        d = self.data
        return dict(m=int(d["num_constr"]), n=int(d["num_var"]),
                    nnz=int(len(d["Ax"])))

    def launches(self) -> dict:
        return dict(self.kernels.LAUNCHES)

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def draw(self, i: int) -> int:
        """The pool member that request i serves: pass i // pass_len takes
        the pool in an order drawn from (seed, pass)."""
        order = np.random.default_rng([self.seed, i // self.pass_len]
                                      ).permutation(self.pass_len)
        return int(order[i % self.pass_len])

    def warm_up(self) -> None:
        """One whole solve at the cell's shapes: the native LU library and
        the kernels built and loaded, every phase run once."""
        t0 = time.perf_counter()
        _, info = self.solve_draw(0)
        if not info["finite"]:
            raise RuntimeError(f"the warm-up solve ended at {info}")
        self.setup_phases["warm_up"] = time.perf_counter() - t0

    def serve(self, i: int):
        """Request i: (its answer, its record)."""
        return self.solve_draw(self.draw(i))

    def solver(self, j: int):
        """A new LpSolver that has solved pool member j."""
        d = self.data
        s = self.ipx.LpSolver(self.ipx.Parameters(**self.parameters))
        err = s.load_model(d["num_var"], self.pool[j], d["lb"], d["ub"],
                           d["num_constr"], d["Ap"], d["Ai"], d["Ax"],
                           d["rhs"], d["constr_type"])
        if err:
            raise ValueError(f"load_model returned {err}")
        s.solve()
        return s

    def solve_draw(self, j: int):
        """Pool member j through the solver: (its answer, its record)."""
        with record_function("lpbench.solve"):
            s = self.solver(j)
            out = answer(s)
            self._sync()
        info = s.get_info()
        finite = bool(info.status == SOLVED
                      and info.status_crossover == OPTIMAL
                      and out is not None and np.isfinite(out["obj"]))
        record = dict(finite=finite, draw=j, steps=int(info.iter),
                      status=int(info.status))
        trace = getattr(s, "trace", None)
        if trace is not None:
            record.update(trace.seconds)
            record.update(trace.counts)
        del s
        return out, record

    def lp(self, j: int) -> reference.Lp:
        """Pool member j as the reference's LP, on the run's device."""
        return reference.Lp(self.data, self.pool[j],
                            "cuda" if self.cuda else "cpu")

    def reference(self, j: int) -> dict:
        """The reference IPM's solve of pool member j (obj_ref), timed."""
        if self.cuda:
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ref = reference.solve(self.lp(j), self.blocks)
        self._sync()
        ref["seconds"] = time.perf_counter() - t0
        return ref

    def judge(self, j: int, out: dict, ref: dict) -> dict:
        """The readings of the answer `out` to pool member j against the
        reference's solve `ref`: the certificate and obj_rel, judged, with
        the objectives and the reference's steps beside them."""
        readings = reference.certificate(self.lp(j), out)
        obj = readings.pop("obj")
        readings["obj_rel"] = abs(obj - ref["obj"]) / max(1.0,
                                                          abs(ref["obj"]))
        readings.update(
            draw=j, obj=obj, obj_ref=ref["obj"], ref_iters=ref["iters"],
            ref_breakdowns=ref["breakdowns"], ref_s=ref["seconds"],
            ipm_obj_rel=abs(out["ipm_obj"] - ref["obj"])
            / max(1.0, abs(ref["obj"])))
        return readings

    def check(self, i: int, out: dict) -> dict:
        """The readings of request i's answer `out` (reference/lp.py)."""
        return self.check_draw(self.draw(i), out)

    def check_draw(self, j: int, out: dict) -> dict:
        return self.judge(j, out, self.reference(j))


def answer(solver):
    """The basic solution and the interior objective of a solved LpSolver,
    as numpy arrays and numbers; None without a basic solution."""
    sol = solver.get_basic_solution()
    if sol is None:
        return None
    info = solver.get_info()
    out = {k: np.array(getattr(sol, k)) for k in ("x", "slack", "y", "z",
                                                  "vbasis", "cbasis")}
    out.update(obj=float(info.objval), ipm_obj=float(info.pobjval))
    return out
