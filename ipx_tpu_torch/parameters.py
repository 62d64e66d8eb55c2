"""Solver parameters.

Field names, defaults and semantics are API-parity with the reference
parameter struct (reference: include/ipx_parameters.h:6-85, documented in
doc/reference.tex:368-546). Extra device knobs are grouped at the end
and default to safe values; they have no counterpart in the reference.

The port's copy of ipx_tpu/parameters.py, with the port's `device` values
and the port's meaning of `shards`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Parameters:
    # --- Solver control ---
    display: int = 1                # print progress to stdout
    logfile: Optional[str] = None   # append log output to file
    print_interval: float = 5.0     # seconds between rate-limited progress lines
    time_limit: float = -1.0        # wallclock seconds; negative = none

    # --- Preprocessing ---
    dualize: int = -1               # -1 automatic, 0 never, 1 always
    scale: int = 1                  # rounds of equilibration scaling (0 = off)

    # --- Interior point method ---
    ipm_maxiter: int = 300
    ipm_feasibility_tol: float = 1e-6
    ipm_optimality_tol: float = 1e-8
    ipm_drop_primal: float = 1e-9
    ipm_drop_dual: float = 1e-9

    # --- Linear solver ---
    kkt_tol: float = 0.3
    precond_dense_cols: int = 1     # split dense columns out of the diag precond

    # --- Basis construction in IPM ---
    crash_basis: int = 1
    dependency_tol: float = 1e-6
    volume_tol: float = 2.0
    rows_per_slice: int = 10000
    maxskip_updates: int = 10

    # --- LU factorization ---
    lu_kernel: int = 0              # <=0 native kernel, 1 generic Forrest-Tomlin
    lu_pivottol: float = 0.0625

    # --- Crossover ---
    crossover: int = 1
    crossover_start: float = 1e-8
    pfeasibility_tol: float = 1e-7
    dfeasibility_tol: float = 1e-7

    # --- Debugging ---
    debug: int = 0
    switchiter: int = -1            # -1 automatic switch to basis precond
    stop_at_switch: int = 0
    update_heuristic: int = 1
    maxpasses: int = -1

    # --- Device-specific (no counterpart in the reference) ---
    # Where the KKT solves run (backend.py):
    #   "cuda"      (the default) phase 1 and phase 2 on the card through
    #               the hand-written kernels; LpSolver.solve raises if there
    #               is no card or the kernels fail
    #   "torch_cpu" the same device path on the CPU, with the kernels'
    #               plain PyTorch versions (for tests)
    #   "cpu"       the reference's host path
    #   "auto"      "cuda" when a card is present and nnz(A) >= 20 000,
    #               otherwise "cpu"
    device: str = "cuda"
    precision: str = "mixed"        # KKT-solve arithmetic: "mixed" runs the
                                    # CR inner loop in f32 with f64 defect
                                    # correction (same termination contract,
                                    # f64 finish when f32 stalls); "f64"
                                    # forces full double precision
    kkt_precond: str = "auto"       # phase-1 CR preconditioner: "auto"/
                                    # "diag" = diagonal (+ dense-column
                                    # SMW, reference behavior); "ic" forces
                                    # IC(0) on the explicit normal matrix
                                    # (shift ladder, falls back to diag on
                                    # breakdown) — rarely faster, opt-in
    shards: int = 0                 # >1: partition A's rows into this many
                                    # blocks and run the phase-1 CR on them,
                                    # every dot the ordered sum of the block
                                    # partials (parallel/sharding.py); phase
                                    # 2 then applies N N' over as many column
                                    # blocks unless the device splitted CR
                                    # runs. The blocks live on one device:
                                    # the card for "cuda" (or it raises),
                                    # the CPU for "torch_cpu", and for
                                    # "auto" and "cpu" the card when one is
                                    # present, else the CPU

    # --- Checkpoint/resume (no counterpart in the reference) ---
    checkpoint_file: Optional[str] = None  # write .npz checkpoints here
    checkpoint_interval: float = 60.0      # seconds between mid-solve writes;
                                           # 0 = every IPM iteration, <0 = only
                                           # the final (pre-postsolve) write

    def copy(self) -> "Parameters":
        return dataclasses.replace(self)

    # ------------------------------------------------------------------
    # Key-value parameter files (reference: src/control.cc:195-267).
    # Format: one "name value" pair per line; '#' starts a comment.
    # ------------------------------------------------------------------
    def write(self, filename: str) -> None:
        with open(filename, "w") as f:
            for field in dataclasses.fields(self):
                val = getattr(self, field.name)
                if val is None:
                    continue
                f.write(f"{field.name} {val}\n")

    @classmethod
    def read(cls, filename: str) -> "Parameters":
        params = cls()
        params.update_from_file(filename)
        return params

    def update_from_file(self, filename: str) -> None:
        fields = {f.name: f for f in dataclasses.fields(self)}
        with open(filename) as f:
            for line in f:
                line = line.split("#", 1)[0].strip()
                if not line:
                    continue
                parts = line.split(None, 1)
                if len(parts) != 2:
                    raise ValueError(f"malformed parameter line: {line!r}")
                name, raw = parts
                if name not in fields:
                    raise KeyError(f"unknown parameter: {name!r}")
                ftype = fields[name].type
                if ftype in ("int", int):
                    value = int(float(raw))
                elif ftype in ("float", float):
                    value = float(raw)
                else:
                    value = None if raw == "None" else raw
                setattr(self, name, value)
