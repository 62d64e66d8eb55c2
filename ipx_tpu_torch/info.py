"""Solve statistics and status report.

Field-parity with the reference info struct (reference: include/ipx_info.h:6-103
and src/info.cc:20-115). All fields initialize to zero; the solver fills them
during/after a solve. The struct is the machine-readable metrics contract:
benchmark tooling parses these field names from the debug dump.

The port's copy of ipx_tpu/info.py.
"""
from __future__ import annotations

import dataclasses

from .status import Status, SolveStatus, Errflag


@dataclasses.dataclass
class Info:
    status: int = int(Status.NOT_RUN)
    status_ipm: int = int(SolveStatus.NOT_RUN)
    status_crossover: int = int(SolveStatus.NOT_RUN)
    errflag: int = int(Errflag.OK)

    # dimension of LP model as given by user
    num_var: int = 0
    num_constr: int = 0
    num_entries: int = 0

    # dimension of constraint matrix in solver (including slack columns)
    num_rows_solver: int = 0
    num_cols_solver: int = 0
    num_entries_solver: int = 0

    dualized: int = 0           # dualized model?
    dense_cols: int = 0         # columns classified "dense"

    # reductions in IPM
    dependent_rows: int = 0
    dependent_cols: int = 0
    rows_inconsistent: int = 0
    cols_inconsistent: int = 0
    primal_dropped: int = 0
    dual_dropped: int = 0

    # interior solution
    abs_presidual: float = 0.0
    abs_dresidual: float = 0.0
    rel_presidual: float = 0.0
    rel_dresidual: float = 0.0
    pobjval: float = 0.0
    dobjval: float = 0.0
    rel_objgap: float = 0.0
    complementarity: float = 0.0
    normx: float = 0.0
    normy: float = 0.0
    normz: float = 0.0

    # basic solution
    objval: float = 0.0
    primal_infeas: float = 0.0
    dual_infeas: float = 0.0

    # operation counts
    iter: int = 0
    kktiter1: int = 0
    kktiter2: int = 0
    basis_repairs: int = 0
    updates_start: int = 0
    updates_ipm: int = 0
    updates_crossover: int = 0
    # crossover push volume (printed but not stored by the reference;
    # stored here for the logfile-parity anchors, tools/ref_parity.py)
    pushes_dual: int = 0
    pushes_primal: int = 0

    # major computation times
    time_total: float = 0.0
    time_ipm1: float = 0.0
    time_ipm2: float = 0.0
    time_starting_basis: float = 0.0
    time_crossover: float = 0.0

    # profiling linear solver
    time_kkt_factorize: float = 0.0
    time_kkt_solve: float = 0.0
    time_maxvol: float = 0.0
    time_cr1: float = 0.0
    # the normal matrix applies' part of time_cr1, measured on the host
    # paths; not measured on the device CR (ops/device_cr.py), whose
    # applies run inside K3's launch, where it stays 0.0
    time_cr1_AAt: float = 0.0
    time_cr1_pre: float = 0.0
    time_cr2: float = 0.0
    time_cr2_NNt: float = 0.0
    time_cr2_B: float = 0.0
    time_cr2_Bt: float = 0.0

    # profiling basis factorization
    ftran_sparse: float = 0.0
    btran_sparse: float = 0.0
    time_ftran: float = 0.0
    time_btran: float = 0.0
    time_lu_invert: float = 0.0
    time_lu_update: float = 0.0
    mean_fill: float = 0.0
    max_fill: float = 0.0
    time_symb_invert: float = 0.0

    # analysis of algorithm maxvolume
    maxvol_updates: int = 0
    maxvol_skipped: int = 0
    maxvol_passes: int = 0
    tbl_nnz: int = 0
    tbl_max: float = 0.0
    frobnorm_squared: float = 0.0
    lambdamax: float = 0.0
    volume_increase: float = 0.0

    def reset(self) -> None:
        defaults = Info()
        for field in dataclasses.fields(self):
            setattr(self, field.name, getattr(defaults, field.name))

    def dump(self) -> str:
        """Full field dump, one 'name value' per line (reference:
        src/info.cc:20-115; printed by the solver at debug>=2)."""
        lines = []
        for field in dataclasses.fields(self):
            val = getattr(self, field.name)
            if isinstance(val, float):
                lines.append(f"{field.name} = {val:.17g}")
            else:
                lines.append(f"{field.name} = {val}")
        return "\n".join(lines) + "\n"

    __str__ = dump
