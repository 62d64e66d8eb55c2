"""Starting-basis construction at the IPM phase switch.

Counterpart of the reference starting basis (reference:
src/starting_basis.cc): build the basis-preconditioner basis from the IPM
scaling factors (fixed variables get weight 0, free variables inf), set
FIXED/IMPLIED states, and adjust the iterate for linearly dependent rows and
columns while keeping AI*x and AI'*y invariant.

The port's copy of ipx_tpu/basis/starting_basis.py.
"""
from __future__ import annotations

import numpy as np

from ..info import Info
from ..iterate import Iterate
from .basis import BASIC_FREE, NONBASIC_FIXED, Basis

INF = np.inf


def build_starting_basis(iterate: Iterate, basis: Basis, info: Info,
                         preset: np.ndarray = None) -> None:
    """reference: src/starting_basis.cc:129-182. `preset` optionally
    supplies a known-good basis (variable indices) to install instead of
    crash construction — the scenario-batch pipeline shares the mean
    scenario's basis across all finishes this way; any failure falls back
    to normal construction."""
    md = iterate.model
    m, n = md.num_rows, md.num_cols
    lb, ub = md.lb, md.ub
    info.errflag = 0

    colscale = iterate.scaling_factors()
    colscale = np.where(lb == ub, 0.0, colscale)

    loaded = False
    if preset is not None:
        loaded = basis.load_basis(preset) == 0
    if loaded:
        info.errflag = 0
        info.dependent_rows = 0
        info.dependent_cols = 0
        # a preset basis may hold fixed variables (weight 0) basic or free
        # variables nonbasic for THIS iterate's bounds; run the standard
        # pivot fixups so the preconditioner contract holds
        basis.pivot_free_variables_into_basis(colscale, info)
        if not info.errflag:
            basis.pivot_fixed_variables_out_of_basis(colscale, info)
        if info.errflag:
            loaded = False
    if not loaded:
        basis.construct_basis_from_weights(colscale, info)
    if info.errflag:
        return

    # Free (weight inf) and fixed (weight 0) variables become BASIC_FREE if
    # basic, NONBASIC_FIXED otherwise.
    special = (colscale == 0.0) | np.isinf(colscale)
    for j in np.nonzero(special)[0]:
        j = int(j)
        if basis.is_basic(j):
            basis.free_basic_variable(j)
        else:
            basis.fix_nonbasic_variable(j)

    # Fixed-bound variables that are NONBASIC_FIXED leave the IPM.
    eqbounds = lb == ub
    for j in np.nonzero(eqbounds)[0]:
        j = int(j)
        if basis.status_of(j) == NONBASIC_FIXED:
            iterate.make_fixed(j, lb[j])

    _postprocess_dependencies(iterate, basis, info)


def _postprocess_dependencies(iterate: Iterate, basis: Basis,
                              info: Info) -> None:
    """reference: src/starting_basis.cc:52-127"""
    md = iterate.model
    m, n = md.num_rows, md.num_cols
    lb, ub = md.lb, md.ub
    x, y = iterate.x, iterate.y

    dx = np.zeros(n + m)
    dy = np.zeros(m)
    dependent_cols = []
    dependent_rows = []

    # Dependent columns: free structural variables that could not enter the
    # basis are fixed at zero; basic variables absorb the change to keep AI*x.
    if info.dependent_cols > 0:
        dxbasic = np.zeros(m)
        for j in range(n):
            if np.isinf(lb[j]) and np.isinf(ub[j]) and basis.is_nonbasic(j):
                dx[j] = -x[j]
                bi, bx = md.AI_col(j)
                dxbasic[bi] += bx * x[j]
                dependent_cols.append(j)
        if dependent_cols:
            sol = basis.solve_dense(dxbasic, "N")
            dx[basis.basis] = sol

    # Dependent rows: slack of a redundant equality constraint stays basic
    # (BASIC_FREE); move its dual y[i] to zero without altering AI'y.
    if info.dependent_rows > 0:
        for p in range(m):
            j = int(basis.basis[p])
            if j >= n and lb[j] == ub[j]:
                assert basis.status_of(j) == BASIC_FREE
                dy[p] = -y[j - n]
                dependent_rows.append(j - n)
        if dependent_rows:
            dy = basis.solve_dense(dy, "T")
            for i in dependent_rows:
                dy[i] = -y[i]    # exact arithmetic would give this already

    iterate.update(1.0, dx, None, None, 1.0, dy, None, None)

    for j in dependent_cols:
        iterate.make_fixed(j, 0.0)
    for i in dependent_rows:
        iterate.make_implied_eq(n + i)
