"""MPS file reader.

Reads (fixed- or free-format) MPS linear programs into the array form
accepted by LpSolver.load_model. The reference ships no MPS reader (its
benchmark harness feeds models through the Julia binding); this module exists
so the Netlib/Mittelmann testsets can drive the solver directly.

Supported sections: NAME, ROWS, COLUMNS (with integer markers ignored), RHS,
RANGES, BOUNDS, OBJSENSE. Objective = first N row. Gzip files supported.

The port's copy of ipx_tpu/mps.py.
"""
from __future__ import annotations

import gzip
from typing import Dict, List, Optional, Tuple

import numpy as np

INF = np.inf


class MpsData:
    def __init__(self):
        self.name = ""
        self.num_var = 0
        self.num_constr = 0
        self.obj = None
        self.lb = None
        self.ub = None
        self.Ap = None
        self.Ai = None
        self.Ax = None
        self.rhs = None
        self.constr_type = ""
        self.maximize = False
        self.c0 = 0.0           # objective constant

    def load_into(self, solver) -> int:
        return solver.load_model(self.num_var, self.obj, self.lb, self.ub,
                                 self.num_constr, self.Ap, self.Ai, self.Ax,
                                 self.rhs, self.constr_type)


def read_mps(path: str) -> MpsData:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        lines = f.readlines()

    data = MpsData()
    section = None
    obj_row: Optional[str] = None
    row_type: Dict[str, str] = {}
    row_order: List[str] = []
    col_order: List[str] = []
    col_entries: Dict[str, List[Tuple[str, float]]] = {}
    obj_entries: Dict[str, float] = {}
    rhs_map: Dict[str, float] = {}
    range_map: Dict[str, float] = {}
    lb_map: Dict[str, float] = {}
    ub_map: Dict[str, float] = {}
    free_vars = set()
    mi_vars = set()

    i = 0
    while i < len(lines):
        raw = lines[i]
        i += 1
        if not raw.strip() or raw.startswith("*"):
            continue
        if not raw[0].isspace():
            parts = raw.split()
            section = parts[0].upper()
            if section == "NAME":
                data.name = parts[1] if len(parts) > 1 else ""
            elif section == "OBJSENSE" and len(parts) > 1:
                data.maximize = parts[1].upper().startswith("MAX")
            elif section == "ENDATA":
                break
            continue
        fields = raw.split()
        if section == "OBJSENSE":
            data.maximize = fields[0].upper().startswith("MAX")
        elif section == "ROWS":
            rtype = fields[0].upper()
            rname = fields[1]
            if rtype == "N":
                if obj_row is None:
                    obj_row = rname
                # extra N rows are ignored (free rows)
            else:
                row_type[rname] = {"E": "=", "L": "<", "G": ">"}[rtype]
                row_order.append(rname)
        elif section == "COLUMNS":
            if len(fields) >= 3 and fields[1].upper() == "'MARKER'":
                continue        # INTORG/INTEND markers: treat as continuous
            cname = fields[0]
            if cname not in col_entries:
                col_entries[cname] = []
                col_order.append(cname)
            for k in range(1, len(fields) - 1, 2):
                rname, val = fields[k], float(fields[k + 1])
                if rname == obj_row:
                    obj_entries[cname] = obj_entries.get(cname, 0.0) + val
                elif rname in row_type:
                    col_entries[cname].append((rname, val))
        elif section == "RHS":
            for k in range(1, len(fields) - 1, 2):
                rname, val = fields[k], float(fields[k + 1])
                if rname == obj_row:
                    data.c0 = -val
                elif rname in row_type:
                    rhs_map[rname] = val
        elif section == "RANGES":
            for k in range(1, len(fields) - 1, 2):
                rname, val = fields[k], float(fields[k + 1])
                if rname in row_type:
                    range_map[rname] = val
        elif section == "BOUNDS":
            btype = fields[0].upper()
            cname = fields[2]
            val = float(fields[3]) if len(fields) > 3 else 0.0
            if btype == "UP":
                ub_map[cname] = val
                if val < 0.0 and cname not in lb_map:
                    mi_vars.add(cname)
            elif btype == "LO":
                lb_map[cname] = val
            elif btype == "FX":
                lb_map[cname] = val
                ub_map[cname] = val
            elif btype == "FR":
                free_vars.add(cname)
            elif btype == "MI":
                mi_vars.add(cname)
            elif btype == "PL":
                ub_map.setdefault(cname, INF)
            elif btype == "BV":
                lb_map[cname] = 0.0
                ub_map[cname] = 1.0
            elif btype == "UI":
                ub_map[cname] = val
            elif btype == "LI":
                lb_map[cname] = val

    # Ranges: convert a ranged row into modified rhs/type semantics. For a
    # row with range r: E row becomes interval [rhs, rhs+|r|] (sign of r
    # picks direction); L row: [rhs-|r|, rhs]; G row: [rhs, rhs+|r|]. IPX
    # has single-sided constraints only, so ranged rows are split into the
    # base row plus bounds on the slack... Simpler: represent ranged rows as
    # two rows. (Rare in Netlib; correctness over elegance.)
    extra_rows = []
    for rname, r in range_map.items():
        t = row_type[rname]
        rhsv = rhs_map.get(rname, 0.0)
        if t == "<":
            lo = rhsv - abs(r)
            extra_rows.append((rname, ">", lo))
        elif t == ">":
            hi = rhsv + abs(r)
            extra_rows.append((rname, "<", hi))
        else:   # E
            if r >= 0:
                row_type[rname] = ">"
                extra_rows.append((rname, "<", rhsv + abs(r)))
            else:
                row_type[rname] = "<"
                extra_rows.append((rname, ">", rhsv - abs(r)))

    row_index = {rname: idx for idx, rname in enumerate(row_order)}
    m = len(row_order)
    extras = list(extra_rows)
    m_total = m + len(extras)

    n = len(col_order)
    Ap = [0]
    Ai: List[int] = []
    Ax: List[float] = []
    for cname in col_order:
        entries = {}
        for rname, val in col_entries[cname]:
            idx = row_index[rname]
            entries[idx] = entries.get(idx, 0.0) + val
        for e_ix, (rname, t, v) in enumerate(extras):
            idx = row_index[rname]
            if idx in entries:
                entries[m + e_ix] = entries[idx]
        for idx in sorted(entries):
            Ai.append(idx)
            Ax.append(entries[idx])
        Ap.append(len(Ai))

    rhs = np.zeros(m_total)
    ctype = []
    for rname in row_order:
        rhs[row_index[rname]] = rhs_map.get(rname, 0.0)
        ctype.append(row_type[rname])
    for e_ix, (rname, t, v) in enumerate(extras):
        rhs[m + e_ix] = v
        ctype.append(t)

    obj = np.array([obj_entries.get(c, 0.0) for c in col_order])
    lb = np.zeros(n)
    ub = np.full(n, INF)
    for j, cname in enumerate(col_order):
        if cname in free_vars:
            lb[j], ub[j] = -INF, INF
            continue
        if cname in mi_vars:
            lb[j] = -INF
        if cname in lb_map:
            lb[j] = lb_map[cname]
        if cname in ub_map:
            ub[j] = ub_map[cname]

    if data.maximize:
        obj = -obj

    data.num_var = n
    data.num_constr = m_total
    data.obj = obj
    data.lb = lb
    data.ub = ub
    data.Ap = np.array(Ap, dtype=np.int64)
    data.Ai = np.array(Ai, dtype=np.int64)
    data.Ax = np.array(Ax, dtype=np.float64)
    data.rhs = rhs
    data.constr_type = "".join(ctype)
    return data
