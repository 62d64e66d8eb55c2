"""The benchmark's frozen yardstick: the card's published peaks, the bytes
of the operations whose rooflines the per-layer metrics report, and the
batched LP of a set of scenarios. Nothing here imports the program; the
instance generators are in generators/."""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

INF = np.inf

# NVIDIA's H100 SXM data sheet: 3.35 TB/s of HBM3.
HBM_BYTES_PER_S = 3.35e12
SIZE = {"f32": 4, "f64": 8}
INDEX, POINTER = 4, 8           # bytes of a CSR column index and row pointer


def stage_lp(data: dict, b_batch: np.ndarray):
    """(A, b, c, lb, ub) of the batched phase 1 over the scenarios b_batch:
    A in CSC, the slack columns' bounds from the constraint types (a '<'
    row's slack in [0, inf), a '>' row's in (-inf, 0], an '=' row's fixed
    at 0), c the shared costs with zeros on the slacks."""
    m, n = data["num_constr"], data["num_var"]
    A = sp.csc_matrix((data["Ax"], data["Ai"], data["Ap"]), shape=(m, n))
    ct = np.asarray(list(data["constr_type"]))
    lb = np.concatenate([np.asarray(data["lb"], dtype=float),
                         np.where(ct == ">", -INF, 0.0)])
    ub = np.concatenate([np.asarray(data["ub"], dtype=float),
                         np.where(ct == "<", INF, 0.0)])
    B = b_batch.shape[0]
    c = np.zeros((B, n + m))
    c[:, :n] = np.asarray(data["obj"], dtype=float)[None, :]
    return A, np.ascontiguousarray(b_batch, dtype=float), c, lb, ub


# -- bytes of the operations (each input read once, each output written once) --
def lane_blocks(rows: int, lanes: int, threads: int = 256,
                most: int = 1024) -> int:
    """Row blocks of a batched pass over `rows` rows and `lanes` lanes, the
    per-lane partials it writes: the grid of the port's lane passes as the
    kernel table of PERF.md measured it."""
    tx = min(max(lanes, 1), threads)
    ty = threads // tx
    return int(min(max(-(-rows // ty), 1), most))


def csr_bytes(rows: int, nnz: int, dtype: str) -> int:
    """One CSR operand: row pointers, column indices and values."""
    return (rows + 1) * POINTER + nnz * INDEX + nnz * SIZE[dtype]


def k6_bytes(m: int, n: int, nnz: int, B: int, dtype: str) -> int:
    """One normal apply C V = A (W_s * (A' V)) + W_slack * V with its lane
    dots V.CV: A and A' (the operation reads A by rows and by columns), W
    (n + m, B) and V (m, B) read, C V (m, B) and the B dots written."""
    s = SIZE[dtype]
    return (csr_bytes(m, nnz, dtype) + csr_bytes(n, nnz, dtype)
            + ((n + m) * B + 2 * m * B + B) * s)


def k7_elem_arrays(m: int, B: int, npa: int):
    """{pass: (values read, values written)} of the batched CR's two
    elementwise passes on a trip after the first, each array once: the first
    reads S, D, CS, CD, 1/diag, resscale, R and the lanes' beta and writes D,
    CD and the (2, B, npa) partials; the second reads the B active flags,
    alpha, D, CD, Y, R, S, 1/diag and writes Y, R and S."""
    mb = m * B
    return {"kPassCA": (7 * mb + B, 2 * mb + 2 * npa * B),
            "kPassB": (6 * mb + 2 * B, 3 * mb)}


def k7_bytes(m: int, B: int, dtype: str):
    """{pass: bytes of one launch} of the batched CR's elementwise passes."""
    npa = lane_blocks(m, B)
    return {name: SIZE[dtype] * (r + w)
            for name, (r, w) in k7_elem_arrays(m, B, npa).items()}


def bound_s(nbytes: float) -> float:
    """The least time the card could move `nbytes` in."""
    return nbytes / HBM_BYTES_PER_S
