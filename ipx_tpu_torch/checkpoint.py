"""Mid-solve checkpoint / resume.

The reference has no mid-solve checkpointing: its only restart facilities are
the user-supplied IPM warm start (reference: src/lp_solver.h:60-66) and
post-hoc state extraction via the debug getters (reference:
src/lp_solver.h:122-161).  Because the complete solver state is a handful of
length-(n+m) float vectors, the per-variable state machine, and the integer
basis (the same members the reference driver owns, reference:
src/lp_solver.h:176-190), a checkpoint is a small dict of numpy arrays — so
this build adds true checkpointing as a first-class subsystem.

A checkpoint captures the *solver-model* (post-presolve) state.  Resuming
therefore requires loading the same user model with the same preprocessing
parameters (``dualize``/``scale``); a fingerprint of the presolved model
guards against mismatches.  On resume the solver skips the starting-point
procedure and phase 1 entirely: it restores the iterate and (when the
checkpoint was taken in phase 2 or later) the basis, then continues with
basis-preconditioned iterations — the same fast path the reference reserves
for user warm starts, but exact: the variable state machine and the
NONBASIC_FIXED / BASIC_FREE flags survive the round trip, so the resumed run
continues precisely where the checkpointed run stopped.

Periodic mid-solve writes are driven by two parameters with no reference
counterpart: ``checkpoint_file`` (path) and ``checkpoint_interval`` (seconds
between writes; 0 writes after every IPM iteration, negative disables).
Writes happen only at iteration boundaries, where the (iterate, basis) pair
is consistent.

The port's copy of ipx_tpu/checkpoint.py.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

CHECKPOINT_FORMAT = 1

# Arrays that are always present.
_ITERATE_KEYS = ("x", "xl", "xu", "y", "zl", "zu", "state")
# Basis arrays; present only for checkpoints taken at/after the phase switch.
_BASIS_KEYS = ("basis", "map2basis")


def model_fingerprint(model) -> np.ndarray:
    """Cheap content fingerprint of the presolved model.

    Dims plus exact float sums of the matrix/vector data: enough to reject
    resuming against a different LP or different preprocessing, at O(nnz)
    cost (once per resume).
    """
    A = model.A
    fin = lambda v: float(np.sum(np.where(np.isfinite(v), v, 0.0)))
    return np.array([
        CHECKPOINT_FORMAT,
        model.num_rows, model.num_cols, int(model.dualized),
        A.nnz if A is not None else 0,
        float(A.data.sum()) if A is not None else 0.0,
        float(np.asarray(A.indices).sum()) if A is not None else 0.0,
        fin(model.b), fin(model.c), fin(model.lb), fin(model.ub),
    ], dtype=np.float64)


def build(model, iterate, basis, niter: int) -> Dict[str, np.ndarray]:
    """Assembles a checkpoint dict from live solver state (copies)."""
    if iterate is None:
        raise ValueError("no iterate to checkpoint")
    if iterate.postprocessed:
        raise ValueError("iterate already postprocessed; checkpoint state "
                         "must be taken before postprocessing")
    ckpt = {"fingerprint": model_fingerprint(model),
            "iter": np.int64(niter)}
    for k in _ITERATE_KEYS:
        ckpt[k] = np.array(getattr(iterate, k), copy=True)
    if basis is not None:
        ckpt["basis"] = np.array(basis.basis, copy=True)
        ckpt["map2basis"] = np.array(basis.map2basis, copy=True)
    return ckpt


def validate(ckpt: Dict[str, np.ndarray], model) -> bool:
    """True iff the checkpoint matches the (presolved) model."""
    fp = ckpt.get("fingerprint")
    if fp is None:
        return False
    return np.array_equal(np.asarray(fp, dtype=np.float64),
                          model_fingerprint(model))


def has_basis(ckpt: Dict[str, np.ndarray]) -> bool:
    return all(k in ckpt for k in _BASIS_KEYS)


def save_npz(ckpt: Dict[str, np.ndarray], path: str) -> None:
    """Atomic write: a crash mid-write must not corrupt the previous good
    checkpoint (the exact event checkpointing exists to survive), so write
    to a temp file in the same directory and os.replace() it over the
    target."""
    import os
    tmp = path + ".tmp"
    try:
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **ckpt)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_npz(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as data:
        return {k: np.array(data[k]) for k in data.files}
