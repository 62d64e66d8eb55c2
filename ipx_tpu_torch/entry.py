"""Entry points of the port, the counterpart of __graft_entry__.py.

entry() returns one full batched Mehrotra predictor-corrector iteration
(two batched CR solves on the normal equations, step sizes, masked
updates) over a batch of scenario LPs, with the state after the starting
point: K5-K13 on the card.

dryrun_multichip(n) runs the reference's multi-chip dry run: the batched
step at batch max(2n, 8), a row-blocked CR solve over n blocks (K14/K15),
the Parameters(shards=n) full solve of a 10k-row LP against the host path
with phase 2's column-blocked N N' engaged, and for even n the row-blocked
batched CR over n/2 blocks (K16). The reference spreads the blocks and the
batch over a jax mesh of n devices. With `mesh=` (parallel/mesh.py, n
ranks, one process each) each part runs over its ranks: the step with its
lanes split over them, the CR over n row blocks, the solve inside `with
mesh:`, the batched CR on an (n/2) x 2 rows x batch layout of them.
Without, all blocks live on the device of the batched step ("cuda": the
card; "torch_cpu": the CPU; parallel/sharding.py).

Not carried over: the persistent compile cache and the CPU pinning of the
set-up (they served jax on a TPU), and the fallback to the CPU's virtual
devices when the default platform has too few.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .parallel.batch import BatchedLp, BatchedPhase1Solver


def _make_batched_solver(m=32, n=48, batch=8, seed=0, device="cuda"):
    """The reference's scenario batch (__graft_entry__.py:36-54), from the
    same seeds, on `device`."""
    rng = np.random.default_rng(seed)
    density = 0.15
    A = sp.random(m, n, density=density,
                  random_state=np.random.RandomState(seed), format="csc")
    A = A.tocsc()
    x0 = rng.uniform(0.5, 1.5, size=n)
    b0 = A @ x0 + rng.uniform(0.1, 1.0, size=m)
    c0 = rng.standard_normal(n)
    b = b0[None, :] * rng.uniform(0.9, 1.1, size=(batch, m))
    c = np.zeros((batch, n + m))
    c[:, :n] = c0[None, :] * rng.uniform(0.9, 1.1, size=(batch, n))
    lb = np.concatenate([np.zeros(n), np.zeros(m)])
    ub = np.concatenate([np.full(n, 10.0), np.full(m, np.inf)])
    lp = BatchedLp(A=A, b=b, c=c, lb=lb, ub=ub)
    return BatchedPhase1Solver(lp, maxiter=50, device=device)


def entry(device="cuda"):
    """Returns (step, (state,)): step is one batched IPM iteration of
    BatchedPhase1Solver on `device` ("cuda": the card or raise;
    "torch_cpu": the plain versions on the CPU), state its starting point.
    step updates the arrays of the state it is given in place, as the
    reference's jitted step donates them, and returns the next state."""
    solver = _make_batched_solver(device=device)
    return solver._ipm_step, (solver._starting_point(),)


def dryrun_multichip(n_devices: int, device="cuda", mesh=None) -> None:
    """The four parts of the reference's dry run, on one device or over
    `mesh` (n_devices ranks on the card or the CPU, as `device` says), each
    with the reference's asserts; raises at the first that fails."""
    import contextlib
    from . import backend
    from .lp_solver import LpSolver
    from .parameters import Parameters
    from .parallel.sharding import (ShardedNormalMatrix,
                                    sharded_batched_cr_solve,
                                    sharded_cr_solve)
    from .testgen import load_into_solver, transportation

    rows = batch_mesh = mesh2 = None
    if mesh is not None:
        if mesh.size != n_devices:
            raise ValueError(f"a mesh of {mesh.size} ranks for "
                             f"{n_devices} devices")
        rows = mesh.reshape((n_devices,), ("rows",))
        batch_mesh = mesh.reshape((n_devices,), ("batch",))
        if n_devices % 2 == 0:
            mesh2 = mesh.reshape((n_devices // 2, 2), ("rows", "batch"))

    # -- the batched IPM step over max(2n, 8) scenarios --------------------
    batch = max(n_devices * 2, 8)
    solver = _make_batched_solver(batch=batch, device=device)
    dev = solver.device
    if mesh is not None and mesh.device.type != dev.type:
        raise ValueError(f"device {device!r} is {dev.type}, the mesh's "
                         f"ranks are on {mesh.devices}")
    state = solver._starting_point()
    shape = tuple(state["X"].shape)
    if batch_mesh is None:
        out = solver._ipm_step(state)
    else:
        out = batch_mesh.step(solver.lp, state, solver.maxiter)
    assert tuple(out["X"].shape) == shape

    # -- a row-blocked CR solve over n blocks ------------------------------
    m, n = 8 * n_devices, 12 * n_devices
    rng = np.random.default_rng(1)
    A = sp.random(m, n, density=0.3,
                  random_state=np.random.RandomState(1), format="csc") \
        + sp.diags(rng.uniform(1.0, 2.0, size=min(m, n)), shape=(m, n))
    A = A.tocsc()
    W = rng.uniform(0.5, 2.0, size=n + m)
    A2 = A.copy()
    A2.data = A2.data ** 2
    diag = np.asarray(A2 @ W[:n]).ravel() + W[n:]
    rhs = rng.standard_normal(m)
    snm = ShardedNormalMatrix(A, num_blocks=n_devices, device=dev,
                              mesh=rows)
    y, iters = sharded_cr_solve(snm, W[:n], W[n:], diag, rhs, tol=1e-8,
                                maxiter=10 * m)
    res = rhs - (A @ (W[:n] * (A.T @ y)) + W[n:] * y)
    assert np.max(np.abs(res)) <= 1e-6 * max(1.0, np.abs(rhs).max()), \
        f"sharded CR residual too large: {np.max(np.abs(res))}"

    # -- Parameters(shards=n): a full solve of one LP with m >= 10k --------
    data = transportation(4000, 6000, 0.002, seed=2)
    assert data["num_constr"] >= 10000
    s_ref = LpSolver(Parameters(display=0, device="cpu"))
    load_into_solver(data, s_ref)
    assert s_ref.solve() == 1000
    # the row blocks of phase 1 and the column blocks of phase 2 on the
    # device of the batched step
    sharded = "cuda" if dev.type == "cuda" else "torch_cpu"
    s_sh = LpSolver(Parameters(display=0, device=sharded,
                               shards=n_devices))
    load_into_solver(data, s_sh)
    with rows if rows is not None else contextlib.nullcontext():
        assert s_sh.solve() == 1000, "sharded full solve failed"
        _, _, key = backend.sharded_place(sharded, n_devices)
    rel = abs(s_sh.get_info().pobjval - s_ref.get_info().pobjval) / \
        max(1.0, abs(s_ref.get_info().pobjval))
    assert rel <= 1e-7, f"sharded objective mismatch: rel={rel}"
    assert s_sh.model._sharded_cr[0] == key
    nnt = getattr(s_sh.model, "_sharded_nnt", None)
    assert nnt is not None and nnt[0] == key and nnt[1].applies > 0, \
        "sharded phase-2 N N' never engaged in the full solve"

    # -- scenario batch x row blocks: the batched CR over n/2 blocks -------
    if n_devices % 2 == 0:
        B2 = 4
        W2 = rng.uniform(0.5, 2.0, size=(n + m, B2))
        A2w = A.copy()
        A2w.data = A2w.data ** 2
        diag2 = np.asarray(A2w @ W2[:n]) + W2[n:]
        RHS2 = rng.standard_normal((m, B2))
        snm2 = ShardedNormalMatrix(A, num_blocks=n_devices // 2, device=dev,
                                   mesh=mesh2)
        Y2, _ = sharded_batched_cr_solve(snm2, W2[:n], W2[n:], diag2, RHS2,
                                         tol=1e-8, maxiter=10 * m,
                                         mesh=mesh2)
        for k in range(B2):
            w, yk, rk = W2[:, k], Y2[:, k], RHS2[:, k]
            r2 = rk - (A @ (w[:n] * (A.T @ yk)) + w[n:] * yk)
            assert np.max(np.abs(r2)) <= 1e-6 * max(1.0, np.abs(rk).max())
